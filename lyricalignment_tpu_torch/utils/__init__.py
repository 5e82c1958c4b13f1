"""Evaluation metrics."""

from lyricalignment_tpu_torch.utils.metrics import cer, mae, per

__all__ = ["cer", "per", "mae"]
