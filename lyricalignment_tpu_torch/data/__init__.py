"""Host-side records, audio IO and frame labels."""

from lyricalignment_tpu_torch.data.audio_io import load_audio_file
from lyricalignment_tpu_torch.data.frames import rasterize_frame_labels
from lyricalignment_tpu_torch.data.records import Record, read_data

__all__ = ["Record", "read_data", "load_audio_file", "rasterize_frame_labels"]
