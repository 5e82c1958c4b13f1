"""Audio front end: the log-mel spectrogram (its kernel is ``csrc/mel.cu``),
the mel filterbank and ``pad_or_trim`` under the JAX package's names."""

from lyricalignment_tpu_torch.ops.mel import log_mel_spectrogram, mel_filterbank, pad_or_trim

__all__ = ["log_mel_spectrogram", "mel_filterbank", "pad_or_trim"]
