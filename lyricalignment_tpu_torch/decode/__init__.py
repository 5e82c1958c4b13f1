"""KV-cached transcription: greedy, beam and sampled decoding with
whisper's timestamp rules, the fallback ladder and long-form seek."""

from lyricalignment_tpu_torch.decode.beam import beam_search, greedy_decode

__all__ = ["beam_search", "greedy_decode"]
