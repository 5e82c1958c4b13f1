"""Frame-label rasterization: char on/offset times -> 20 ms frame labels.

Behavioral parity with the reference's ``AlignDataset._get_frame_label``
(`dataset.py:129-145`): the label raster spans up to the last char's offset
(rounded to frames, +1), each char paints [round(on/hop), round(off/hop)+1)
with its token id, later chars overwrite earlier ones on overlap, and the
fill value is -100 when training with CTC (silence handled by a separate
sigmoid channel) or 0 in plain-CE mode (silence = class 0).

This vectorised version replaces the reference's per-char Python slice loop
with a numpy interval raster. The port's own copy of
``lyricalignment_tpu/data/frames.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from lyricalignment_tpu_torch import HOP_SIZE_SECOND

IGNORE_ID = -100


def rasterize_frame_labels(
    lyric_tokens: np.ndarray,
    onset_offset: Sequence[Sequence[float]],
    use_ctc: bool = False,
    hop_size_second: float = HOP_SIZE_SECOND,
    total_frames: Optional[int] = None,
) -> np.ndarray:
    """Rasterize per-char [onset, offset] seconds into per-frame token labels.

    Args:
      lyric_tokens: int array, one token id per char (aligned with onset_offset).
      onset_offset: [[on_s, off_s], ...] per char.
      use_ctc: fill silence with -100 (CTC mode) instead of 0 (CE mode).
      total_frames: optional fixed raster length (pad with fill; events beyond
        it are clipped). Default: reference behavior —
        round(last_offset / hop) + 1.

    Returns int32[total_frames].
    """
    lyric_tokens = np.asarray(lyric_tokens)
    fill_value = IGNORE_ID if use_ctc else 0

    if len(onset_offset) == 0:
        # the reference crashes on offsets[-1] here (`dataset.py:132`); make
        # the precondition explicit instead
        raise ValueError(
            "rasterize_frame_labels needs at least one [onset, offset] pair "
            "(sample has alignment ground truth but an empty on_offset list)")
    onsets = np.array([p[0] for p in onset_offset], dtype=np.float64)
    offsets = np.array([p[1] for p in onset_offset], dtype=np.float64)

    default_frames = int(round(offsets[-1] / hop_size_second)) + 1
    n = default_frames if total_frames is None else total_frames

    labels = np.full((n,), fill_value, dtype=np.int32)

    # np.round matches Python round() half-to-even used by the reference
    on_f = np.round(onsets / hop_size_second).astype(np.int64)
    off_f = np.round(offsets / hop_size_second).astype(np.int64) + 1
    on_f = np.clip(on_f, 0, n)
    off_f = np.clip(off_f, 0, n)

    # Later chars overwrite earlier ones where intervals overlap, exactly as
    # the reference's sequential slice assignment does.
    for k in range(len(on_f)):
        labels[on_f[k]: off_f[k]] = lyric_tokens[k]
    return labels
