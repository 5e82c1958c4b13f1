"""Offline prep: music source separation (vocal extraction).

The port's own copy of ``lyricalignment_tpu/prep/separate_vocals.py`` (the
reference's ``dataset_preprocessing/demucs_dataset.py:14-47`` and
``spleeter_dataset.py:13-41``): extract the vocal stem of every file in a
directory, as a mono 44.1 kHz WAV. The separators are optional packages
(demucs on PyTorch, spleeter on TensorFlow), imported only when their
backend runs; without one the CLI exits with a message. HT-Demucs runs on
``--device`` (``cuda`` by default, as every entry point of the port; no
CUDA is an error, not a quiet CPU run; ``--device cpu`` asks for the CPU).

Usage:
    python -m lyricalignment_tpu_torch.prep.separate_vocals demucs <in_dir> <out_dir> \\
        [--device cpu]
    python -m lyricalignment_tpu_torch.prep.separate_vocals spleeter <in_dir> <out_dir>
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np

from lyricalignment_tpu_torch.data.audio_io import read_wav, resample, write_wav


def _load_mono_44k(path: str) -> np.ndarray:
    data, sr = read_wav(path)
    mono = data.mean(axis=0) if data.shape[0] > 1 else data[0]
    return resample(mono, sr, 44100) if sr != 44100 else mono


def separate_demucs(in_dir: str, out_dir: str, device: str = "cuda") -> None:
    """HT-Demucs on ``device``; the device is checked before demucs is
    imported."""
    import torch

    from lyricalignment_tpu_torch.cli.common import resolve_device

    dev = resolve_device(device)
    try:
        from demucs import apply, pretrained
    except ImportError as e:
        raise SystemExit(f"demucs not available in this environment: {e}")

    # HT-Demucs is non-deterministic (reference `demucs_dataset.py:25`);
    # seed everything anyway
    random.seed(114514)
    np.random.seed(114514)
    torch.manual_seed(114514)

    model = pretrained.get_model(name="htdemucs").to(dev)
    model.eval()

    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(in_dir)):
        y = _load_mono_44k(os.path.join(in_dir, name))
        mix = torch.tensor(np.stack([y, y])).float().to(dev)
        sources = apply.apply_model(model, mix[None], split=True, overlap=0.5,
                                    progress=False)[0]
        vocal = sources[model.sources.index("vocals")].detach().cpu().numpy().T
        mono = (vocal[:, 0] + vocal[:, 1]) / 2
        write_wav(os.path.join(out_dir, name), mono.astype(np.float32), 44100)


def separate_spleeter(in_dir: str, out_dir: str) -> None:
    try:
        from spleeter.separator import Separator
    except ImportError as e:
        raise SystemExit(f"spleeter not available in this environment: {e}")

    separator = Separator("spleeter:2stems")
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(in_dir)):
        y = _load_mono_44k(os.path.join(in_dir, name))
        stereo = np.stack([y, y], axis=1)
        vocal = separator.separate(stereo)["vocals"]
        mono = (vocal[:, 0] + vocal[:, 1]) / 2
        write_wav(os.path.join(out_dir, name), mono.astype(np.float32), 44100)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit(__doc__)
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != 3 or argv[0] not in ("demucs", "spleeter"):
        raise SystemExit(__doc__)
    backend, in_dir, out_dir = argv
    if backend == "demucs":
        separate_demucs(in_dir, out_dir, device)
    else:
        separate_spleeter(in_dir, out_dir)


if __name__ == "__main__":
    main()
