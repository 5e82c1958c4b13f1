"""lyricalignment_tpu_torch — the PyTorch/CUDA port of ``lyricalignment_tpu``
for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it is the reference: every module here has the name
of its JAX counterpart and is tested against it on the CPU
(``tests/test_torch_*.py``). This package imports ``torch``, numpy and
scipy, never ``jax`` and nothing of ``lyricalignment_tpu``.

Layering:
    csrc/      — hand-written CUDA C++ kernels (log-mel, encoder attention
                 forward and backward, streaming class log-sum-exp and its
                 backward, Viterbi DP, and the reduced CTC pair: a forward
                 with one state a lane in registers over ceil(S / 32)
                 warps, a barrier a frame and its emissions staged ahead
                 by cp.async; a backward whose _lse3 weights a grid-wide
                 pass computes first, leaving a linear adjoint recurrence
                 over two states a lane)
    kernels/   — nvcc build of ``csrc/`` into one shared library, ctypes
                 binding, launch counters
    ops/       — plain-tensor functions; each kernel's wrapper sits beside
                 its plain PyTorch version
    models/    — Whisper encoder, teacher-forced decoder and KV-cached
                 decoding (the split cache), bi-GRU align head, AlignModel,
                 weight conversion from the JAX layout
    decode/    — greedy, beam and sampled decoding loops, whisper's
                 timestamp rules, the temperature-fallback ladder and the
                 long-form seek loop
    train/     — multitask losses, the AdamW chain, trainer, checkpoints
    parallel/  — scale-out on ``torch.distributed``: the ("data", "model")
                 mesh with data, tensor and sequence parallelism (mesh),
                 GPipe pipeline stages over the model axis (pipeline)
    data/, text/, utils/ — host-side records, WAV IO, frame labels, the
                 training pipeline, the BERT and whisper (BPE) tokenizers,
                 pinyin table and phonemizer, eval normalisers, MAE, CER, PER
    prep/      — offline data preparation, host only: the pronunciation
                 table, MUSDB mixing, dataset paths, vocal separation
    cli/, api.py — alignment, transcription, training, transcript
                 evaluation, checkpoint conversion, post-processing and the
                 JSONL service (``device="cuda"`` by default)
"""

__version__ = "0.1.0"

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000 samples in a 30 s window
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames in a 30 s window
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100 mel frames / s
EMBED_FRAMES = N_FRAMES // 2  # 1500 encoder frames (20 ms hop)
HOP_SIZE_SECOND = 0.02  # encoder frame hop in seconds
