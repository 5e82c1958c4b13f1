#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lyricalignment_tpu_torch``) on one
NVIDIA GPU (written for the H100, sm_90a):

    python3 chip_smoke.py

1. builds the CUDA kernels from ``lyricalignment_tpu_torch/csrc`` with
   nvcc (printing the build time and ptxas' register/shared-memory report);
2. holds each serving kernel against its plain PyTorch version at the
   shapes of the alignment main path (whisper-medium, 16 clips of 30 s, 48 labels, CTC
   head of 21129 classes), and times kernel, plain version and, where one
   PyTorch call computes the same function, that call;
3. serves ``LyricAligner.align_many`` on a whisper-medium AlignModel
   (random weights from a seeded generator, bf16, tanh GELU) for 8 WAV
   requests of 8-45 s, with every kernel's launch counter reset just before
   and read just after; every kernel must have launched, and every segment
   must be finite and ordered;
4. runs a tiny float32 model through the same path on the GPU and on the
   CPU (plain versions), compares hidden states and segments, and checks
   that every kernel (attention on its float32 path) launched on the GPU;
5. times the device-only forward at the bench's operating point (B = 16,
   30 s, L = 48, CTC, medium, bf16) through the serving path's own calls
   (``forward_from_audio`` then ``viterbi_align_fused``) in audio-seconds
   per second, with CUDA-event times of both for each timed batch and the
   launch counts of the timed batches (each kernel once a batch, attention
   once a layer); then traces one more batch with torch.profiler for the
   device time by kernel and the device's idle share, when the profiler
   records device activity.

6. phase "train", the multitask training path:
   (a) holds the training attention kernels (forward with the row
       log-sum-exp, dK/dV, dQ) against autograd through the plain einsum at
       edge shapes (T = 1, 63, 65, 1500; with and without a key bias;
       float32 and bf16) and at the training shape (B = 2, H = 16, T = 1500,
       bf16), and times each beside its plain version and
       ``scaled_dot_product_attention`` forward and backward;
   (b) runs one ``make_train_step`` of a tiny float32 model on the GPU and
       on the CPU (plain versions) and compares losses (rtol 1e-4) and
       updates (at most 1 in 1000 entries off by more than 2e-2 lr);
   (c) trains whisper-medium at the JAX ``bench_train`` operating point
       (bf16, tanh GELU, 8 micro-batches of 2 x 30 s, CTC head of 21129
       classes, align CE + CTC + transcript CE, bf16 gradient accumulation
       and Adam mu; random weights from a seed): one warm-up step, then 3
       timed steps with launch counts reset just before and checked just
       after (mel 8, attention forward 192, dK/dV 192, dQ 192 a step), step
       ms, trained audio-s/s, peak memory and one traced step;
   (d) runs ``python -m lyricalignment_tpu_torch.cli.train_multitask`` for 2
       steps of whisper-tiny on synthetic WAVs, loads the written
       ``best_model`` with ``cli.common.load_model_dir`` and aligns with
       ``LyricAligner.align_many``.

It prints one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero (and prints no result) without CUDA or without the repository
around it, and on any failed check.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, float32 on the
# CUDA cores, bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

B, SECONDS, L_BENCH, C_CTC = 16, 30, 48, 21129
# launchers of the alignment serving path (the training path adds
# la_attention_fwd, la_attention_dkdv and la_attention_dq)
SERVING_KERNELS = ("la_log10_mel", "la_bias_attention", "la_row_lse", "la_viterbi")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, peak_ops: float, nbytes: float):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version at main-path shapes
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from lyricalignment_tpu_torch import HOP_LENGTH, N_FFT
    from lyricalignment_tpu_torch.ops import attention, mel, viterbi

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def report(name, src, replaces, err, tol_text, ok, ms, plain_ms, library_ms,
               bound_ms, bound_by):
        log(f"[kernel] {name}: max_abs_err={err:.3e} ({tol_text}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if library_ms is None else f'{library_ms:.4f}'} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by))

    # --- kernel 1: log10 mel of 16 x 30 s
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    padded = mel.reflect_pad(audio).contiguous()
    n_frames, n_mels = audio.shape[1] // HOP_LENGTH, 80
    got = mel.log10_mel(padded, n_frames, n_mels)
    ref = mel.log10_mel_plain(padded, n_frames, n_mels)
    err = (got - ref).abs().max().item()
    window = torch.hann_window(N_FFT, periodic=True, device=dev)
    fb = torch.from_numpy(mel.mel_filterbank(n_mels=n_mels)).to(dev)

    def stft_mel():
        spec = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, center=True,
                          pad_mode="reflect", return_complex=True)[..., :-1]
        return torch.log10(torch.clamp(fb @ spec.abs() ** 2, min=1e-10))

    # the least work for this function, not the kernel's dense DFT: a real
    # FFT of 5/2 N log2 N a frame, the power (3 a bin) and the filterbank's
    # nonzero weights; bytes of the padded audio in and the log-mel out
    nnz = int((fb != 0).sum())
    ops = B * n_frames * (2.5 * N_FFT * math.log2(N_FFT) + 3 * 201 + 2 * nnz)
    nbytes = 4 * (padded.numel() + nnz + got.numel())
    report("log10_mel", "lyricalignment_tpu_torch/csrc/mel.cu",
           "lyricalignment_tpu/ops/mel_pallas.py:43", err, "atol 1e-4",
           err <= 1e-4,
           time_ms(lambda: mel.log10_mel(padded, n_frames, n_mels)),
           time_ms(lambda: mel.log10_mel_plain(padded, n_frames, n_mels)),
           time_ms(stft_mel), *bound(ops, PEAK_F32, nbytes))
    del audio, padded, got, ref

    # --- kernel 2: encoder attention, B x H = 16 x 16, T = 1500, d_h = 64
    T, H, D = 1500, 16, 64
    bias = torch.zeros(1, T, device=dev)
    bias[0, -7:] = -1e9  # masked keys as the pad-once path has them
    bias[0, :-7] += torch.randn(T - 7, device=dev, generator=g) * 0.5
    q32, k32, v32 = (torch.randn(B, T, H, D, device=dev, generator=g) * 0.35
                     for _ in range(3))
    got = attention.onepass_self_attention(q32, k32, v32, bias)
    ref = attention.einsum_bias_attention(q32, k32, v32, bias)
    err32 = (got - ref).abs().max().item()
    log(f"[kernel] bias_attention f32: max_abs_err={err32:.3e} (atol 1e-4)")
    if err32 > 1e-4:
        raise AssertionError("bias_attention f32 disagrees with its plain version")
    del got, ref
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    del q32, k32, v32
    got = attention.onepass_self_attention(q, k, v, bias)
    ref = attention.einsum_bias_attention(q, k, v, bias)
    err = (got.float() - ref.float()).abs().max().item()
    rel = rel_l2(got, ref)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = bias.to(torch.bfloat16)
    ops = 4 * B * H * T * T * D
    nbytes = 2 * 4 * q.numel() + 4 * T
    report("bias_attention", "lyricalignment_tpu_torch/csrc/attention.cu",
           "lyricalignment_tpu/ops/attention.py:118", err,
           f"bf16 rel_l2={rel:.3e} <= 1e-2", rel <= 1e-2,
           time_ms(lambda: attention.onepass_self_attention(q, k, v, bias)),
           time_ms(lambda: attention.einsum_bias_attention(q, k, v, bias), reps=3),
           time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          scale=1.0)),
           *bound(ops, PEAK_BF16, nbytes))
    del q, k, v, qt, kt, vt, got, ref

    # --- kernel 3: class normaliser, 24000 rows x 21127 CTC syllable columns
    rows_h, feat = B * 1500, 768
    h = torch.randn(rows_h, feat, device=dev, generator=g) * 0.5
    s = 1.0 / math.sqrt(feat)
    w = (torch.rand(C_CTC, feat, device=dev, generator=g) * 2 - 1) * s
    b = (torch.rand(C_CTC, device=dev, generator=g) * 2 - 1) * s
    ws, bs = w[1:-1], b[1:-1]
    got = viterbi.row_lse(h, ws, bs)
    ref = viterbi.row_lse_plain(h, ws, bs)
    err = (got - ref).abs().max().item()
    ok = bool(((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
    ops = 2 * rows_h * feat * ws.shape[0]
    nbytes = 4 * (h.numel() + ws.numel() + bs.numel() + rows_h)
    report("row_lse", "lyricalignment_tpu_torch/csrc/lse.cu",
           "lyricalignment_tpu/ops/viterbi.py:269", err, "rtol 1e-5 / atol 1e-4", ok,
           time_ms(lambda: viterbi.row_lse(h, ws, bs), reps=3),
           time_ms(lambda: viterbi.row_lse_plain(h, ws, bs), reps=3),
           time_ms(lambda: torch.logsumexp(h @ ws.T + bs, dim=-1), reps=3),
           *bound(ops, PEAK_F32, nbytes))
    del h, w, b, ws, bs, got, ref

    # --- kernel 4: Viterbi DP, 16 x 1500 frames x 48 labels (K = 97)
    T = 1500
    logp = torch.log_softmax(torch.randn(B, T, L_BENCH + 1, device=dev, generator=g) * 3, -1)
    lab = logp[..., :L_BENCH].clamp(min=-1000.0).contiguous()
    sil = logp[..., L_BENCH].clamp(min=-1000.0).contiguous()
    labels = torch.randint(2, 400, (B, L_BENCH), device=dev, generator=g, dtype=torch.int32)
    labels[:, 5] = labels[:, 4]  # a repeat: skip banned
    nl = torch.full((B,), L_BENCH, dtype=torch.int32, device=dev)
    nl[1], nl[2] = 30, 1
    nf = torch.full((B,), T, dtype=torch.int32, device=dev)
    nf[1], nf[3] = 1200, 60
    args = (lab, sil, labels, nl, nf)
    got = viterbi.viterbi_dp(*args)
    ref = viterbi.viterbi_dp_plain(*args)
    exact = all(torch.equal(x, y) for x, y in zip(got, ref))
    err = max((x - y).abs().max().item() for x, y in zip(got, ref))
    # the DP stops at each row's num_frames: count the frames this data needs
    live = int(nf.clamp(0, T).sum())
    nbytes = 4 * (live * (L_BENCH + 1) + labels.numel() + 2 * B + 2 * B * L_BENCH)
    report("viterbi", "lyricalignment_tpu_torch/csrc/viterbi.cu",
           "lyricalignment_tpu/ops/viterbi_pallas.py:54", float(err), "exact", exact,
           time_ms(lambda: viterbi.viterbi_dp(*args), reps=10),
           time_ms(lambda: viterbi.viterbi_dp_plain(*args), reps=1, warmup=0),
           None, *bound(live * (2 * L_BENCH + 1), PEAK_F32, nbytes))
    return rows


# ---------------------------------------------------------------------------
# Phase 2: the serving path at whisper-medium width
# ---------------------------------------------------------------------------

POOL = "天地玄黄宇宙洪荒日月盈昃辰宿列张寒来暑往秋收冬藏闰余成岁律吕调阳云腾致雨露结为霜金生丽水玉出昆冈"


def _vocab_and_table():
    """Synthetic vocab over POOL whose ids land on real syllables of the
    pronunciation table (the first ids of the table are the 'bad' class)."""
    from lyricalignment_tpu_torch.text.bert_tokenizer import make_synthetic_vocab
    from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table

    table = load_pronunciation_table()
    vocab = make_synthetic_vocab(chars=POOL, size=21128)
    by_id = {i: t for t, i in vocab.items()}
    good = [i for i, p in enumerate(table.token_pinyin) if p != "bad"]
    for ch, target in zip(dict.fromkeys(POOL), good[::7]):
        old = vocab[ch]
        other = by_id[target]
        vocab[ch], vocab[other] = target, old
        by_id[target], by_id[old] = ch, other
    return vocab, table


def _write_requests(dirname, lengths, seed):
    import numpy as np

    from lyricalignment_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    requests = []
    for i, sec in enumerate(lengths):
        t = np.arange(int(sec * 16000)) / 16000.0
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t)
        audio = 0.2 * env * np.sin(2 * np.pi * (150 + 30 * i) * t) + 0.03 * rng.standard_normal(t.shape)
        path = os.path.join(dirname, f"req{i}.wav")
        write_wav(path, audio.astype(np.float32))
        n_chars = int(rng.integers(10, 49))
        requests.append((path, "".join(rng.choice(list(POOL), n_chars))))
    return requests


def _check_segments(results, requests, lengths):
    for (path, lyric), segs, sec in zip(requests, results, lengths):
        assert len(segs) == len(lyric), (path, len(segs), len(lyric))
        prev_off = 0.0
        for on, off, ch in segs:
            assert math.isfinite(on) and math.isfinite(off), (path, on, off)
            assert prev_off - 1e-9 <= on < off <= sec + 0.04, (path, prev_off, on, off)
            prev_off = off


def phase_serving(dev, tmp):
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, bf16_resident
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    t0 = time.perf_counter()
    # the inference configuration load_model_dir builds: the pad-once
    # (key bias) encoder route, as in the JAX package
    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True, onepass_encoder=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=C_CTC)
    with torch.device(dev):
        model = AlignModel(cfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    bf16_resident(model.whisper_model)
    model.eval()
    vocab, table = _vocab_and_table()
    aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table,
                           use_ctc=True, batch_size=8)
    lengths = [8.0, 11.5, 14.2, 17.3, 21.0, 24.6, 29.4, 45.0]
    requests = _write_requests(tmp, lengths, seed=1)
    log(f"[serving] whisper-medium AlignModel built in {time.perf_counter() - t0:.1f} s")

    aligner.align_many(requests[:1])  # first-use allocations outside the window
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = aligner.align_many(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    _check_segments(results, requests, lengths)
    log(f"[serving] answered {len(results)} requests ({sum(lengths):.1f} s of audio, "
        f"one of {lengths[-1]:.0f} s) in {wall:.3f} s; launches {counts}")
    for name in SERVING_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return model, counts


# ---------------------------------------------------------------------------
# Phase 3: a tiny float32 model, GPU kernels vs the CPU plain path
# ---------------------------------------------------------------------------

def phase_tiny_reference(dev, tmp):
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        forward_from_audio,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WhisperConfig
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    wcfg = WhisperConfig(n_vocab=64, n_audio_state=64, n_audio_head=1, n_audio_layer=2,
                         n_text_ctx=16, n_text_state=64, n_text_head=1, n_text_layer=1,
                         onepass_encoder=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=32, output_dim=C_CTC)
    cpu_model = AlignModel(cfg)
    init_weights(cpu_model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        cpu_model.align_rnn.fc.weight.mul_(8.0)  # sharp emissions: no near-ties
    cpu_model.eval()
    gpu_model = AlignModel(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev).eval()

    lengths = [6.3, 9.0, 33.0]
    requests = _write_requests(tmp, lengths, seed=2)
    vocab, table = _vocab_and_table()
    segs = {}
    for name, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table,
                               use_ctc=True, batch_size=4)
        kernels.reset_launch_counts()
        segs[name] = aligner.align_many(requests)
    # the float32 model takes the attention kernel's float32 path
    counts = dict(kernels.launches)
    for name in SERVING_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the float32 GPU run")
    flips = total = 0
    for a_req, b_req in zip(segs["cpu"], segs["gpu"]):
        for a, b in zip(a_req, b_req):
            for x, y in zip(a[:2], b[:2]):
                total += 1
                flips += x != y
                assert abs(x - y) <= 0.02 + 1e-9, (a, b)
    audio = torch.randn(2, 33 * 16000, generator=torch.Generator().manual_seed(4)) * 0.1
    frames = torch.tensor([1650, 700])
    with torch.inference_mode():
        h_cpu, _ = forward_from_audio(cpu_model, audio, frame_lengths=frames,
                                      mel_lengths=2 * frames, align_head_output="hidden")
        h_gpu, _ = forward_from_audio(gpu_model, audio.to(dev), frame_lengths=frames.to(dev),
                                      mel_lengths=2 * frames.to(dev),
                                      align_head_output="hidden")
    err = max((h_gpu[i, :n].cpu() - h_cpu[i, :n]).abs().max().item()
              for i, n in enumerate(frames.tolist()))
    log(f"[reference] tiny f32 model, GPU kernels vs CPU plain path: hidden max_abs_err="
        f"{err:.3e} (atol 1e-3); segments differ at {flips} of {total} positions "
        f"(<= 1 frame, <= 1 in 50 allowed); GPU align_many launches {counts}")
    if err > 1e-3 or flips > total // 50:
        raise AssertionError("GPU path disagrees with the CPU plain path")
    _check_segments(segs["gpu"], requests, lengths)


# ---------------------------------------------------------------------------
# Phase 4: device-only forward at the bench's operating point
# ---------------------------------------------------------------------------

def _device_trace(fn):
    """Device busy time of one call of ``fn`` from a torch.profiler (CUPTI)
    trace: (busy ms, {kernel name: (ms, count)}), or None when the trace
    holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "?")) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    if not spans:
        return None
    busy_us, end_us, by_name = 0.0, -math.inf, {}
    for t0, t1, name in spans:  # union of the intervals: one stream, but be safe
        busy_us += max(0.0, t1 - max(t0, end_us))
        end_us = max(end_us, t1)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t1 - t0) / 1e3, n + 1)
    return busy_us / 1e3, by_name


def phase_throughput(dev, model, card):
    import torch

    from lyricalignment_tpu_torch import EMBED_FRAMES, kernels
    from lyricalignment_tpu_torch.models.align_model import forward_from_audio
    from lyricalignment_tpu_torch.ops.viterbi import frames_to_seconds, viterbi_align_fused

    g = torch.Generator(device=dev).manual_seed(5)
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    frames = torch.full((B,), EMBED_FRAMES, dtype=torch.int32, device=dev)
    labels = torch.randint(2, 400, (B, L_BENCH), device=dev, generator=g, dtype=torch.int32)
    num_labels = torch.full((B,), L_BENCH, dtype=torch.int32, device=dev)
    fc = model.align_rnn.fc
    marks = []

    def stage(name, fn, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        marks.append((name, start, end))
        return out

    @torch.inference_mode()
    def align_batch():
        # the serving path's own calls (cli/inference_alignment.py:align_records)
        h, _ = stage("forward_from_audio", forward_from_audio, model, audio,
                     frame_lengths=frames, mel_lengths=2 * frames, align_head_output="hidden")
        on, off = stage("emissions+viterbi", viterbi_align_fused, h, fc.weight, fc.bias,
                        labels, num_labels, frames, "ctc")
        return frames_to_seconds(on, off)

    out = align_batch()
    torch.cuda.synchronize()
    assert out.shape == (B, L_BENCH, 2) and bool(torch.isfinite(out).all())
    marks.clear()
    iters = 5
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = align_batch()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(kernels.launches)
    per_batch = {"la_log10_mel": 1, "la_bias_attention": model.cfg.whisper.n_audio_layer,
                 "la_row_lse": 1, "la_viterbi": 1}
    expected = {name: iters * n for name, n in per_batch.items()}
    rate = iters * B * SECONDS / elapsed
    per_stage = {}
    for name, start, end in marks:
        per_stage.setdefault(name, []).append(start.elapsed_time(end))
    stages = {name: [round(x, 3) for x in sorted(ms)] for name, ms in per_stage.items()}
    log(f"[throughput] medium bf16 B={B} {SECONDS} s L={L_BENCH} CTC: "
        f"{rate:.2f} audio-s/s ({elapsed / iters * 1e3:.1f} ms/batch, mean of {iters}) "
        f"on {card}; stage ms (each batch, sorted) {json.dumps(stages)}; "
        f"launches in {iters} batches {counts}")
    if counts != expected:
        raise AssertionError(f"throughput batches launched {counts}, expected {expected}")

    # one more batch under the profiler: where the device time goes, and the
    # device's idle share against the mean batch above (a diagnostic: the
    # trace is optional and its absence fails nothing)
    try:
        trace = _device_trace(align_batch)
    except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
        log(f"[trace] not measured: {type(exc).__name__}: {exc}")
        return
    if trace is None:
        log("[trace] not measured: the profiler recorded no device activity")
        return
    busy, by_name = trace
    batch_ms = elapsed / iters * 1e3
    log(f"[trace] one batch: device busy {busy:.2f} ms of the {batch_ms:.1f} ms mean "
        f"batch, idle share {1 - busy / batch_ms:.3f}; top device kernels (ms, count):")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"[trace]   {ms:9.3f} {n:5d}  {name[:110]}")


# ---------------------------------------------------------------------------
# Phase 6: the multitask training path
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_H, TRAIN_T, ACCUM, TRAIN_STEPS = 2, 16, 1500, 8, 3
TRAIN_KERNELS = {"la_log10_mel": 1, "la_attention_fwd": 24, "la_attention_dkdv": 24,
                 "la_attention_dq": 24}  # a micro-batch of whisper-medium


def _attention_case(dev, b, t, h, dtype, with_bias, seed):
    """Kernel forward + backward under autograd vs autograd through the
    plain float32 einsum on the same (dtype-rounded) inputs: max abs errors
    of out, lse, dq, dk, dv and their rel-L2."""
    import torch

    from lyricalignment_tpu_torch.ops.attention import (
        attention_forward,
        einsum_bias_attention,
        onepass_self_attention,
        self_attention,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(b, t, h, 64, device=dev, generator=g).mul_(0.4).to(dtype)
                     for _ in range(4))
    bias = torch.zeros(1, t, device=dev)
    if with_bias:
        bias += torch.randn(1, t, device=dev, generator=g) * 0.5
        bias[0, t - t // 4:] = -1e9
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = onepass_self_attention(*leaves, bias) if with_bias else self_attention(*leaves)
    out.backward(dout)
    ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
    ref = einsum_bias_attention(*ref_leaves, bias)
    ref.backward(dout.float())
    _, lse = attention_forward(q, k, v, bias[0] if with_bias else None, with_lse=True)
    with torch.no_grad():
        ref_lse = torch.logsumexp(
            torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias[0], dim=-1)
    errs, rels = {}, {}
    for name, got, want in (("out", out.detach(), ref.detach()), ("lse", lse, ref_lse),
                            ("dq", leaves[0].grad, ref_leaves[0].grad),
                            ("dk", leaves[1].grad, ref_leaves[1].grad),
                            ("dv", leaves[2].grad, ref_leaves[2].grad)):
        diff = (got.double() - want.double())
        errs[name] = diff.abs().max().item()
        # rel-L2 with a floor for exactly-zero references (one key: dK = 0)
        rels[name] = diff.norm().item() / max(want.double().norm().item(), 1e-3)
    return errs, rels


def phase_train_kernels(dev):
    """(a): the training attention kernels at edge shapes and at the
    training shape; rows for the kernels line (launches filled in later)."""
    import torch

    from lyricalignment_tpu_torch.ops.attention import (
        attention_delta,
        attention_dkdv,
        attention_dq,
        attention_forward,
        einsum_attention,
    )

    for t in (1, 63, 65, 1500):
        for with_bias in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                errs, rels = _attention_case(dev, 2, t, 3, dtype, with_bias, seed=t)
                if dtype == torch.float32:
                    ok, text = max(errs.values()) <= 1e-4, f"max_abs={max(errs.values()):.2e}"
                else:
                    ok = errs["lse"] <= 1e-3 and max(
                        rels[n] for n in ("out", "dq", "dk", "dv")) <= 1e-2
                    text = (f"rel_l2 out/dq/dk/dv = {rels['out']:.2e}/{rels['dq']:.2e}/"
                            f"{rels['dk']:.2e}/{rels['dv']:.2e}, lse {errs['lse']:.2e}")
                log(f"[train-kernels] T={t} bias={with_bias} {str(dtype)[6:]}: {text} "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("attention training kernels disagree with autograd "
                                         f"through the plain einsum at T={t}")

    # the training shape: whisper-medium micro-batch, B = 2, H = 16, T = 1500
    b, t, h, d = TRAIN_B, TRAIN_T, TRAIN_H, 64
    for dtype in (torch.float32, torch.bfloat16):
        errs, rels = _attention_case(dev, b, t, h, dtype, False, seed=11)
        log(f"[train-kernels] training shape {str(dtype)[6:]}: max_abs {json.dumps(errs)} "
            f"rel_l2 {json.dumps(rels)}")
        ok = (max(errs.values()) <= 1e-4 if dtype == torch.float32 else
              errs["lse"] <= 1e-3 and max(rels[n] for n in ("out", "dq", "dk", "dv")) <= 1e-2)
        if not ok:
            raise AssertionError(f"training-shape attention ({dtype}) disagrees")
    bf16_errs = errs

    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, dout = (torch.randn(b, t, h, d, device=dev, generator=g).mul_(0.4)
                     .to(torch.bfloat16) for _ in range(4))
    out, lse = attention_forward(q, k, v, None, with_lse=True)
    delta = attention_delta(out, dout)
    fwd_ms = time_ms(lambda: attention_forward(q, k, v, None, with_lse=True), reps=20)
    dkdv_ms = time_ms(lambda: attention_dkdv(q, k, v, dout, lse, delta), reps=20)
    dq_ms = time_ms(lambda: attention_dq(q, k, v, dout, lse, delta), reps=20)
    delta_ms = time_ms(lambda: attention_delta(out, dout), reps=20)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    plain_out = einsum_attention(*leaves)
    plain_fwd_ms = time_ms(lambda: einsum_attention(q, k, v), reps=5)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(plain_out, leaves, dout,
                                                       retain_graph=True), reps=5)
    del plain_out
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in leaves)
    F = torch.nn.functional
    sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0),
                          reps=20)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
    dout_t = dout.transpose(1, 2)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                                      retain_graph=True), reps=20)
    log(f"[train-kernels] training shape bf16 B={b} H={h} T={t}: forward {fwd_ms:.4f} ms, "
        f"dK/dV {dkdv_ms:.4f} ms, dQ {dq_ms:.4f} ms, delta (torch reduction) "
        f"{delta_ms:.4f} ms; plain forward {plain_fwd_ms:.4f} ms, plain backward "
        f"{plain_bwd_ms:.4f} ms; SDPA forward {sdpa_fwd_ms:.4f} ms, backward "
        f"{sdpa_bwd_ms:.4f} ms, forward + backward {sdpa_fwd_ms + sdpa_bwd_ms:.4f} ms")

    product = 2 * b * h * t * t * d   # one T x T x 64 product
    tensor = 2 * b * t * h * d        # one bf16 [B, T, H, 64] tensor
    stats = 4 * b * h * t             # one f32 [B, H, T] row statistic
    rows = []
    for name, ms, plain_ms, lib_ms, products, nbytes, replaces in (
            ("attention_fwd", fwd_ms, plain_fwd_ms, sdpa_fwd_ms, 2, 4 * tensor + stats,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:758 "
             "_flash_attention_kernel)"),
            ("attention_dkdv", dkdv_ms, plain_bwd_ms, sdpa_bwd_ms, 4, 6 * tensor + 2 * stats,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:1121 "
             "_flash_attention_dkv_kernel)"),
            ("attention_dq", dq_ms, plain_bwd_ms, sdpa_bwd_ms, 3, 5 * tensor + 2 * stats,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:1456 "
             "_flash_attention_dq_kernel)")):
        bound_ms, bound_by = bound(products * product, PEAK_BF16, nbytes)
        src = "attention.cu" if name == "attention_fwd" else "attention_bwd.cu"
        rows.append(dict(name=name, route="cuda", source=f"lyricalignment_tpu_torch/csrc/{src}",
                         replaces=replaces, max_abs_err=bf16_errs[
                             {"attention_fwd": "out", "attention_dkdv": "dk",
                              "attention_dq": "dq"}[name]],
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        log(f"[kernel] {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return rows


def _train_batch(rng, accum, b, n_vocab_dec, classes, dec_len=40, n_ctc=24):
    """bench_train's stacked micro-batches: noise audio, 24 CTC labels, 30%
    labelled frames, random decoder tokens; numpy [accum, b, ...]."""
    import numpy as np

    n_samples = SECONDS * 16000
    return {
        "audio": (rng.standard_normal((accum, b, n_samples)) * 0.05).astype(np.float32),
        "ctc_labels": np.pad(rng.integers(2, classes, (accum, b, n_ctc)).astype(np.int32),
                             ((0, 0), (0, 0), (0, n_ctc)), constant_values=-100),
        "frame_labels": np.where(rng.random((accum, b, 1500)) < 0.3,
                                 rng.integers(2, classes, (accum, b, 1500)),
                                 -100).astype(np.int32),
        "label_lengths": np.full((accum, b), n_ctc, np.int32),
        "has_alignment": np.ones((accum, b), bool),
        "decoder_input": rng.integers(0, n_vocab_dec, (accum, b, dec_len)).astype(np.int32),
        "decoder_output": rng.integers(0, n_vocab_dec, (accum, b, dec_len)).astype(np.int32),
    }


def phase_train_tiny(dev):
    """(b): one make_train_step of a tiny float32 model on the GPU and on the
    CPU plain path; losses and per-group parameter updates compared."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WhisperConfig
    from lyricalignment_tpu_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    wcfg = WhisperConfig(n_vocab=64, n_audio_state=64, n_audio_head=1, n_audio_layer=2,
                         n_text_ctx=64, n_text_state=64, n_text_head=1, n_text_layer=1)
    # dropout 0: the CPU and CUDA generators draw different masks
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=32, output_dim=421, dropout=0.0,
                           train_transcript=True)
    tcfg = TrainConfig(accum_grad_steps=2, use_ctc=True, vocab_size=420, warmup_steps=0,
                       total_steps=10, head_lr=5e-3, backbone_lr=1e-3)
    stacked = _train_batch(np.random.default_rng(6), 2, 2, 64, 400, dec_len=12)
    stacked["has_alignment"][:, 1] = False  # a transcript-only sample in each micro-batch
    cpu_model = AlignModel(cfg)
    init_weights(cpu_model, torch.Generator().manual_seed(7))
    gpu_model = AlignModel(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev)
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    results = {}
    for name, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        state, tx = init_train_state(model, tcfg)
        kernels.reset_launch_counts()
        _, losses = make_train_step(tcfg, tx)(state, stacked)
        results[name] = ({k: float(v) for k, v in losses.items()}, dict(kernels.launches),
                         {n: p.detach().cpu() for n, p in model.named_parameters()})
    (l_cpu, _, p_cpu), (l_gpu, counts, p_gpu) = results["cpu"], results["gpu"]
    loss_rel = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-6) for k in l_cpu)
    worst = {}
    for group, lr in (("head", tcfg.head_lr), ("backbone", tcfg.backbone_lr)):
        names = [n for n in before if n.startswith("align_rnn.") == (group == "head")]
        d_cpu = torch.cat([(p_cpu[n] - before[n]).flatten() for n in names]).double()
        d_gpu = torch.cat([(p_gpu[n] - before[n]).flatten() for n in names]).double()
        # Adam's first step is close to lr * sign(g): a gradient at the
        # level of float32 noise can flip its entry, so count the entries
        # whose update differs by more than 2e-2 lr
        worst[group] = ((d_gpu - d_cpu).abs() > 2e-2 * lr).double().mean().item()
        moved = (d_gpu.abs() > 0.5 * lr).double().mean().item()
        log(f"[train-tiny] {group}: update rel_l2 GPU vs CPU "
            f"{((d_gpu - d_cpu).norm() / d_cpu.norm()).item():.2e}, share of entries off by "
            f"> 2e-2 lr {worst[group]:.2e} (<= 1e-3), {moved:.3f} of the entries moved by "
            f"> lr/2")
    log(f"[train-tiny] losses CPU {json.dumps(l_cpu)}; GPU max rel diff {loss_rel:.2e} "
        f"(<= 1e-4); GPU launches {counts}")
    if loss_rel > 1e-4 or max(worst.values()) > 1e-3:
        raise AssertionError("GPU train step disagrees with the CPU plain path")
    for name in TRAIN_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the GPU train step")


def phase_train_medium(dev, card):
    """(c): whisper-medium at bench_train's operating point."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
    from lyricalignment_tpu_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        make_train_step,
        to_device,
    )

    t0 = time.perf_counter()
    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=C_CTC,
                           train_transcript=True)
    with torch.device(dev):
        model = AlignModel(cfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    # warmup_steps 1: the untimed first update has lr 0, the timed ones lr > 0
    tcfg = TrainConfig(accum_grad_steps=ACCUM, use_ctc=True, vocab_size=C_CTC - 1,
                       warmup_steps=1, total_steps=2000, grad_accum_dtype=torch.bfloat16,
                       adam_mu_dtype=torch.bfloat16)
    state, tx = init_train_state(model, tcfg)
    step_fn = make_train_step(tcfg, tx)
    stacked = to_device(_train_batch(np.random.default_rng(0), ACCUM, TRAIN_B,
                                     wcfg.n_vocab, 400), dev)
    n_params = sum(p.numel() for p in model.parameters())
    watch = ("whisper_model.encoder.blocks.0.attn.query.weight",
             "whisper_model.decoder.blocks.23.mlp.0.weight", "align_rnn.fc.weight")
    params = dict(model.named_parameters())
    log(f"[train-medium] {n_params / 1e6:.1f} M parameters, set up in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = step_fn(state, stacked)
    torch.cuda.synchronize()
    log(f"[train-medium] warm-up step (lr 0) {time.perf_counter() - t0:.3f} s, losses "
        f"{json.dumps({k: round(float(v), 5) for k, v in losses.items()})}")
    snap = {n: params[n].detach().clone() for n in watch}
    steps = TRAIN_STEPS
    kernels.reset_launch_counts()
    times, all_losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, losses = step_fn(state, stacked)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_losses.append({k: float(v) for k, v in losses.items()})
    counts = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [round(x * 1e3, 1) for x in times]
    mean_s = sum(times) / steps
    rate = ACCUM * TRAIN_B * SECONDS / mean_s
    moved = {n: (params[n].detach() - snap[n]).abs().max().item() for n in watch}
    log(f"[train-medium] whisper-medium bf16, {ACCUM} x {TRAIN_B} x {SECONDS} s, CTC "
        f"{C_CTC}, align CE + CTC + transcript CE: step ms {step_ms} (mean "
        f"{mean_s * 1e3:.1f}), {rate:.2f} trained audio-s/s, max_memory_allocated "
        f"{peak_gb:.2f} GB on {card}; launches in {steps} steps {counts}")
    log(f"[train-medium] losses {json.dumps(all_losses)}; max |update| of {json.dumps(moved)}")
    expected = {name: steps * ACCUM * n for name, n in TRAIN_KERNELS.items()}
    if counts != expected:
        raise AssertionError(f"train steps launched {counts}, expected {expected}")
    if not all(math.isfinite(v) for row in all_losses for v in row.values()):
        raise AssertionError("non-finite training loss")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"parameters did not move: {moved}")

    try:
        trace = _device_trace(lambda: step_fn(state, stacked))
    except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
        log(f"[train-trace] not measured: {type(exc).__name__}: {exc}")
        trace = None
    if trace is None:
        log("[train-trace] not measured: the profiler recorded no device activity")
    else:
        busy, by_name = trace
        n_kernels = sum(n for _, n in by_name.values())
        # the align head's recurrence: cuDNN/cuBLAS kernels per time step
        gru = sum(n for name, (_, n) in by_name.items()
                  if "RNN" in name or "GRU" in name or "gemmSN" in name)
        log(f"[train-trace] one step: device busy {busy:.1f} ms of the {mean_s * 1e3:.1f} ms "
            f"mean step, idle share {1 - busy / (mean_s * 1e3):.3f}; {n_kernels} device "
            f"kernels and copies, {gru} of them the GRU's per-time-step kernels; top device "
            f"kernels (ms, count):")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
            log(f"[train-trace]   {ms:9.3f} {n:6d}  {name[:110]}")
    return counts


def phase_train_cli(dev, tmp):
    """(d): the train CLI for 2 steps of whisper-tiny, then align with the
    model it wrote."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.cli.common import load_model_dir
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    vocab, table = _vocab_and_table()
    lengths = [6.0, 9.5, 12.0, 14.5]
    requests = _write_requests(tmp, lengths, seed=3)
    records = []
    for (path, lyric), sec in zip(requests, lengths):
        step = (sec - 0.5) / len(lyric)
        records.append({"song_path": path, "lyric": lyric,
                        "on_offset": [[0.2 + i * step, 0.2 + (i + 0.8) * step]
                                      for i in range(len(lyric))]})
    data = os.path.join(tmp, "train.json")
    with open(data, "w", encoding="utf-8") as f:
        json.dump(records, f, ensure_ascii=False)
    vocab_path = os.path.join(tmp, "vocab.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(tok for tok, _ in sorted(vocab.items(), key=lambda kv: kv[1])))
    save = os.path.join(tmp, "result")
    cmd = [sys.executable, "-m", "lyricalignment_tpu_torch.cli.train_multitask",
           "--train-data", data, "--dev-data", data, "--whisper-model", "tiny",
           "--train-alignment", "--train-transcript", "--use-ctc-loss", "--bf16",
           "--fast-gelu", "--train-batch-size", "2", "--dev-batch-size", "4",
           "--accum-grad-steps", "2", "--train-steps", "2", "--eval-steps", "1",
           "--warmup-steps", "0", "--bert-vocab", vocab_path, "--save-dir", save,
           "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    log(f"[train-cli] {' '.join(cmd[1:4])} ... exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-12:]:
        log(f"[train-cli]   {line}")
    if proc.returncode != 0:
        raise AssertionError("the train CLI failed")
    if not os.path.exists(os.path.join(save, "best_model.pt")):
        raise AssertionError("the train CLI wrote no best_model.pt")
    _, model, _ = load_model_dir(save, "best", use_bf16=True, device=str(dev))
    aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table, use_ctc=True,
                           batch_size=4)
    results = aligner.align_many(requests)
    _check_segments(results, requests, lengths)
    log(f"[train-cli] best_model loaded and aligned {len(results)} requests "
        f"({sum(len(r) for r in results)} characters)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from lyricalignment_tpu_torch import kernels
        from lyricalignment_tpu_torch.cli.common import resolve_device
    except ImportError as exc:
        print(f"chip_smoke: the lyricalignment_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2

    try:
        dev = resolve_device("cuda")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        card = smi[0].strip() if smi else torch.cuda.get_device_name(0)
        log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

        t0 = time.perf_counter()
        kernels.library()
        log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
            f"({kernels.build_info.get('path')})")
        log(str(kernels.build_info.get("log", "")).strip())

        rows = phase_kernels(dev)
        with tempfile.TemporaryDirectory() as tmp:
            model, counts = phase_serving(dev, tmp)
            phase_tiny_reference(dev, tmp)
        phase_throughput(dev, model, card)
        del model
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        train_rows = phase_train_kernels(dev)
        phase_train_tiny(dev)
        train_counts = phase_train_medium(dev, card)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_cli(dev, tmp)
        log(f"[train] phase passed in {time.perf_counter() - t0:.1f} s")
    except Exception:  # report any failed phase and exit non-zero
        traceback.print_exc()
        return 1

    # launches: each path's own run (serving for the serving kernels, the
    # timed whisper-medium train steps for the training kernels)
    launchers = {"log10_mel": "la_log10_mel", "bias_attention": "la_bias_attention",
                 "row_lse": "la_row_lse", "viterbi": "la_viterbi"}
    for row in rows:
        row["launches"] = counts[launchers[row["name"]]]
    for row in train_rows:
        row["launches"] = train_counts[f"la_{row['name']}"]
        log(f"[kernel] {row['name']}: {row['launches']} launches in {TRAIN_STEPS} train steps, "
            f"{row['launches'] // TRAIN_STEPS} a step")
    rows += train_rows
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
