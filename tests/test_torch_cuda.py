"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path can reach: ragged last tiles, sequences
shorter than a tile, 128 mel bands, silent and full-scale audio, Viterbi
state counts from 3 to 16601 (every states-a-lane plan, 1 to 32 warps a
sequence) over 1 to 3000 frames (backpointers in shared memory and
flushed), tied emissions, the reduced CTC's plans (1 to 32 warps a
sample), zero-frame and zero-label rows, the CTC column slice and the
row log-sum-exp's tiles and column ranges, and the attention backward with
and without a key bias. ``chip_smoke.py`` covers the main
path's own shapes. On a machine with an NVIDIA GPU (the repository's
tests/conftest.py needs JAX, which such a machine may lack):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without a CUDA device every test here skips: a CUDA kernel has no CPU mode.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lyricalignment_tpu_torch.cli.common import resolve_device

    return resolve_device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("seconds,n_mels", [(0.5, 80), (7.37, 128), (30.0, 80)])
def test_log10_mel(dev, seconds, n_mels):
    from lyricalignment_tpu_torch.ops import mel

    audio = torch.randn(3, int(seconds * 16000), device=dev, generator=_gen(1)) * 0.1
    audio[1, audio.shape[1] // 2:] = 0.0  # silence: the 1e-10 floor
    padded = mel.reflect_pad(audio).contiguous()
    n_frames = audio.shape[1] // 160
    got = mel.log10_mel(padded, n_frames, n_mels)
    ref = mel.log10_mel_plain(padded, n_frames, n_mels)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def _log10_mel_f64(padded, n_frames, n_mels):
    """float64 reference: numpy's rfft of the Hann-windowed frames, the
    float32 filterbank's weights, log10 floored at 1e-10; [B, n_mels, T']."""
    import numpy as np

    from lyricalignment_tpu_torch.ops import mel

    x = padded.double().cpu().numpy()
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(400) / 400))
    frames = np.stack([x[:, f * 160:f * 160 + 400] for f in range(n_frames)], axis=1)
    power = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    spec = power @ mel.mel_filterbank(n_mels=n_mels).T.astype(np.float64)
    return torch.from_numpy(np.log10(np.maximum(spec, 1e-10))).transpose(1, 2)


# frame counts around the kernel's 32-frame tiles, one frame, both band counts
@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_frames", [1, 31, 33, 64, 77])
def test_log10_mel_frame_counts(dev, n_frames, n_mels):
    """The FFT kernel against the plain dense-DFT version (atol 1e-4) and a
    float64 reference (atol 1e-4: both float32 versions sit within 1e-5)."""
    from lyricalignment_tpu_torch.ops import mel

    audio = torch.randn(2, n_frames * 160, device=dev, generator=_gen(n_frames)) * 0.1
    padded = mel.reflect_pad(audio).contiguous() if n_frames > 1 else torch.nn.functional.pad(
        audio, (200, 200))  # 160 samples cannot be reflected by 200
    got = mel.log10_mel(padded, n_frames, n_mels)
    assert got.shape == (2, n_mels, n_frames)
    torch.testing.assert_close(got, mel.log10_mel_plain(padded, n_frames, n_mels),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(got.double().cpu(), _log10_mel_f64(padded, n_frames, n_mels),
                               atol=1e-4, rtol=0)
    assert torch.equal(got, mel.log10_mel(padded, n_frames, n_mels))


def test_log10_mel_half_silent_audio(dev):
    """Loud noise that stops mid-clip: every frame is transformed on its
    own, so each all-zero frame gives exactly log10(1e-10) beside full-scale
    neighbours, and the rest agree with the plain version."""
    from lyricalignment_tpu_torch.ops import mel

    n_frames = 101
    audio = torch.randn(2, n_frames * 160, device=dev, generator=_gen(2)).clamp(-1, 1)
    audio[0, 50 * 160 + 37:] = 0.0
    audio[1, :33 * 160 + 5] = 0.0
    padded = mel.reflect_pad(audio).contiguous()
    got = mel.log10_mel(padded, n_frames, 80)
    torch.testing.assert_close(got, mel.log10_mel_plain(padded, n_frames, 80), atol=1e-4, rtol=0)
    silent = (padded.unfold(-1, 400, 160)[:, :n_frames] == 0).all(-1)  # [B, T']
    assert int(silent[0].sum()) >= 45 and int(silent[1].sum()) >= 30
    assert bool((got.transpose(1, 2)[silent] == -10.0).all())


def test_log10_mel_full_scale_sine(dev):
    """A full-scale sine: the spectrum spans more decades than float32
    arithmetic resolves, so the versions are compared where the frontend
    keeps them, within 8 decades of the peak (``log_mel`` clamps there).
    Against the plain version and against float64: atol 1e-4 within 6
    decades of the peak, and 1e-3 down to 8, where float32 rounding of the
    transform (1e-7 of the peak's amplitude, 1e-3 of a bin 4 decades of
    amplitude below it) is what either float32 version can hold."""
    from lyricalignment_tpu_torch.ops import mel

    n_frames = 200
    t = torch.arange(n_frames * 160, device=dev, dtype=torch.float64) / 16000.0
    audio = torch.stack([torch.sin(2 * torch.pi * 440.0 * t),
                         torch.sin(2 * torch.pi * 3217.3 * t)]).float()
    padded = mel.reflect_pad(audio).contiguous()
    got = mel.log10_mel(padded, n_frames, 80).double()
    ref = mel.log10_mel_plain(padded, n_frames, 80).double()
    exact = _log10_mel_f64(padded, n_frames, 80).to(dev)
    assert float(exact.min()) < float(exact.max()) - 8.0  # the clamp is reached
    for decades, atol in ((6.0, 1e-4), (8.0, 1e-3)):
        floor = exact.max() - decades
        kept = torch.maximum(got, floor)
        torch.testing.assert_close(kept, torch.maximum(ref, floor), atol=atol, rtol=0)
        torch.testing.assert_close(kept, torch.maximum(exact, floor), atol=atol, rtol=0)


def _key_bias(kind, seq, dev, g):
    """[1, seq] f32 key bias: "none" zeros, "random" noise with the last
    quarter of the keys masked (-1e9, never all of them), "first_key" -1e9
    on every key but the first."""
    bias = torch.zeros(1, seq, device=dev)
    if kind == "random":
        bias += torch.randn(1, seq, device=dev, generator=g) * 0.5
        bias[0, seq - seq // 4:] = -1e9
    elif kind == "first_key":
        bias[0, 1:] = -1e9
    return bias


# T around the 128-row tiles of the bf16 forward (and the 64 of its backward
# and of the float32 kernels):
# ragged last query and key tiles, one key, the encoder's 1500
SEQS = [1, 50, 64, 127, 128, 129, 130, 255, 1500]


@pytest.mark.parametrize("batch,heads", [(2, 3)])
@pytest.mark.parametrize("bias_kind", ["random", "first_key"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq", SEQS)
def test_bias_attention(dev, seq, dtype, bias_kind, batch, heads):
    _bias_attention_case(dev, seq, dtype, bias_kind, batch, heads)


def test_bias_attention_serving_shape(dev):
    """The serving shape: B x H = 16 x 16, T = 1500, bf16."""
    _bias_attention_case(dev, 1500, torch.bfloat16, "random", 16, 16)


def _bias_attention_case(dev, seq, dtype, bias_kind, batch, heads):
    """Kernel vs the plain einsum: float32 atol 1e-4, bf16 rel-L2 1e-2; the
    row log-sum-exp against ``attention_fwd_plain(with_lse=True)`` within
    atol 1e-4; two runs bit-equal (no atomics)."""
    from lyricalignment_tpu_torch.ops.attention import (
        attention_forward,
        attention_fwd_plain,
        einsum_bias_attention,
        onepass_self_attention,
    )

    g = _gen(seq)
    q, k, v = (torch.randn(batch, seq, heads, 64, device=dev, generator=g).to(dtype) * 0.4
               for _ in range(3))
    bias = _key_bias(bias_kind, seq, dev, g)
    got = onepass_self_attention(q, k, v, bias)
    ref = einsum_bias_attention(q, k, v, bias)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, onepass_self_attention(q, k, v, bias))
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    else:
        rel = (got.double() - ref.double()).norm() / ref.double().norm()
        assert rel < 1e-2, float(rel)
    _, lse = attention_forward(q, k, v, bias[0], with_lse=True)
    _, ref_lse = attention_fwd_plain(q.float(), k.float(), v.float(), bias[0], with_lse=True)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("batch,n_frames", [(5, 1501), (16, 3000)])
def test_log10_mel_128_bands_against_float64(dev, batch, n_frames):
    """The large-v3 frontend's 128 bands (several low bands one bin wide)
    at a batch whose last tile of 32 frames is partial (1501 frames) and at
    the alignment batch of 16 x 30 s: against the plain version run in
    float64 where the frontend keeps the mel, as
    ``test_log10_mel_full_scale_sine`` holds it: atol 1e-4 within 6 decades
    of the peak, 1e-3 down to 8 (``log_mel``'s clamp), where float32
    rounding of the transform is what a float32 version can hold (on an
    H100 a bin 7.9 decades down is 1.2e-4 off; the float32 plain version's
    dense DFT is 2.8e-4 off below the clamp)."""
    from lyricalignment_tpu_torch.ops import mel

    audio = torch.randn(batch, n_frames * 160, device=dev, generator=_gen(batch)) * 0.1
    audio[0, : audio.shape[1] // 3] = 0.0  # silence: the 1e-10 floor
    padded = mel.reflect_pad(audio).contiguous()
    got = mel.log10_mel(padded, n_frames, 128)
    assert got.shape == (batch, 128, n_frames)
    ref = mel.log10_mel_plain(padded.double(), n_frames, 128)
    for decades, atol in ((6.0, 1e-4), (8.0, 1e-3)):
        floor = ref.max() - decades
        torch.testing.assert_close(torch.maximum(got.double(), floor),
                                   torch.maximum(ref, floor), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("seq", [1, 63, 65, 127, 128, 129, 200, 255, 1500])
def test_attention_forward_and_backward(dev, seq, with_bias, dtype):
    """Forward with the row log-sum-exp, then the dK/dV and dQ kernels
    under autograd, against autograd through the plain float32 einsum:
    float32 atol 1e-4; bf16 rel-L2 1e-2 (bf16 inputs, P and dS rounded to
    bf16 before their products). The log-sum-exp against
    ``attention_fwd_plain(with_lse=True)`` within atol 1e-4, and the
    forward bit-equal from run to run."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.attention import (
        attention_forward,
        attention_fwd_plain,
        einsum_bias_attention,
        onepass_self_attention,
        self_attention,
    )

    g = _gen(seq + 7 * with_bias)
    q, k, v, dout = (torch.randn(2, seq, 3, 64, device=dev, generator=g) * 0.4
                     for _ in range(4))
    bias = _key_bias("random" if with_bias else "none", seq, dev, g)
    leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = (onepass_self_attention(*leaves, bias) if with_bias else self_attention(*leaves))
    out.backward(dout.to(dtype))
    assert dict(kernels.launches) == {"la_attention_fwd": 1, "la_attention_dkdv": 1,
                                      "la_attention_dq": 1}

    ref_leaves = [x.detach().float().requires_grad_() for x in leaves]
    ref = einsum_bias_attention(*ref_leaves, bias)
    ref.backward(dout.to(dtype).float())
    inputs = [x.detach() for x in leaves]
    key_bias = bias[0] if with_bias else None
    fwd, lse = attention_forward(*inputs, key_bias, with_lse=True)
    fwd2, lse2 = attention_forward(*inputs, key_bias, with_lse=True)
    assert torch.equal(fwd, fwd2) and torch.equal(lse, lse2)
    _, ref_lse = attention_fwd_plain(*(x.float() for x in inputs), key_bias, with_lse=True)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    pairs = [(out.detach(), ref.detach())] + [(a.grad, b.grad) for a, b in zip(leaves, ref_leaves)]
    for got, want in pairs:
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        else:
            # rel-L2 1e-2, with a floor for exactly-zero references (one key:
            # the softmax is constant, so dK is 0)
            err = (got.double() - want.double()).norm()
            assert err <= 1e-2 * want.double().norm() + 1e-5, float(err)


def test_attention_backward_is_reproducible(dev):
    """No atomics: two backward passes give bit-equal gradients."""
    from lyricalignment_tpu_torch.ops.attention import self_attention

    g = _gen(3)
    q, k, v, dout = (torch.randn(2, 300, 4, 64, device=dev, generator=g).to(torch.bfloat16)
                     for _ in range(4))
    grads = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        self_attention(*leaves).backward(dout)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_attention_backward_batch_of_16(dev):
    """The backward pair at B x H = 16 x 16, T = 1500, bf16 (3,072 work
    items of 128 keys, 2,048 of 192 queries: many rounds of the persistent
    grids) against autograd through the plain float32 einsum, two samples at
    a time; rel-L2 1e-2 for dq, dk, dv."""
    from lyricalignment_tpu_torch.ops.attention import einsum_attention, self_attention

    g = _gen(16)
    q, k, v, dout = (torch.randn(16, 1500, 16, 64, device=dev, generator=g).mul_(0.4)
                     .to(torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    self_attention(*leaves).backward(dout)
    for b0 in range(0, 16, 2):
        ref_leaves = [x[b0:b0 + 2].float().requires_grad_() for x in (q, k, v)]
        einsum_attention(*ref_leaves).backward(dout[b0:b0 + 2].float())
        for name, got, want in zip("qkv", leaves, ref_leaves):
            err = (got.grad[b0:b0 + 2].double() - want.grad.double()).norm()
            assert err <= 1e-2 * want.grad.double().norm(), (name, b0, float(err))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq", [1, 129, 300])
def test_attention_kernels_at_20_heads(dev, seq, dtype):
    """The whisper-large head count (20 heads of 64): the forward with its
    row log-sum-exp, dK/dV and dQ against their plain versions on the same
    inputs (float32 atol 1e-4; bf16 rel-L2 1e-2, the log-sum-exp atol
    1e-4), each a launch of its own kernel."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.attention import (
        attention_delta,
        attention_dkdv,
        attention_dkdv_plain,
        attention_dq,
        attention_dq_plain,
        attention_forward,
        attention_fwd_plain,
    )

    g = _gen(20 + seq)
    q, k, v, dout = (torch.randn(2, seq, 20, 64, device=dev, generator=g).mul_(0.4).to(dtype)
                     for _ in range(4))
    kernels.reset_launch_counts()
    out, lse = attention_forward(q, k, v, None, with_lse=True)
    delta = attention_delta(out, dout)
    dk, dv = attention_dkdv(q, k, v, dout, lse, delta)
    dq = attention_dq(q, k, v, dout, lse, delta)
    assert dict(kernels.launches) == {"la_attention_fwd": 1, "la_attention_dkdv": 1,
                                      "la_attention_dq": 1}
    ref_out, ref_lse = attention_fwd_plain(q, k, v, None, with_lse=True)
    ref_dk, ref_dv = attention_dkdv_plain(q, k, v, dout, lse, delta)
    ref_dq = attention_dq_plain(q, k, v, dout, lse, delta)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    for name, got, want in (("out", out, ref_out), ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                            ("dv", dv, ref_dv)):
        assert got.dtype == dtype and got.shape == want.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=name)
        else:
            # a floor for exactly-zero references (one key: dK is 0)
            err = (got.double() - want.double()).norm()
            assert err <= 1e-2 * want.double().norm() + 1e-5, (name, float(err))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq", [65, 200, 1500])
def test_attention_backward_with_masked_keys(dev, seq, dtype):
    """A bias of -1e9 on every key but the first, through the backward
    kernels: finite gradients, exactly zero dK and dV on the masked keys,
    and dV of the first key the column sum of dO."""
    from lyricalignment_tpu_torch.ops.attention import onepass_self_attention

    g = _gen(seq)
    q, k, v, dout = (torch.randn(2, seq, 3, 64, device=dev, generator=g).mul_(0.4).to(dtype)
                     for _ in range(4))
    bias = _key_bias("first_key", seq, dev, g)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    onepass_self_attention(*leaves, bias).backward(dout)
    dq, dk, dv = (x.grad for x in leaves)
    assert all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    assert not dk[:, 1:].any() and not dv[:, 1:].any()
    want = dout.float().sum(1)
    if dtype == torch.float32:
        torch.testing.assert_close(dv[:, 0], want, atol=1e-4, rtol=0)
        torch.testing.assert_close(dq, torch.zeros_like(dq), atol=1e-4, rtol=0)
    else:
        err = (dv[:, 0].double() - want.double()).norm()
        assert err <= 1e-2 * want.double().norm(), float(err)


def test_attention_backward_refuses_strided_statistics(dev):
    """The backward kernels read the row statistics as contiguous f32
    [B, H, T] with ordinary loads: another layout is refused, not copied."""
    from lyricalignment_tpu_torch.ops.attention import attention_dkdv, attention_dq

    x = torch.zeros(2, 70, 3, 64, device=dev, dtype=torch.bfloat16)
    stats = torch.zeros(2, 3, 70, device=dev)
    strided = torch.zeros(2, 70, 3, device=dev).transpose(1, 2)  # [B, H, T], T not innermost
    for fn in (attention_dkdv, attention_dq):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x, x, x, x, strided, stats)
        with pytest.raises(ValueError, match=r"\[B, H, T\]"):
            fn(x, x, x, x, stats, stats[:, :, :69].contiguous())
        with pytest.raises(ValueError, match="expected torch.float32"):
            fn(x, x, x, x, stats.double(), stats)


def test_attention_without_grad_writes_no_statistics(dev):
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.attention import self_attention

    x = torch.randn(1, 70, 2, 64, device=dev, requires_grad=True)
    kernels.reset_launch_counts()
    with torch.no_grad():
        self_attention(x, x, x)
    assert dict(kernels.launches) == {"la_bias_attention": 1}


@pytest.mark.parametrize("variant", ["remat", "onepass"])
def test_encoder_training_options_on_the_kernels(dev, variant):
    """A tiny float32 encoder + decoder on the card: ``remat`` (the
    forward kernel runs again inside the backward) and ``onepass_encoder``
    (the key-bias route) give the plain run's features and gradients
    (atol 1e-5), through the forward, dK/dV and dQ kernels."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.models.whisper import Whisper, WhisperConfig

    cfg = WhisperConfig(n_vocab=64, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                        n_text_ctx=16, n_text_state=128, n_text_head=2, n_text_layer=1)
    torch.manual_seed(0)
    plain = Whisper(cfg)
    for p in plain.parameters():
        p.data.normal_(0.0, 0.05)
    other = Whisper(dataclasses.replace(cfg, onepass_encoder=variant == "onepass"))
    other.load_state_dict(plain.state_dict())
    mel = torch.randn(2, 80, 3000, device=dev, generator=_gen(5))
    tokens = torch.randint(0, 64, (2, 7), device=dev, generator=_gen(6))

    def run(model, remat):
        model.to(dev)
        feats = model.embed_audio(mel, remat=remat)
        logits = model.decoder_logits(tokens, feats, remat=remat)
        (feats.square().mean() + logits.logsumexp(-1).mean()).backward()
        return feats.detach(), {n: p.grad for n, p in model.named_parameters()}

    f0, g0 = run(plain, False)
    kernels.reset_launch_counts()
    f1, g1 = run(other, variant == "remat")
    fwd = "la_attention_fwd"
    assert kernels.launches[fwd] == (4 if variant == "remat" else 2)
    assert kernels.launches["la_attention_dkdv"] == kernels.launches["la_attention_dq"] == 2
    torch.testing.assert_close(f1, f0, atol=1e-5, rtol=0)
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, atol=1e-5, rtol=1e-5, msg=name)


def test_gru_dropout_draws_from_the_generator(dev):
    from torch import nn

    from lyricalignment_tpu_torch.ops.gru import bigru_apply

    rnn = nn.GRU(16, 8, num_layers=2, bidirectional=True, batch_first=True).to(dev)
    x = torch.randn(2, 50, 16, device=dev, generator=_gen(8))
    a, b, c = (bigru_apply(rnn, x, dropout=0.5, generator=_gen(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(bigru_apply(rnn, x), rnn(x)[0], atol=1e-5, rtol=0)


def _gru_layer_inputs(rnn):
    """gi, w_hh, b_hh of a one-layer nn.GRU for gru_recurrence."""
    import torch.nn.functional as F

    sfx = ("", "_reverse") if rnn.bidirectional else ("",)
    get = lambda n: [getattr(rnn, f"{n}_l0{s}") for s in sfx]
    return (lambda x: F.linear(x, torch.cat(get("weight_ih")), torch.cat(get("bias_ih"))),
            torch.stack(get("weight_hh")).contiguous(), torch.stack(get("bias_hh")).contiguous())


@pytest.mark.parametrize("n_in", [1024, 1280, 768])
def test_gru_recurrence_at_the_cells_shapes(dev, n_in):
    """One bi-GRU layer at the alignment cells' shapes (B = 16, T = 1500,
    H = 384; input 1024 and 1280, the encoders' widths, and 768, the second
    layer's), ragged lengths with a row of 1 and one of T: the kernel
    against its plain version on the same input products and against
    cuDNN's packed float32 RNN (TF32 off). Each sums in its own order, over
    1500 dependent steps: 1e-5 (the state lies in (-1, 1); 3.7e-7 was read
    on an H100); past each length exact zeros, and one launch a layer."""
    from torch import nn
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.gru import bigru_apply, gru_recurrence_plain

    torch.manual_seed(n_in)
    rnn = nn.GRU(n_in, 384, num_layers=1, bidirectional=True, batch_first=True).to(dev)
    b, t = 16, 1500
    lengths = [t, 1, 2, t - 1] + [int(x) for x in torch.linspace(40, t, b - 4)]
    x = torch.randn(b, t, n_in, device=dev, generator=_gen(n_in))
    if n_in == 768:  # the second layer reads the first's outputs, in (-1, 1)
        x = torch.tanh(x)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = bigru_apply(rnn, x, lens)
        assert dict(kernels.launches) == {"la_gru_recurrence": 1}
        gi_fn, w_hh, b_hh = _gru_layer_inputs(rnn)
        plain = gru_recurrence_plain(gi_fn(x), w_hh, b_hh, lens)
        packed = pack_padded_sequence(x, torch.tensor(lengths), batch_first=True,
                                      enforce_sorted=False)
        cudnn = pad_packed_sequence(rnn(packed)[0], batch_first=True, total_length=t)[0]
    for i, n in enumerate(lengths):
        torch.testing.assert_close(got[i, :n], plain[i, :n], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[i, :n], cudnn[i, :n], atol=1e-5, rtol=0)
        assert torch.equal(got[i, n:], torch.zeros_like(got[i, n:]))


@pytest.mark.parametrize("b,t,h,dirs", [(1, 1, 4, 2), (3, 2, 6, 2), (5, 37, 8, 2),
                                        (16, 37, 16, 2), (40, 9, 32, 2), (4, 20, 32, 1),
                                        (1, 300, 100, 2), (2, 17, 384, 2), (17, 5, 384, 1),
                                        (9, 64, 50, 2)])
def test_gru_recurrence_edges(dev, b, t, h, dirs):
    """Every hidden size the repo uses (4-32, 384), sizes whose last block
    owns fewer units (50, 100), one direction, batches of 1 to 40 rows (one
    to several clusters a direction, 1 to 8 rows a cluster) and T from 1:
    the kernel against its plain version, lengths 1..T."""
    from lyricalignment_tpu_torch.ops.gru import gru_recurrence, gru_recurrence_plain

    g = _gen(b * 1000 + t * 10 + h)
    gi = torch.randn(b, t, dirs * 3 * h, device=dev, generator=g)
    w_hh = torch.randn(dirs, 3 * h, h, device=dev, generator=g) / h ** 0.5
    b_hh = torch.randn(dirs, 3 * h, device=dev, generator=g) * 0.1
    lens = torch.randint(1, t + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0] = t
    got = gru_recurrence(gi, w_hh, b_hh, lens)
    want = gru_recurrence_plain(gi, w_hh, b_hh, lens)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    again = gru_recurrence(gi, w_hh, b_hh, lens)
    assert torch.equal(got, again)


def test_gru_head_launches_without_a_host_sync(dev):
    """align_head_hidden under inference_mode at the serving shape: two
    launches (one a layer), no cuDNN, and no host sync (the lengths stay on
    the card)."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.models.align_head import AlignHead, align_head_hidden

    torch.manual_seed(0)
    head = AlignHead(1024, 384, 8).to(dev).eval()
    x = torch.randn(16, 1500, 1024, device=dev, generator=_gen(3))
    lens = torch.tensor([1500, 1, 700] + [1400] * 13, device=dev)
    with torch.inference_mode():
        align_head_hidden(head, x, lens)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                h = align_head_hidden(head, x, lens)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert dict(kernels.launches) == {"la_gru_recurrence": 2}
    assert not any("rnn" in e.key.lower() for e in prof.key_averages())
    assert h.shape == (16, 1500, 768) and bool(torch.isfinite(h).all())


def test_gru_recurrence_refuses_what_it_cannot_take(dev):
    from torch import nn

    from lyricalignment_tpu_torch.ops.gru import bigru_apply, gru_recurrence

    rnn = nn.GRU(8, 400, bidirectional=True, batch_first=True).to(dev)
    x = torch.randn(2, 5, 8, device=dev)
    with torch.inference_mode(), pytest.raises(ValueError, match="hidden sizes up to 384"):
        bigru_apply(rnn, x)
    gi = torch.zeros(2, 5, 6 * 16, device=dev)
    w_hh, b_hh = torch.zeros(2, 48, 16, device=dev), torch.zeros(2, 48, device=dev)
    lens = torch.full((2,), 5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        gru_recurrence(gi.double(), w_hh, b_hh, lens)
    with pytest.raises(ValueError, match="int32"):
        gru_recurrence(gi, w_hh, b_hh, lens.long())
    with pytest.raises(ValueError, match="shapes"):
        gru_recurrence(gi[..., :-1].contiguous(), w_hh, b_hh, lens)


def test_bias_attention_refuses_other_head_widths(dev):
    from lyricalignment_tpu_torch.ops.attention import onepass_self_attention

    x = torch.zeros(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        onepass_self_attention(x, x, x, torch.zeros(1, 8, device=dev))


def test_attention_skips_an_empty_call(dev):
    """A rank of the sequence-parallel encode may hold no head (H < m): the
    forward launches nothing and returns the empty output."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.attention import self_attention

    q = torch.empty(2, 1499, 0, 64, device=dev, dtype=torch.bfloat16)
    before = dict(kernels.launches)
    assert self_attention(q, q, q).shape == q.shape
    assert dict(kernels.launches) == before


def test_bias_attention_refuses_an_unaligned_bias(dev):
    """The bf16 forward reads the key bias with TMA: 16-byte aligned only."""
    from lyricalignment_tpu_torch.ops.attention import onepass_self_attention

    x = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(1, 9, device=dev)[:, 1:]  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        onepass_self_attention(x, x, x, bias)


@pytest.mark.parametrize("rows,cols", [(1, 5), (63, 127), (200, 300), (1000, 4229)])
@pytest.mark.parametrize("ctc_slice", [False, True])
def test_row_lse(dev, rows, cols, ctc_slice):
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_plain

    g = _gen(rows + cols)
    h = torch.randn(rows, 64, device=dev, generator=g)
    w = torch.randn(cols + 2, 64, device=dev, generator=g) * 0.3
    b = torch.randn(cols + 2, device=dev, generator=g)
    w, b = (w[1:-1], b[1:-1]) if ctc_slice else (w[:cols], b[:cols])
    got = row_lse(h, w, b)
    ref = row_lse_plain(h, w, b)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def _lse_inputs(dev, rows, feat, cols, seed, h_scale=1.0):
    g = _gen(seed)
    h = torch.randn(rows, feat, device=dev, generator=g) * h_scale
    w = torch.randn(cols, feat, device=dev, generator=g) * (feat ** -0.5)
    b = torch.randn(cols, device=dev, generator=g)
    return h, w, b


# around the kernel's tiles: 128 rows of h an item, 128 columns of w a tile
# (4229 columns are 34 tiles, split into column ranges), 32 feat a stage
@pytest.mark.parametrize("feat", [4, 36, 64, 768])
@pytest.mark.parametrize("cols", [5, 127, 128, 129, 255, 256, 257, 4229])
@pytest.mark.parametrize("rows", [1, 127, 128, 129])
def test_row_lse_edges(dev, rows, cols, feat):
    """The split-precision tensor-core kernel against the plain float32
    version (rtol 1e-5 / atol 1e-4), and bit-equal from run to run (the
    column ranges are merged in a fixed order, no atomics)."""
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_plain

    h, w, b = _lse_inputs(dev, rows, feat, cols, rows + cols + feat)
    got = row_lse(h, w, b)
    assert got.shape == (rows,) and got.dtype == torch.float32
    torch.testing.assert_close(got, row_lse_plain(h, w, b), atol=1e-4, rtol=1e-5)
    assert torch.equal(got, row_lse(h, w, b))


def test_row_lse_main_path_shape(dev):
    """16 x 1500 rows, feat 768, the CTC head's 21127 syllable columns (a
    slice of the 21129-row weight), against the plain version and against
    float64 on the first 512 rows."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_plain

    h, w, b = _lse_inputs(dev, 24000, 768, 21129, 7, h_scale=0.5)
    w, b = w[1:-1], b[1:-1]
    kernels.reset_launch_counts()
    got = row_lse(h, w, b)
    assert dict(kernels.launches) == {"la_row_lse": 1}
    torch.testing.assert_close(got, row_lse_plain(h, w, b), atol=1e-4, rtol=1e-5)
    exact = torch.logsumexp(h[:512].double() @ w.double().T + b.double(), dim=-1)
    torch.testing.assert_close(got[:512].double(), exact, atol=1e-4, rtol=1e-5)
    assert torch.equal(got, row_lse(h, w, b))


@pytest.mark.parametrize("case", ["scaled_h", "one_dominant_column"])
def test_row_lse_large_logits(dev, case):
    """Logits of large magnitude: h scaled by 30, and rows whose largest
    logit exceeds every other by more than 100 (the sum is that logit)."""
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_plain

    h, w, b = _lse_inputs(dev, 300, 768, 4229, 11, h_scale=30.0 if case == "scaled_h" else 1.0)
    if case == "one_dominant_column":
        b[1234] += 150.0
    got = row_lse(h, w, b)
    ref = row_lse_plain(h, w, b)
    exact = torch.logsumexp(h.double() @ w.double().T + b.double(), dim=-1)
    if case == "one_dominant_column":
        logits = h.double() @ w.double().T + b.double()
        top = logits.topk(2, dim=-1).values
        assert bool((top[:, 0] - top[:, 1] > 100).all())
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got.double(), exact, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("top", [20.0, 40.0])
def test_row_lse_accumulation_rounds(dev, top):
    """Rows whose largest logit is a sum of 768 products of one sign, as on
    trained weights: float32 adds that truncate (the tensor cores' own,
    over all of a row's products) pull such a logit toward zero by ~1e-4;
    the kernel adds each group of six products into its running sum
    rounded to nearest, and rounds the low halves of its split. Against
    float64: atol 1.5e-5 at a top logit of 20, 3e-5 at 40 (a few float32
    ulps of the logit)."""
    from lyricalignment_tpu_torch.ops.viterbi import row_lse

    h, w, b = _lse_inputs(dev, 300, 768, 4229, 13)
    h = h.abs()
    # column r of the first 256 rows aligned with row r: logit ~ top, all
    # its products positive
    aligned = h[:256] / (h[:256] ** 2).sum(dim=1, keepdim=True) * top
    w[:256] = (aligned + 0.1 * w[:256].abs()).contiguous()
    got = row_lse(h, w, b)
    exact = torch.logsumexp(h.double() @ w.double().T + b.double(), dim=-1)
    assert float(exact[:256].min()) > 0.5 * top
    torch.testing.assert_close(got.double(), exact, atol=1.5e-5 if top == 20.0 else 3e-5,
                               rtol=0)


def test_row_lse_refusals(dev):
    """What the tensor maps cannot take is refused, not copied: h or w off a
    16-byte boundary, shapes that disagree, other types and layouts. A feat
    that is not a multiple of 4 is zero-padded by the wrapper (exact): feat
    62 equals the plain version."""
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_plain

    h, w, b = _lse_inputs(dev, 8, 64, 12, 1)
    h62, w62 = h[:, :62].contiguous(), w[:, :62].contiguous()
    torch.testing.assert_close(row_lse(h62, w62, b), row_lse_plain(h62, w62, b),
                               atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        row_lse(h, torch.zeros(12 * 64 + 1, device=dev)[1:].view(12, 64), b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        row_lse(torch.zeros(8 * 64 + 1, device=dev)[1:].view(8, 64), w, b)
    with pytest.raises(ValueError, match="do not agree"):
        row_lse(h, w, b[:11])
    with pytest.raises(ValueError, match="do not agree"):
        row_lse(h, w[:, :60].contiguous(), b)
    with pytest.raises(ValueError, match="do not agree"):
        row_lse(h, w[:0], b[:0])
    with pytest.raises(ValueError, match="expected torch.float32"):
        row_lse(h.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        row_lse(h, w.T.contiguous().T, b)
    assert row_lse(h[:0], w, b).shape == (0,)


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _check_backward(h, w, b, g, rel=1e-5):
    """The row LSE (``la_row_lse``, atol the larger of 2e-5 and ``rel``
    against float64) and its backward (``la_row_lse_bwd``) against the plain
    chunked recompute run in float64 (rel-L2 ``rel`` each of dh, dw, db),
    bit-equal from run to run."""
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_bwd, row_lse_bwd_plain

    lse = row_lse(h, w, b)
    exact = torch.logsumexp(h.double() @ w.double().T + b.double(), dim=-1)
    torch.testing.assert_close(lse.double(), exact, atol=max(2e-5, rel), rtol=0)
    assert torch.equal(lse, row_lse(h, w, b))
    got = row_lse_bwd(h, w, b, lse, g)
    ref = row_lse_bwd_plain(h.double(), w.double(), b.double(), lse.double(), g.double())
    for x, want in zip(got, ref):
        assert x.dtype == torch.float32 and x.shape == want.shape
        assert _rel(x, want) <= rel, _rel(x, want)
    assert all(torch.equal(x, y) for x, y in zip(got, row_lse_bwd(h, w, b, lse, g)))
    return lse, got


# around the backward's tiles and chunks: 128 rows of h and 128 columns a
# tile of p, 128 x 64 tiles of dh and dw, the dh product's K ranges, chunks
# of 4224 columns (two, then a ragged 7-column one at 4229 x 2 + 7)
@pytest.mark.parametrize("rows,cols,feat", [
    (rows, cols, feat) for feat in (16, 48, 768) for cols in (1, 31, 33, 4229)
    for rows in (1, 31, 32, 33, 300)] + [(3000, 4229 * 2 + 7, 768)])
def test_row_lse_backward_edges(dev, rows, cols, feat):
    h, w, b = _lse_inputs(dev, rows, feat, cols, rows + cols + feat)
    g = torch.randn(rows, device=dev, generator=_gen(3))
    _check_backward(h, w, b, g)


@pytest.mark.parametrize("top,rel", [(20.0, 1e-5), (40.0, 3e-5)])
def test_row_lse_backward_on_aligned_rows(dev, top, rel):
    """Rows whose largest logit is a sum of 768 products of one sign, so that
    p sits in one column of the row (as on trained weights): dh is one large
    product plus the chunks' small ones, where an accumulator whose adds
    truncate drifts (``tests/test_torch_kernel_tables.py``). Against
    float64: rel-L2 1e-5 at a top logit of 20; at 40, p's relative error is
    the float32 logit's absolute error (~1e-5 by the groups' truncating adds
    over 768 one-signed products, the forward's atol of 3e-5 at 40), and the
    tolerance follows it."""
    h, w, b = _lse_inputs(dev, 300, 768, 4229, 13)
    h = h.abs()
    aligned = h[:256] / (h[:256] ** 2).sum(dim=1, keepdim=True) * top
    w[:256] = (aligned + 0.1 * w[:256].abs()).contiguous()
    g = torch.randn(300, device=dev, generator=_gen(6))
    lse, _ = _check_backward(h, w, b, g, rel)
    top_p = torch.exp(h[:256].double() @ w[:256].double().T + b[:256].double()
                      - lse[:256, None].double()).diagonal()
    assert float(top_p.median()) > 0.5 and float(top_p.min()) > 0.1


def test_row_lse_backward_subsets(dev):
    """Each output alone, and dw with db, has the bits it has when all three
    are asked for (the entry skips p, p^T or a product it does not need)."""
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_bwd

    h, w, b = _lse_inputs(dev, 300, 96, 4229, 17)
    g = torch.randn(300, device=dev, generator=_gen(8))
    lse = row_lse(h, w, b)
    full = row_lse_bwd(h, w, b, lse, g)
    for needs in ((True, False, False), (False, True, False), (False, False, True),
                  (False, True, True)):
        got = row_lse_bwd(h, w, b, lse, g, needs)
        for x, y, need in zip(got, full, needs):
            assert (x is None) if not need else torch.equal(x, y)


@pytest.mark.parametrize("first", [0, 1])
def test_row_lse_autograd_reaches_the_slice(dev, first):
    """Under autograd, the gradient of a row slice ``w[first:first + C]`` of a
    larger weight lands in those rows only, as autograd through the plain
    version (float64) puts it; the forward kernel launches once and the
    backward entry once."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, row_lse_plain

    h, w, b = _lse_inputs(dev, 200, 64, 300, 5)
    weights = torch.randn(200, device=dev, generator=_gen(4))
    leaves = [x.clone().requires_grad_() for x in (h, w, b)]
    kernels.reset_launch_counts()
    (row_lse(leaves[0], leaves[1][first:first + 297], leaves[2][first:first + 297])
     * weights).sum().backward()
    assert dict(kernels.launches) == {"la_row_lse": 1, "la_row_lse_bwd": 1}
    refs = [x.double().requires_grad_() for x in (h, w, b)]
    (row_lse_plain(refs[0], refs[1][first:first + 297], refs[2][first:first + 297])
     * weights.double()).sum().backward()
    for got, want in zip(leaves, refs):
        assert _rel(got.grad, want.grad) <= 1e-5
    assert float(leaves[1].grad[first + 297:].abs().sum()) == 0.0


def test_row_lse_backward_refusals(dev):
    """The backward takes what the forward takes: 16-byte aligned h and w of
    any feat (feat 36 and 784, past the first design's limits, and feat 62
    and 766, zero-padded to a multiple of 4 by the wrapper, are held to
    float64); an unaligned w and shapes that disagree are refused."""
    from lyricalignment_tpu_torch.ops.viterbi import row_lse_bwd

    lse, g = torch.zeros(8, device=dev), torch.ones(8, device=dev)
    for feat in (62, 766):
        h, w, b = _lse_inputs(dev, 40, feat, 300, feat)
        _check_backward(h, w, b, torch.randn(40, device=dev, generator=_gen(feat)))
    h, w, b = _lse_inputs(dev, 8, 64, 12, 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        row_lse_bwd(h, torch.zeros(12 * 64 + 1, device=dev)[1:].view(12, 64), b, lse, g)
    with pytest.raises(ValueError, match="do not agree"):
        row_lse_bwd(h, w, b, lse[:7], g)
    for feat in (36, 784):
        h, w, b = _lse_inputs(dev, 40, feat, 300, feat)
        _check_backward(h, w, b, torch.randn(40, device=dev, generator=_gen(feat)))


def _ctc_case(dev, b, t, n, seed, kinds):
    """Reduced emissions and targets: per sample a kind of target
    ("random", "repeats", "empty", "infeasible" (more labels than frames),
    "full")."""
    g = _gen(seed)
    blank = torch.randn(b, t, device=dev, generator=g) - 2.0
    label = torch.randn(b, t, n, device=dev, generator=g) - 2.0
    labels = torch.randint(1, 50, (b, n), device=dev, generator=g, dtype=torch.int32)
    valid = torch.zeros(b, n, dtype=torch.bool, device=dev)
    for i, kind in enumerate(kinds):
        k = {"random": n // 2, "repeats": n // 2, "empty": 0, "full": n,
             "infeasible": n}[kind]
        valid[i, :k] = True
        if kind == "repeats":
            labels[i, 1:k:2] = labels[i, 0:k - 1:2]
    return blank, label, labels, valid


# the plans' edges: S = 31 / 33 / 127 / 129 / 1023 cross 32-, 64- and
# 128-state warp boundaries (1 to 32 warps a sample at one state a lane);
# chunks with a ragged last one; T = 1 and 2 (no step, one step) at large N
@pytest.mark.parametrize("t,n", [(1, 1), (2, 3), (37, 5), (1500, 48), (300, 400), (70, 15),
                                 (70, 16), (130, 63), (130, 64), (97, 511), (1, 400), (2, 511)])
def test_ctc_reduced(dev, t, n):
    """The reduced CTC kernels against the plain recursions (NLL rtol 1e-5,
    gradients atol 1e-5 + rel-L2 1e-5): repeated labels, an all-padding
    target, a target that cannot fit (NLL ~1e30, gradient still flowing)
    and a full one; bit-equal from run to run."""
    from lyricalignment_tpu_torch.ops import ctc

    kinds = ["random", "repeats", "empty", "infeasible" if 2 * n > t else "full"]
    blank, label, labels, valid = _ctc_case(dev, 4, t, n, t + n, kinds)
    nll, alphas = ctc.ctc_reduced_fwd(blank, label, labels, valid)
    ref_nll, ref_alphas = ctc.ctc_reduced_fwd_plain(blank, label, labels, valid)
    torch.testing.assert_close(nll, ref_nll, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(alphas, ref_alphas, rtol=1e-5, atol=1e-4)
    g = torch.randn(4, device=dev, generator=_gen(9))
    d_blank, d_label = ctc.ctc_reduced_bwd(alphas, labels, valid, g)
    ref = ctc.ctc_reduced_bwd_plain(ref_alphas, labels, valid, g)
    for got, want in zip((d_blank, d_label), ref):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        # at T = 1 the end states past state 1 leave d label_lp all zero:
        # rel-L2 has no reference norm there, so the zeros must be exact
        assert _rel(got, want) <= 1e-5 if want.any() else not got.any()
    again = ctc.ctc_reduced_bwd(alphas, labels, valid, g)
    assert torch.equal(d_blank, again[0]) and torch.equal(d_label, again[1])
    assert torch.equal(nll, ctc.ctc_reduced_fwd(blank, label, labels, valid)[0])


def test_ctc_plan(dev):
    """``la_ctc_plan``: each chain's K states a lane (1, 2 or 4) in
    ceil(S / 32K) warps, the backward's padded states (a weight row's
    stride) 32 K warps; chunks of 64 frames, fewer at short T and where a
    ring (three slots forward, two backward) would pass 128 KB; the
    backward's scratch of 3 padded rows a frame after the first."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops import ctc

    for n in (1, 15, 16, 48, 63, 64, 511):
        s_dim = 2 * n + 1
        plan = ctc.ctc_plan(1500, n)
        for part in ("forward", "backward"):
            k = plan[f"{part} states a lane"]
            assert k in (1, 2, 4)
            assert plan[f"{part} warps"] == -(-s_dim // (32 * k))
            assert plan[f"{part} lanes"] == -(-s_dim // k)
        s_pad = 32 * plan["backward states a lane"] * plan["backward warps"]
        assert plan["backward padded states"] == s_pad
        # 64 frames a chunk at most; rings of three (forward: a chunk's
        # rows and blank values, each with a spare frame) and two
        # (backward) slots within 128 KB
        fits = max(c for c in range(1, 65)
                   if 3 * 4 * ((((c + 1) * n + 7) & ~3) + ((c + 4) & ~3)) <= 128 * 1024)
        assert plan["forward chunk"] == fits
        assert plan["backward chunk"] == min(64, 128 * 1024 // (2 * 3 * 4 * s_pad))
        assert kernels.library().la_ctc_bwd_scratch_floats(2, 1500, n) == 2 * 1499 * 3 * s_pad
    plan = ctc.ctc_plan(9, 48)
    assert ctc.ctc_plan(1, 48)["forward chunk"] == 1 and plan["backward chunk"] == 8
    with pytest.raises(ValueError, match="no plan"):
        ctc.ctc_plan(10, 512)


@pytest.mark.parametrize("m,k,n", [(17, 64, 24), (40, 1024, 4096), (3000, 4096, 1024)])
def test_int8_linear_matches_the_cpu_path(dev, m, k, n):
    """``_linear_int8`` on the card (``torch._int_mm`` from its least M, 17)
    against the CPU path: the int32 products are exact, so the results agree
    to float32 rounding of the rescale."""
    from torch import nn

    from lyricalignment_tpu_torch.models import whisper as tw

    g = torch.Generator().manual_seed(m + k)
    x = torch.randn(m, k, generator=g)
    lin = nn.Linear(k, n)
    with torch.no_grad():
        lin.weight.normal_(0.0, k ** -0.5, generator=g)
    want = tw._linear_int8(lin, x)
    got = tw._linear_int8(lin.to(dev), x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    xq, _ = tw._quantize_int8(x, -1)
    wq, _ = tw._quantize_int8(lin.weight.cpu(), 1)
    assert torch.equal(tw._int_mm(xq.to(dev), wq.to(dev)).cpu(), xq.int() @ wq.int().T)


def test_fused_losses_match_the_cpu_path(dev):
    """The fused CE and CTC losses of a small head on the card (row LSE and
    its backward entry, reduced CTC kernels) against the CPU plain path:
    losses rtol 1e-5, gradients of h, fc weight and bias rel-L2 1e-4 (the
    kernels sum in another order than the chunked plain path, and the CTC
    gradient's softmax and posterior parts cancel: 1.4e-5 to 1.6e-5 in
    three runs on an H100, the gather's backward adding in no fixed
    order)."""
    from torch import nn

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.train import losses

    g = torch.Generator().manual_seed(2)
    h = torch.randn(2, 300, 64, generator=g)
    fc = nn.Linear(64, 501)
    labels = torch.randint(1, 500, (2, 300), generator=g)
    labels[:, ::3] = -100
    ctc_labels = torch.full((2, 12), -100)
    ctc_labels[0, :10] = torch.randint(1, 500, (10,), generator=g)
    ctc_labels[0, 4] = ctc_labels[0, 3]
    mask = torch.tensor([True, False])
    out = {}
    for name, d in (("cpu", "cpu"), ("gpu", dev)):
        hh = h.to(d).detach().requires_grad_()
        f = nn.Linear(64, 501).to(d)
        f.load_state_dict(fc.state_dict())
        kernels.reset_launch_counts()
        loss = (losses.frame_ce_loss_grouped_fused(hh, f, labels.to(d), mask.to(d), True, 500)
                + losses.ctc_loss_grouped_fused(hh, f, ctc_labels.to(d), mask.to(d), 500))
        loss.backward()
        out[name] = (loss.item(), [t.cpu() for t in (hh.grad, f.weight.grad, f.bias.grad)],
                     dict(kernels.launches))
    assert out["gpu"][2] == {"la_row_lse": 2, "la_row_lse_bwd": 2,
                             "la_ctc_reduced_fwd": 1, "la_ctc_reduced_bwd": 1}
    assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0]), out
    rels = [_rel(got, want) for got, want in zip(out["gpu"][1], out["cpu"][1])]
    assert max(rels) <= 1e-4, rels


# l_max 1 .. 1000: two states a lane on 1, 1, 2, 5, 10 and 32 warps; 1100 /
# 2500 / 5000 / 8300: 4 / 8 / 16 / 32 states a lane (32: two backpointer
# words a lane a step). 1500 x 300, 3000 x 128 and every larger product
# flush their backpointers through the scratch.
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("frames", [1, 2, 37, 1500, 3000])
@pytest.mark.parametrize("l_max", [1, 16, 48, 128, 300, 1000, 1100, 2500, 5000, 8300])
def test_viterbi_exact(dev, frames, l_max, kind):
    """Onsets and offsets bit-equal to the plain version, on random or
    constant (all tied) emissions, with full, short, zero, one and too many
    frames and zero / one / partial label counts; a second run gives the
    same bits."""
    from lyricalignment_tpu_torch.ops.viterbi import viterbi_dp, viterbi_dp_plain

    g = _gen(frames + l_max)
    b = 5
    if kind == "ties":
        lab = torch.full((b, frames, l_max), -2.0, device=dev)
        sil = torch.full((b, frames), -2.0, device=dev)
    else:
        logp = torch.log_softmax(torch.randn(b, frames, l_max + 1, device=dev, generator=g) * 3,
                                 -1)
        lab = logp[..., :l_max].clamp(min=-1000.0).contiguous()
        sil = logp[..., l_max].clamp(min=-1000.0).contiguous()
    labels = torch.randint(1, 6, (b, l_max), device=dev, generator=g, dtype=torch.int32)
    nl = torch.tensor([l_max, min(3, l_max), 0, 1, l_max], dtype=torch.int32, device=dev)
    nf = torch.tensor([frames, frames // 2, 0, 1, frames + 7], dtype=torch.int32, device=dev)
    got = viterbi_dp(lab, sil, labels, nl, nf)
    ref = viterbi_dp_plain(lab, sil, labels, nl, nf)
    again = viterbi_dp(lab, sil, labels, nl, nf)
    for x, y, z in zip(got, ref, again):
        assert torch.equal(x, y)
        assert torch.equal(x, z)


# ---------------------------------------------------------------------------
# KV-cached decoding and the decode loops on the card, against the CPU path
# (which tests/test_torch_decode*.py hold to JAX and to the beam oracle)
# ---------------------------------------------------------------------------

def _tiny_whisper(n_vocab=40, n_text_ctx=32):
    from lyricalignment_tpu_torch.models.whisper import Whisper, WhisperConfig

    cfg = WhisperConfig(n_vocab=n_vocab, n_audio_ctx=50, n_audio_state=64, n_audio_head=1,
                        n_audio_layer=1, n_text_ctx=n_text_ctx, n_text_state=64,
                        n_text_head=4, n_text_layer=2)
    torch.manual_seed(3)
    model = Whisper(cfg).eval()
    for p in model.parameters():
        p.data.normal_(0.0, 0.3)
    return model


@pytest.mark.parametrize("g", [1, 5])
def test_decode_step_matches_the_cpu_path(dev, g):
    from lyricalignment_tpu_torch.models.whisper import (
        decode_step,
        init_decode_cache,
        prime_decode_cache,
    )

    cpu = _tiny_whisper()
    gpu = _tiny_whisper().to(dev)
    gen = torch.Generator().manual_seed(g)
    xa = torch.randn(2, 50, 64, generator=gen)
    prompt = torch.randint(0, 40, (2, 6), generator=gen)
    fed = torch.randint(0, 40, (5, 2 * g, 1), generator=gen)
    out = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        cache = init_decode_cache(model, model.cfg, xa.to(d), 6, 5, beam_size=g)
        logits, aux, cache = prime_decode_cache(model, model.cfg, prompt.to(d), cache,
                                                torch.tensor([6, 3]), aux_index=torch.tensor([2, 0]))
        steps = [logits, aux]
        for tok in fed:
            step, cache = decode_step(model, model.cfg, tok.to(d), cache)
            steps.append(step)
        out[name] = [s.cpu() for s in steps]
    for a, b in zip(out["gpu"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _hash_table(seed, vocab, eot):
    """Integer logits indexed by a rolling hash of the history (the beam
    oracle test's fake model): exact ties are common."""
    import numpy as np

    rng = np.random.default_rng(seed)
    table = rng.integers(-4, 5, size=(997, vocab)).astype(np.float32)
    boost = rng.random(997) < 0.33
    table[boost, eot] += 5.0
    table[~boost, eot] -= 3.0
    return torch.from_numpy(table)


@pytest.mark.parametrize("seed,k,max_new,lp,patience,group", [
    (0, 5, 12, None, None, 1), (2, 5, 12, 1.0, None, 2), (5, 5, 12, None, 2.0, 1),
    (6, 4, 6, None, None, 4), (10, 5, 12, None, 0.6, 1), (12, 3, 14, None, 0.34, 2)])
def test_beam_loop_ties_match_the_cpu_path(dev, monkeypatch, seed, k, max_new, lp, patience,
                                           group):
    from lyricalignment_tpu_torch.decode import beam as beam_mod

    table = _hash_table(seed, 16, 15)
    table[:, [1, 2]] += beam_mod.NEG_INF        # suppressed columns tie exactly
    h0 = torch.tensor([(seed * 7 + s * 13 + 1) % 997 for s in range(3)]).repeat_interleave(k)
    out = {}
    for d in ("cpu", dev):
        tab = table.to(d)

        def fake_decode_step(model, cfg, tok, cache, tab=tab):
            h = (cache["blocks"][0]["h"] * 31 + tok[:, 0]) % 997
            return tab[h], {"blocks": [{"h": h}]}

        monkeypatch.setattr(beam_mod, "decode_step", fake_decode_step)
        h = h0.to(d)
        toks, avg = beam_mod.beam_loop(None, None, tab[h], {"blocks": [{"h": h.clone()}]},
                                       lambda l, g, i: l, k, max_new, 15, lp, patience,
                                       group=group)
        out[str(d)] = (toks.cpu(), avg.cpu())
    assert torch.equal(out[str(dev)][0], out["cpu"][0])
    # the scores sum log-softmax values, whose last bits differ by device
    torch.testing.assert_close(out[str(dev)][1], out["cpu"][1], atol=1e-6, rtol=1e-6)


def test_greedy_beam_and_sampling_match_the_cpu_path(dev):
    from lyricalignment_tpu_torch.decode import beam as beam_mod

    cpu = _tiny_whisper()
    gpu = _tiny_whisper().to(dev)
    xa = torch.randn(3, 50, 64, generator=torch.Generator().manual_seed(1)) * 2.0
    prompt = torch.tensor([[31, 32]] * 3)
    kw = dict(max_new_tokens=10, eot=30)
    for fn, extra in ((beam_mod.greedy_decode, {}), (beam_mod.beam_search, dict(beam_size=4)),
                      (beam_mod.beam_search, dict(beam_size=5, patience=0.6, group=3))):
        a = fn(cpu, cpu.cfg, xa, prompt, **kw, **extra)
        b = fn(gpu, gpu.cfg, xa.to(dev), prompt.to(dev), **kw, **extra)
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        assert torch.equal(a[0], b[0].cpu())
        if len(a) > 1:
            torch.testing.assert_close(b[1].cpu(), a[1], atol=1e-5, rtol=0)


def test_decode_loops_replay_the_step_graph_exactly(dev, monkeypatch):
    """The loops' steps replayed from a CUDA graph give the tokens and
    scores of the same loops running :func:`decode_step` itself on the card:
    the graph holds the same kernels on the same buffers. Two beam searches
    in a row reuse the thread's capture stream and graph pool."""
    from lyricalignment_tpu_torch.decode import beam as beam_mod

    gpu = _tiny_whisper().to(dev)
    xa = (torch.randn(3, 50, 64, generator=torch.Generator().manual_seed(1)) * 2.0).to(dev)
    prompt = torch.tensor([[31, 32]] * 3, device=dev)
    kw = dict(max_new_tokens=10, eot=30)
    runs = ((beam_mod.greedy_search, {}), (beam_mod.beam_search, dict(beam_size=4)),
            (beam_mod.beam_search, dict(beam_size=5, patience=0.6, group=3)))
    captures = []
    capture = beam_mod._Stepper._capture
    monkeypatch.setattr(beam_mod._Stepper, "_capture",
                        lambda self, tok: (captures.append(1), capture(self, tok))[1])
    graphed = [fn(gpu, gpu.cfg, xa, prompt, **kw, **extra) for fn, extra in runs]
    assert len(captures) == len(runs)
    monkeypatch.setattr(beam_mod, "_graphable", lambda model, tokens: False)
    eager = [fn(gpu, gpu.cfg, xa, prompt, **kw, **extra) for fn, extra in runs]
    assert len(captures) == len(runs)
    for (a_tok, a_score), (b_tok, b_score) in zip(graphed, eager):
        assert torch.equal(a_tok, b_tok)
        assert torch.equal(a_score, b_score)


def test_sampling_replays_the_step_graph_exactly(dev, monkeypatch):
    from lyricalignment_tpu_torch.decode import beam as beam_mod
    from lyricalignment_tpu_torch.models.whisper import init_decode_cache, prime_decode_cache

    gpu = _tiny_whisper().to(dev)
    xa = (torch.randn(2, 50, 64, generator=torch.Generator().manual_seed(3)) * 2.0).to(dev)
    prompt = torch.tensor([[31, 32]] * 2, device=dev)
    process = beam_mod.make_processor(gpu.cfg, 30, device=dev)
    out = []
    for graphable in (True, False):
        if not graphable:
            monkeypatch.setattr(beam_mod, "_graphable", lambda model, tokens: False)
        cache = init_decode_cache(gpu, gpu.cfg, xa, 2, 10)
        logits, _, cache = prime_decode_cache(gpu, gpu.cfg, prompt, cache)
        out.append(beam_mod.sample_loop(gpu, gpu.cfg, logits, cache, process, _gen(5), 0.7, 10,
                                        30))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("i", [0, 1, 2, 5])
def test_timestamp_rules_match_the_cpu_path(dev, i):
    from lyricalignment_tpu_torch.decode.timestamps import apply_timestamp_rules

    gen = torch.Generator().manual_seed(i)
    logits = torch.randn(6, 88, generator=gen) * 3
    logits[2, 28:] += 6.0
    tokens = torch.where(torch.rand(6, 9, generator=gen) < 0.35,
                         28 + torch.randint(0, 60, (6, 9), generator=gen),
                         torch.randint(0, 20, (6, 9), generator=gen))
    a = apply_timestamp_rules(logits, tokens, i, ts_begin=28, eot=20)
    b = apply_timestamp_rules(logits.to(dev), tokens.to(dev), i, ts_begin=28, eot=20)
    assert torch.equal(b.cpu(), a)
