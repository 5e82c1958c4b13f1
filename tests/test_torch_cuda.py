"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path can reach: ragged last tiles, sequences
shorter than a tile, 128 mel bands, K = 257 Viterbi states, zero-frame and
zero-label rows, the CTC column slice, and the attention backward with and
without a key bias. ``chip_smoke.py`` covers the main
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


def test_bias_attention_refuses_other_head_widths(dev):
    from lyricalignment_tpu_torch.ops.attention import onepass_self_attention

    x = torch.zeros(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        onepass_self_attention(x, x, x, torch.zeros(1, 8, device=dev))


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


@pytest.mark.parametrize("frames,l_max", [(37, 5), (300, 128)])
def test_viterbi_exact(dev, frames, l_max):
    from lyricalignment_tpu_torch.ops.viterbi import viterbi_dp, viterbi_dp_plain

    g = _gen(frames)
    b = 5
    logp = torch.log_softmax(torch.randn(b, frames, l_max + 1, device=dev, generator=g) * 3, -1)
    lab = logp[..., :l_max].clamp(min=-1000.0).contiguous()
    sil = logp[..., l_max].clamp(min=-1000.0).contiguous()
    labels = torch.randint(1, 6, (b, l_max), device=dev, generator=g, dtype=torch.int32)
    nl = torch.tensor([l_max, 3, 0, 1, l_max], dtype=torch.int32, device=dev)
    nf = torch.tensor([frames, frames // 2, 0, 1, frames + 7], dtype=torch.int32, device=dev)
    got = viterbi_dp(lab, sil, labels, nl, nf)
    ref = viterbi_dp_plain(lab, sil, labels, nl, nf)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
