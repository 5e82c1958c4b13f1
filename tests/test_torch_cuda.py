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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq", [1, 50, 64, 130, 1500])
def test_bias_attention(dev, seq, dtype):
    from lyricalignment_tpu_torch.ops.attention import (
        einsum_bias_attention,
        onepass_self_attention,
    )

    g = _gen(seq)
    q, k, v = (torch.randn(2, seq, 3, 64, device=dev, generator=g).to(dtype) * 0.4
               for _ in range(3))
    bias = torch.randn(1, seq, device=dev, generator=g) * 0.5
    bias[0, seq - seq // 4:] = -1e9  # masked keys, never all of them
    got = onepass_self_attention(q, k, v, bias)
    ref = einsum_bias_attention(q, k, v, bias)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    else:
        rel = (got.double() - ref.double()).norm() / ref.double().norm()
        assert rel < 1e-2, float(rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("seq", [1, 63, 65, 200])
def test_attention_forward_and_backward(dev, seq, with_bias, dtype):
    """Forward with the row log-sum-exp, then the dK/dV and dQ kernels
    under autograd, against autograd through the plain float32 einsum:
    float32 atol 1e-4; bf16 rel-L2 1e-2 (bf16 inputs, P and dS rounded to
    bf16 before their products)."""
    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops.attention import (
        attention_forward,
        einsum_bias_attention,
        onepass_self_attention,
        self_attention,
    )

    g = _gen(seq + 7 * with_bias)
    q, k, v, dout = (torch.randn(2, seq, 3, 64, device=dev, generator=g) * 0.4
                     for _ in range(4))
    bias = torch.zeros(1, seq, device=dev)
    if with_bias:
        bias += torch.randn(1, seq, device=dev, generator=g) * 0.5
        bias[0, seq - seq // 4:] = -1e9  # masked keys, never all of them
    leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = (onepass_self_attention(*leaves, bias) if with_bias else self_attention(*leaves))
    out.backward(dout.to(dtype))
    assert dict(kernels.launches) == {"la_attention_fwd": 1, "la_attention_dkdv": 1,
                                      "la_attention_dq": 1}

    ref_leaves = [x.detach().float().requires_grad_() for x in leaves]
    ref = einsum_bias_attention(*ref_leaves, bias)
    ref.backward(dout.to(dtype).float())
    _, lse = attention_forward(*(x.detach() for x in leaves),
                               bias[0] if with_bias else None, with_lse=True)
    ref_lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", *(x.detach() for x in ref_leaves[:2]))
                              + bias[0], dim=-1)
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
