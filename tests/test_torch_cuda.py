"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path can reach: ragged last tiles, sequences
shorter than a tile, 128 mel bands, K = 257 Viterbi states, zero-frame and
zero-label rows, the CTC column slice. ``chip_smoke.py`` covers the main
path's own shapes. On a machine with an NVIDIA GPU (the repository's
tests/conftest.py needs JAX, which such a machine may lack):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without a CUDA device every test here skips: a CUDA kernel has no CPU mode.
"""

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
