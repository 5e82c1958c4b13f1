"""The plain reference against the port's CPU path (its plain kernel
versions) at tiny sizes, on the benchmark's own weights: the log-mel, the
encoder and the GRU head at exact lengths."""

import pytest
import torch

from benchmark import program, weights
from benchmark.reference import audio as ref_audio
from benchmark.reference import model as ref_model

SEED = 2 ** 31 + 77


@pytest.fixture
def f32_cfg(tiny_cfg):
    cfg = dict(tiny_cfg)
    cfg["precision"] = dict(tiny_cfg["precision"], compute="float32", resident="float32")
    return cfg


@pytest.fixture
def built(f32_cfg):
    w = weights.make_weights(f32_cfg, SEED, "cpu", "float32", classifier_scale=8.0)
    model = program.build(f32_cfg, w, torch.device("cpu"), serving=False)
    return w, model


def _audio(n=2, seconds=3.0):
    g = torch.Generator().manual_seed(3)
    return torch.randn(n, int(seconds * 16000), generator=g) * 0.1


def test_weights_match_the_port_state_dict(tiny_cfg):
    from lyricalignment_tpu_torch.models.align_model import AlignModel

    mcfg = program.model_config(tiny_cfg, serving=True)
    want = {k: tuple(v.shape) for k, v in AlignModel(mcfg).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in weights.make_weights(tiny_cfg, SEED, "cpu", "bfloat16").items()}
    assert got == want


def test_same_seed_same_weights(tiny_cfg):
    a = weights.make_weights(tiny_cfg, SEED, "cpu", "bfloat16")
    b = weights.make_weights(tiny_cfg, SEED, "cpu", "bfloat16")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["whisper_model.encoder.blocks.0.attn.query.weight"].dtype == torch.bfloat16
    assert a["whisper_model.decoder.token_embedding.weight"].dtype == torch.float32


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel(n_mels):
    from lyricalignment_tpu_torch.ops.mel import log_mel

    a = _audio()
    torch.testing.assert_close(ref_audio.log_mel(a, n_mels), log_mel(a, n_mels=n_mels),
                               atol=2e-4, rtol=0)


def test_encoder(f32_cfg, built):
    from lyricalignment_tpu_torch.models.whisper import encode_audio
    from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim

    w, model = built
    p = ref_model.Weights(w)
    with torch.no_grad():
        mel = pad_or_trim(log_mel(_audio(), n_mels=f32_cfg["n_mels"]), 3000)
        got = encode_audio(model.whisper_model, mel)
        want = ref_model.encode(p, f32_cfg, mel, fast=True)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


def test_gru_head_at_exact_lengths(f32_cfg, built):
    from lyricalignment_tpu_torch.models.align_head import align_head_hidden

    w, model = built
    x = torch.randn(3, 40, f32_cfg["n_audio_state"], generator=torch.Generator().manual_seed(1))
    lengths = [40, 31, 17]
    with torch.no_grad():
        got = align_head_hidden(model.align_rnn, x, torch.tensor(lengths))
        want = ref_model.head_hidden(ref_model.Weights(w), f32_cfg, x, lengths)
    for b, n in enumerate(lengths):
        torch.testing.assert_close(got[b, :n], want[b, :n], atol=2e-5, rtol=1e-5)
