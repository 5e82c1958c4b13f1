"""The work counts at whisper-medium's alignment shapes, as
the port's kernel table counts them."""

import pytest

from benchmark import roofline as r
from benchmark.reference.audio import mel_filters


def test_attention_forward_serving():
    ops, peak, _ = r.attention_forward_work(16, 1500, 16)
    assert ops == pytest.approx(147.456e9) and peak == r.PEAK_BF16
    assert r.attention_forward(16, 1500, 16) * 1e3 == pytest.approx(0.1491, abs=1e-4)


def test_log_mel_bytes_bound():
    nnz = int((mel_filters(80) != 0).sum())
    ops, _, nbytes = r.log10_mel_work(16, 480400, 3000, 80, nnz)
    assert nbytes / 1e6 == pytest.approx(46.1, abs=0.05)
    assert r.log10_mel(16, 480400, 3000, 80, nnz) * 1e3 == pytest.approx(0.0138, abs=1e-4)


def test_row_lse_by_the_3xtf32_route():
    ops, peak, _ = r.row_lse_work(16 * 1500, 768, 21127)
    assert ops / 1e9 == pytest.approx(2336.5, abs=0.1) and peak == r.PEAK_TF32
    assert r.row_lse(24000, 768, 21127) * 1e3 == pytest.approx(4.72, abs=0.01)


def test_whole_call_flops():
    cfg = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 1024, "n_audio_layer": 24,
           "head": {"hidden_dim": 384, "bidirectional": True, "num_rnn_layers": 2}}
    enc = r.encoder_flops(cfg, 16) / 1e12
    head = r.head_flops(cfg, 16, 1500, 21127) / 1e12
    assert 17 < enc < 19.5 and 0.9 < head < 1.2
    assert r.mfu(989e12, 1.0) == pytest.approx(100.0)
