"""The port's package-level names: every name in a JAX subpackage's
``__all__`` resolves in the port's counterpart, and the pronunciation
table's ``vocab_size``, ``num_classes`` and ``classes_of_text`` equal the
JAX table's on the shipped asset (JAX ``tests/test_text_and_data.py:26-35``)."""

import importlib

import numpy as np
import pytest

SUBPACKAGES = ("ops", "models", "data", "text", "utils", "parallel", "decode")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_name_resolves_in_the_port(sub):
    jax_pkg = importlib.import_module(f"lyricalignment_tpu.{sub}")
    port_pkg = importlib.import_module(f"lyricalignment_tpu_torch.{sub}")
    assert sorted(port_pkg.__all__) == sorted(jax_pkg.__all__)
    for name in jax_pkg.__all__:
        assert getattr(port_pkg, name) is not None, name


def test_pronunciation_table_members_equal_jax():
    from lyricalignment_tpu.text.pinyin import load_pronunciation_table as jax_table
    from lyricalignment_tpu_torch.text import load_pronunciation_table

    ours, ref = load_pronunciation_table(), jax_table()
    assert ours.vocab_size == ref.vocab_size == 21128
    assert ours.num_classes == ref.num_classes
    vocab = {"你": 872, "好": 1962, "天": 1921, "地": 1765, "x": 100}
    for text in ("你好", "天地玄黄", "", "x好?"):
        np.testing.assert_array_equal(ours.classes_of_text(text, vocab),
                                      ref.classes_of_text(text, vocab))


def test_log_mel_spectrogram_takes_the_jax_argument_order():
    import torch

    from lyricalignment_tpu_torch.ops import log_mel_spectrogram
    from lyricalignment_tpu_torch.ops.mel import log_mel

    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8000))
                             .astype(np.float32))
    torch.testing.assert_close(log_mel_spectrogram(audio, 80, True),
                               log_mel(audio, per_sample_max=True, n_mels=80))
