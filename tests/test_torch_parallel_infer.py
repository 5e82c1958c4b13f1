"""Meshed inference of the port on gloo ranks spawned on the CPU, the cases
of JAX ``tests/test_parallel_infer.py``: the alignment CLI's
``align_records`` on six records in batches of 4 (one full batch, one
ragged) under data=2, model=2 and data=2 x model=2 equals the
single-process port and JAX's single-device ``align_records`` at JAX's
``atol=1e-4``; the int8 encoder under model=2 (resident weights, and weights
quantised per call, whose absmax is all-reduced too) gives the
single-process int8 encoder output; a batch the data axis does not divide
exits; batched transcription under 2 x 2 (2 windows padded to a batch of
4, beam 2, 8 new tokens, the vocabulary sharded) gives single-device JAX's
tokens."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from lyricalignment_tpu.cli.inference_alignment import align_records as jax_align_records
from lyricalignment_tpu.cli.inference_transcript import transcribe_records as jax_transcribe
from lyricalignment_tpu.data.records import Record as JaxRecord
from lyricalignment_tpu_torch.data.audio_io import write_wav
from tests import torch_parallel_helpers as tph
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model, with_whisper

# head dim 64, as every Whisper size has it
DIMS = dict(n_audio_state=256, n_audio_head=4, n_audio_layer=1, n_text_state=256,
            n_text_head=4, n_text_layer=1, n_vocab=64)
TR_DIMS = dict(DIMS, n_vocab=tph.TinyTokenizer.n_vocab, n_text_ctx=64)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    wavs = []
    for i in range(6):  # 6 records, batch 4 -> a full batch + a ragged one
        wavs.append(str(d / f"r{i}.wav"))
        write_wav(wavs[-1], (rng.standard_normal(int((3.0 + 0.7 * i) * 16000)) * 0.1)
                  .astype(np.float32))
    tr_wavs = []
    for i in range(2):
        tr_wavs.append(str(d / f"t{i}.wav"))
        write_wav(tr_wavs[-1], (rng.standard_normal(4 * 16000) * 0.1).astype(np.float32))

    cfg, params = jax_tiny_model(dims=DIMS, output_dim=tph.N_CLASSES + 1, fc_scale=4.0)
    model = torch_model(cfg, params)
    int8 = torch_model(with_whisper(cfg, int8_encoder=True), params)
    tcfg, tparams = jax_tiny_model(dims=TR_DIMS, seed=5)
    whisper = torch_model(tcfg, tparams).whisper_model
    payload = {"wavs": wavs, "tr_wavs": tr_wavs,
               "fp32": (model.cfg, tph.numpy_dict(model.state_dict())),
               "int8": (int8.cfg, tph.numpy_dict(int8.state_dict())),
               "whisper": (whisper.cfg, tph.numpy_dict(whisper.state_dict())),
               "mel": rng.standard_normal((2, 80, 3000)).astype(np.float32)}

    jax_args = SimpleNamespace(**vars(tph.align_args()))
    jax_segments = [seg for _, seg in jax_align_records(
        [JaxRecord(audio_path=w, text="abcde") for w in wavs], as_jax(params), cfg,
        tph.StubTable(), tph.StubBert(), jax_args)]
    tr_args = SimpleNamespace(is_mixture=0, batch_size=4, beam_size=2, max_new_tokens=8,
                              use_groundtruth=False, temperature_fallback=False,
                              fast_windows=False, length_penalty=None,
                              no_condition_on_previous_text=False, seed=0)
    jax_tokens = [r["inference"] for r in jax_transcribe(
        [JaxRecord(audio_path=w, text="") for w in tr_wavs], as_jax(tparams["whisper"]),
        tcfg.whisper, tph.TinyTokenizer(), tr_args)]

    with torch.no_grad():
        single_int8 = tph.int8_model(*payload["int8"])
        int8_enc = single_int8.whisper_model.embed_audio(torch.tensor(payload["mel"])).numpy()
    single = {"align": tph.align_segments(model, wavs),
              "int8_segments": tph.align_segments(single_int8, wavs),
              "int8_encoder": int8_enc,
              "tokens": tph.transcribe_tokens(whisper, whisper.cfg, payload)}
    return payload, single, jax_segments, jax_tokens


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    return tph.run_ranks(tph.align_checks, 2, tmp_path_factory.mktemp("w2"), setup[0])


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    return tph.run_ranks(tph.align_transcribe_2x2, 4, tmp_path_factory.mktemp("w4"), setup[0])


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4)


def test_single_process_port_matches_jax(setup):
    _, single, jax_segments, jax_tokens = setup
    _close(single["align"], jax_segments)
    assert single["tokens"] == jax_tokens


@pytest.mark.parametrize("case", ["data2", "model2"])
def test_mesh_alignment_matches_single(setup, world2, case):
    _, single, jax_segments, _ = setup
    for out in world2:
        _close(out[case], single["align"])
        _close(out[case], jax_segments)


def test_mesh_dp_tp_alignment_matches_single(setup, world4):
    _, single, jax_segments, _ = setup
    for out in world4:
        _close(out["align"], single["align"])
        _close(out["align"], jax_segments)


@pytest.mark.parametrize("weights", ["int8_resident", "int8_dynamic"])
def test_int8_encoder_under_tensor_parallelism(setup, world2, weights):
    """The row-parallel int8 linears all-reduce the activation absmax (and a
    per-call weight's) with MAX and sum the int32 partial products, so the
    quantisation steps are the single process's."""
    _, single, _, _ = setup
    for out in world2:
        np.testing.assert_allclose(out[weights], single["int8_encoder"], rtol=1e-5, atol=1e-5)
        _close(out["int8_segments"], single["int8_segments"])


def test_mesh_batch_divisibility_enforced(world2):
    assert "divisible" in world2[0]["exit"] and "divisible" in world2[1]["exit"]


def test_mesh_transcribe_matches_single(setup, world4):
    """2 windows padded to a batch of 4 over 2 x 2: each data rank decodes
    one real row and one pad row; the vocab-sharded logits are gathered
    before beam selection."""
    _, single, _, jax_tokens = setup
    for out in world4:
        assert out["tokens"] == single["tokens"] == jax_tokens
