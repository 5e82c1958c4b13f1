"""The port's cached decoding against the benchmark's plain float32 decoder
(``benchmark/reference/decoder.py``), on the benchmark's seeded weights at
a tiny width, in float32 on the CPU: the prime and each cached step give
the teacher-forced logits of every row; ``beam_search``'s ``avg_logprob``
is the reference's score of the tokens it returns, every one of which lies
among the reference's best beam + 1 at its prefix; ``transcribe_records``
reports one such score a window, in window order.

Tolerances: both sides compute in float32 with the products in another
order (the cache's split prompt and generated attention, the heads' q and k
each scaled by d_h^-0.25), so logits of magnitude ~1 agree to ~1e-6 and are
held to 2e-5; a score averages log-probabilities of magnitude ~11, held to
1e-4; ``transcribe_records`` adds the port's log-mel and encoder (2e-4 on
the features, ``benchmark/tests/test_bench_reference.py``), held to 1e-3.
"""

import numpy as np
import pytest
import torch

from benchmark import program, weights
from benchmark.reference import decoder as ref
from benchmark.reference.model import Weights
from benchmark.reference.transcribe import judge_calls
from lyricalignment_tpu_torch.decode.beam import beam_search, make_processor
from lyricalignment_tpu_torch.models.whisper import (
    decode_step,
    init_decode_cache,
    prime_decode_cache,
)

SEED = 2 ** 31 + 2121
CFG = {"n_mels": 80, "n_vocab": 51865, "n_audio_ctx": 1500, "n_audio_state": 64,
       "n_audio_head": 2, "n_audio_layer": 1, "n_text_ctx": 32, "n_text_state": 64,
       "n_text_head": 2, "n_text_layer": 2,
       # the head `cli.common.build_model_config` fixes (built, never run here)
       "head": {"hidden_dim": 384, "num_rnn_layers": 2, "bidirectional": True,
                "output_dim": 21129, "vocab_size": 21128, "dropout": 0.1},
       "precision": {"compute": "float32", "resident": "float32", "fast_gelu": True,
                     "head": "float32"}}
PROMPT = ref.prompt_ids(CFG["n_vocab"], "zh")


@pytest.fixture(scope="module")
def built():
    torch.manual_seed(0)
    w = weights.make_weights(CFG, SEED, "cpu", "float32")
    model = program.build(CFG, w, torch.device("cpu"), serving=True)
    feats = torch.randn(2, CFG["n_audio_ctx"], CFG["n_audio_state"],
                        generator=torch.Generator().manual_seed(1))
    return Weights(w), model.whisper_model, model.cfg.whisper, feats


@pytest.mark.parametrize("beam", [1, 5])
def test_cached_steps_match_the_full_forward(built, beam):
    p, whisper, wcfg, feats = built
    b, n = feats.shape[0], 6
    gen = torch.randint(0, ref.EOT, (b * beam, n), generator=torch.Generator().manual_seed(2))
    prompt = torch.tensor([PROMPT] * b)
    full = torch.cat([torch.tensor(PROMPT).expand(b * beam, -1), gen], dim=1)
    with torch.no_grad():
        want = ref.logits(p, CFG, full, feats, rows_per_audio=beam)     # [b*beam, P+n, V]
        cache = init_decode_cache(whisper, wcfg, feats, len(PROMPT), n, beam_size=beam)
        logits0, _, cache = prime_decode_cache(whisper, wcfg, prompt, cache)
        torch.testing.assert_close(logits0, want[::beam, len(PROMPT) - 1], atol=2e-5, rtol=0)
        for s in range(n):
            got, cache = decode_step(whisper, wcfg, gen[:, s:s + 1], cache)
            torch.testing.assert_close(got, want[:, len(PROMPT) + s], atol=2e-5, rtol=0)


def _ref_scores(p, feats, tokens, beam, max_new):
    """(avg_logprob, beam shortfall) of each row's returned tokens under the
    reference's processing."""
    mask = ref.suppress_mask(CFG["n_vocab"])
    out = []
    for j, row in enumerate(tokens.tolist()):
        ids = [t for t in row if t != ref.EOT]
        seq = ids + [ref.EOT] if len(ids) < max_new else ids
        lp = ref.log_probs(p, CFG, PROMPT, torch.tensor([seq]), feats[j:j + 1], mask)[0]
        tok = lp.gather(1, torch.tensor(seq)[:, None])[:, 0].double()
        kth = lp.topk(beam + 1, dim=-1).values[:, -1].double()
        out.append((float(tok.sum()) / (len(ids) + 1), float((kth - tok).max())))
    return out


@pytest.mark.parametrize("beam,max_new", [(2, 8), (5, 6)])
def test_beam_score_and_shortfall(built, beam, max_new):
    p, whisper, wcfg, feats = built
    prompt = torch.tensor([PROMPT] * feats.shape[0])
    tokens, avg = beam_search(whisper, wcfg, feats, prompt, beam_size=beam,
                              max_new_tokens=max_new, eot=ref.EOT)
    with torch.no_grad():
        got = _ref_scores(p, feats, tokens, beam, max_new)
    torch.testing.assert_close(avg.double(), torch.tensor([g[0] for g in got], dtype=torch.float64),
                               atol=1e-4, rtol=0)
    # every returned token was among its parent's best beam + 1: 0 but rounding
    assert max(g[1] for g in got) <= 2e-5


def test_suppress_mask_is_the_processors():
    """The reference's mask from the published layout equals the port's
    processor's (no BPE file: no non-speech ids)."""
    logits = torch.zeros(1, CFG["n_vocab"])
    process = make_processor(program.model_config(CFG, serving=True).whisper, ref.EOT)
    port = process(logits, None, 1)[0] < -1e29
    assert torch.equal(port, torch.isinf(ref.suppress_mask(CFG["n_vocab"])))
    assert ref.prompt_ids(51866, "zh") == [50258, 50260, 50360, 50364]


def test_transcribe_records_scores_each_window_in_order(built, tmp_path):
    from types import SimpleNamespace

    from lyricalignment_tpu_torch.cli.inference_transcript import transcribe_records
    from lyricalignment_tpu_torch.data.audio_io import write_wav
    from lyricalignment_tpu_torch.data.records import Record
    from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    p, whisper, wcfg, _ = built
    rng = np.random.default_rng(4)
    path = str(tmp_path / "song.wav")
    t = np.arange(40 * 16000) / 16000
    write_wav(path, (0.2 * np.sin(2 * np.pi * 220 * t) * (t > 30)
                     + 0.05 * rng.standard_normal(t.shape)).astype(np.float32))
    args = SimpleNamespace(is_mixture=0, batch_size=2, beam_size=3, max_new_tokens=6,
                           use_groundtruth=False, temperature_fallback=False, fast_windows=True,
                           length_penalty=None, patience=None,
                           no_condition_on_previous_text=False, seed=0, decode_group=1)
    (out,) = transcribe_records([Record(audio_path=path, text="")], whisper, wcfg,
                                WhisperTokenizer(), args)
    assert len(out["avg_logprob"]) == 2
    call = {"paths": [path], "texts": [out["inference"]], "scores": [out["avg_logprob"]]}
    got = judge_calls(p.w, CFG, [call], "zh", beam=3, max_new=6, batch_size=2)
    assert got["invalid"] == [0, 0] and max(got["gap"]) <= 1e-3
    assert max(got["shortfall"]) <= 1e-3
    # the two windows' scores swapped fail the same tolerance
    swapped = dict(call, scores=[out["avg_logprob"][::-1]])
    assert min(judge_calls(p.w, CFG, [swapped], "zh", 3, 6, 2)["gap"]) > 1e-3


@pytest.mark.parametrize("calls", [1, 2, 5])
def test_cpu_steps_run_without_a_graph(built, calls):
    """Off the card every step of a loop is :func:`decode_step` itself: no
    graph is captured, and the stepper's logits and cache are the step's."""
    from lyricalignment_tpu_torch.decode import beam as beam_mod

    _, whisper, wcfg, feats = built
    tok = torch.full((feats.shape[0], 1), 7)
    assert not beam_mod._graphable(whisper, tok)
    with torch.no_grad():
        caches = []
        for _ in range(2):
            cache = init_decode_cache(whisper, wcfg, feats, len(PROMPT), calls)
            _, _, cache = prime_decode_cache(whisper, wcfg, torch.tensor([PROMPT] * 2), cache)
            caches.append(cache)
        step = beam_mod._Stepper(whisper, wcfg, caches[0])
        for _ in range(calls):
            got, cache = step(tok)
            want, _ = decode_step(whisper, wcfg, tok, caches[1])
            assert cache is caches[0] and torch.equal(got, want)
    assert step.graph is None and int(cache["step"]) == calls
