"""The port's decode loops (``decode/beam.py``) against the JAX loops and
against the numpy beam oracle of ``tests/test_beam_oracle.py``.

- greedy, beam and sampled tokens equal the JAX entry points' on a seeded
  tiny model fed the same audio features; the sampled run gives both sides
  the same Gumbel noise (JAX's own draws, replayed into the port);
- ``beam_loop`` through the oracle test's hash-chained fake model equals
  the oracle over its seeds, budgets, length penalties and patience values
  (patience < 1, all-finish-early, never-finish), where suppressed and
  integer logits tie often;
- ``group`` 1, 2 and 4 give equal tokens, and ``group < 1`` raises;
- batch independence and special-token suppression, as
  ``tests/test_decode.py`` checks them for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.decode import beam as jax_beam
from lyricalignment_tpu.decode.transcribe import sample_decode as jax_sample_decode
from lyricalignment_tpu_torch.decode import beam as beam_mod
from lyricalignment_tpu_torch.decode.transcribe import sample_decode
from tests.test_beam_oracle import (
    CASES,
    HASH_MOD,
    HASH_MUL,
    make_table,
    oracle_for_table,
)
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

EOT = 30  # small-vocab stand-in for <|endoftext|>; specials are ids >= EOT
MAX_NEW = 10
DIMS = dict(n_vocab=40, n_audio_ctx=50, n_text_ctx=32, n_text_layer=2)


@pytest.fixture(scope="module")
def tiny():
    cfg, params = jax_tiny_model(seed=3, dims=DIMS)
    model = torch_model(cfg, params).whisper_model
    rng = np.random.default_rng(114514)
    xa = (rng.standard_normal((3, 50, 64)) * 2.0).astype(np.float32)
    prompt = np.array([[EOT + 1, EOT + 2]] * 3, np.int32)
    return cfg.whisper, as_jax(params)["whisper"], model, xa, prompt


def _t(x):
    return torch.from_numpy(np.asarray(x))


SAMPLE_T = 0.9


def _jax_gumbel_draws(seed, b, n):
    """The noise JAX's ``sample_loop`` draws: ``categorical(sub, l / T)`` is
    ``argmax(gumbel(sub) + l / T)``, with ``sub`` split off the key once
    before the first pick and once a step."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    draws = []
    for _ in range(n):
        draws.append(np.asarray(jax.random.gumbel(sub, (b, DIMS["n_vocab"]), jnp.float32)))
        key, sub = jax.random.split(key)
    return draws


@pytest.fixture(scope="module")
def jax_runs(tiny):
    jcfg, jparams, _, xa, prompt = tiny
    xa_j, pr_j = jnp.asarray(xa), jnp.asarray(prompt)
    beam_cases = {
        "k4": dict(beam_size=4),
        "k5_patience": dict(beam_size=5, patience=0.6),
    }
    sampled, sum_lp = jax_sample_decode(jparams, jcfg, xa_j, pr_j, jax.random.PRNGKey(7),
                                        temperature=SAMPLE_T, max_new_tokens=MAX_NEW, eot=EOT)
    return {
        "greedy": np.asarray(jax_beam.greedy_decode(jparams, jcfg, xa_j, pr_j,
                                                    max_new_tokens=MAX_NEW, eot=EOT)),
        "beam": {name: tuple(np.asarray(x) for x in jax_beam.beam_search(
            jparams, jcfg, xa_j, pr_j, max_new_tokens=MAX_NEW, eot=EOT, **kw))
            for name, kw in beam_cases.items()},
        "beam_kw": beam_cases,
        "sample": (np.asarray(sampled), np.asarray(sum_lp)),
    }


def test_greedy_matches_jax(tiny, jax_runs):
    _, _, model, xa, prompt = tiny
    got = beam_mod.greedy_decode(model, model.cfg, _t(xa), _t(prompt),
                                 max_new_tokens=MAX_NEW, eot=EOT)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_runs["greedy"])


@pytest.mark.parametrize("name", ["k4", "k5_patience"])
def test_beam_matches_jax(tiny, jax_runs, name):
    _, _, model, xa, prompt = tiny
    toks, avg = beam_mod.beam_search(model, model.cfg, _t(xa), _t(prompt),
                                     max_new_tokens=MAX_NEW, eot=EOT,
                                     **jax_runs["beam_kw"][name])
    want_toks, want_avg = jax_runs["beam"][name]
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_allclose(avg.numpy(), want_avg, atol=1e-5, rtol=0)


def test_sampling_matches_jax_under_shared_noise(tiny, jax_runs, monkeypatch):
    _, _, model, xa, prompt = tiny
    draws = iter(_jax_gumbel_draws(7, 3, MAX_NEW))
    monkeypatch.setattr(beam_mod, "gumbel_noise",
                        lambda shape, generator, device: torch.tensor(next(draws)))
    toks, sum_lp = sample_decode(model, model.cfg, _t(xa), _t(prompt), torch.Generator(),
                                 temperature=SAMPLE_T, max_new_tokens=MAX_NEW, eot=EOT)
    want_toks, want_lp = jax_runs["sample"]
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_allclose(sum_lp.numpy(), want_lp, atol=1e-4, rtol=0)
    assert len(set(map(tuple, want_toks.tolist()))) > 1   # the draws differ by row


def test_gumbel_noise_is_standard_gumbel():
    g = torch.Generator().manual_seed(0)
    x = beam_mod.gumbel_noise((200_000,), g, "cpu")
    assert torch.isfinite(x).all()
    assert abs(x.mean().item() - 0.5772) < 0.01          # Euler-Mascheroni
    assert abs(x.var().item() - np.pi ** 2 / 6) < 0.03
    again = beam_mod.gumbel_noise((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(x, again)


# ---------------------------------------------------------------------------
# the numpy oracle through the hash-chained fake model
# ---------------------------------------------------------------------------

def _fake_beam(table, h0s, k, max_new, eot, monkeypatch, length_penalty=None,
               patience=None, group=1):
    """beam_loop over the oracle test's fake model: logits depend on the
    whole token history through a rolling hash held in the cache, so a
    wrong beam-row gather changes the tokens."""
    table_t = torch.from_numpy(table)

    def fake_decode_step(model, cfg, tok, cache):
        h = (cache["blocks"][0]["h"] * HASH_MUL + tok[:, 0]) % HASH_MOD
        return table_t[h], {"blocks": [{"h": h}]}

    monkeypatch.setattr(beam_mod, "decode_step", fake_decode_step)
    h0 = torch.from_numpy(np.repeat(np.array(h0s, np.int64), k))
    toks, avg = beam_mod.beam_loop(None, None, table_t[h0], {"blocks": [{"h": h0}]},
                                   lambda l, g, i: l, k, max_new, eot, length_penalty,
                                   patience, group=group)
    return toks.numpy(), avg.numpy()


@pytest.mark.parametrize("seed,k,max_new,lp,patience", CASES)
def test_beam_loop_matches_whisper_oracle(seed, k, max_new, lp, patience, monkeypatch):
    vocab, eot = 16, 15
    table = make_table(seed, vocab, eot)
    h0s = [(seed * 7 + s * 13 + 1) % HASH_MOD for s in range(3)]
    toks, avg = _fake_beam(table, h0s, k, max_new, eot, monkeypatch, lp, patience)
    for s, h0 in enumerate(h0s):
        want_toks, want_avg = oracle_for_table(table, h0, k, max_new, eot,
                                               length_penalty=lp, patience=patience)
        assert toks[s].tolist() == want_toks, (s, toks[s].tolist(), want_toks)
        np.testing.assert_allclose(avg[s], want_avg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["all_finish_early", "never_finish"])
def test_beam_loop_matches_oracle_edge_cases(case, monkeypatch):
    vocab, eot = 8, 7
    if case == "all_finish_early":   # the finished set fills on the first steps
        rng = np.random.default_rng(42)
        table = rng.integers(-2, 3, size=(HASH_MOD, vocab)).astype(np.float32)
        table[:, eot] += 4.0
        h0, k, max_new = 5, 3, 10
    else:                            # budget exhaustion + finalize padding only
        rng = np.random.default_rng(43)
        table = rng.integers(-3, 4, size=(HASH_MOD, vocab)).astype(np.float32)
        table[:, eot] = -50.0
        h0, k, max_new = 11, 4, 8
    toks, avg = _fake_beam(table, [h0], k, max_new, eot, monkeypatch)
    want_toks, want_avg = oracle_for_table(table, h0, k, max_new, eot)
    assert toks[0].tolist() == want_toks
    np.testing.assert_allclose(avg[0], want_avg, rtol=1e-5)


def test_beam_loop_ties_under_suppression(monkeypatch):
    """Suppressed columns (NEG_INF added) tie exactly; with only two
    allowed tokens beyond eot the top-(k+1) of every row reaches into them,
    and the lower index must come first, as in the oracle's stable sort."""
    vocab, eot = 12, 7
    table = make_table(21, vocab, eot)
    suppressed = table.copy()
    suppressed[:, [0, 1, 2, 3, 4, 9, 10, 11]] += beam_mod.NEG_INF
    h0s = [3, 500]
    toks, avg = _fake_beam(suppressed, h0s, 5, 9, eot, monkeypatch)
    for s, h0 in enumerate(h0s):
        want_toks, want_avg = oracle_for_table(suppressed, h0, 5, 9, eot)
        assert toks[s].tolist() == want_toks
        np.testing.assert_allclose(avg[s], want_avg, rtol=1e-5)


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_fake_beam_equals_ungrouped(group, monkeypatch):
    table = make_table(10, 16, 15)
    base = _fake_beam(table, [4, 77, 300], 5, 12, 15, monkeypatch, patience=0.6)
    got = _fake_beam(table, [4, 77, 300], 5, 12, 15, monkeypatch, patience=0.6,
                     group=group)
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])


# ---------------------------------------------------------------------------
# properties on the real tiny model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [2, 4])
def test_grouped_decode_equals_ungrouped(tiny, group):
    _, _, model, xa, prompt = tiny
    args = (model, model.cfg, _t(xa), _t(prompt))
    kw = dict(max_new_tokens=MAX_NEW, eot=EOT)
    np.testing.assert_array_equal(beam_mod.greedy_decode(*args, group=group, **kw).numpy(),
                                  beam_mod.greedy_decode(*args, **kw).numpy())
    for bkw in (dict(beam_size=3), dict(beam_size=5, patience=0.6)):
        got = beam_mod.beam_search(*args, group=group, **bkw, **kw)
        want = beam_mod.beam_search(*args, **bkw, **kw)
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("bad", [0, -1])
def test_group_below_one_raises(tiny, bad):
    _, _, model, xa, prompt = tiny
    args = (model, model.cfg, _t(xa), _t(prompt))
    with pytest.raises(ValueError, match="group"):
        beam_mod.greedy_decode(*args, max_new_tokens=4, eot=EOT, group=bad)
    with pytest.raises(ValueError, match="group"):
        beam_mod.beam_search(*args, beam_size=2, max_new_tokens=4, eot=EOT, group=bad)


def test_beam_batch_independence(tiny):
    _, _, model, xa, prompt = tiny
    kw = dict(beam_size=3, max_new_tokens=6, eot=EOT)
    both, _ = beam_mod.beam_search(model, model.cfg, _t(xa), _t(prompt), **kw)
    solo, _ = beam_mod.beam_search(model, model.cfg, _t(xa[1:2]), _t(prompt[1:2]), **kw)
    np.testing.assert_array_equal(both[1].numpy(), solo[0].numpy())


def test_specials_and_begin_ids_are_suppressed(tiny):
    _, _, model, xa, prompt = tiny
    args = (model, model.cfg, _t(xa), _t(prompt))
    out = beam_mod.greedy_decode(*args, max_new_tokens=8, eot=EOT)
    assert (out <= EOT).all()
    beam, _ = beam_mod.beam_search(*args, beam_size=3, max_new_tokens=8, eot=EOT,
                                   suppress_ids=(3, 5))
    assert (beam <= EOT).all() and not torch.isin(beam, torch.tensor([3, 5])).any()
    first = out[:, 0]
    sup = beam_mod.greedy_decode(*args, max_new_tokens=8, eot=EOT,
                                 begin_suppress_ids=tuple(first.tolist()))
    assert not torch.isin(sup[:, 0], first).any()


def test_beam_size_1_equals_greedy(tiny):
    _, _, model, xa, prompt = tiny
    args = (model, model.cfg, _t(xa), _t(prompt))
    greedy = beam_mod.greedy_decode(*args, max_new_tokens=6, eot=EOT)
    beam, _ = beam_mod.beam_search(*args, beam_size=1, max_new_tokens=6, eot=EOT)
    np.testing.assert_array_equal(beam.numpy(), greedy.numpy())
