"""The port's timestamp rules (``decode/timestamps.py``) against JAX's:
``apply_timestamp_rules`` on seeded logits and generated-token buffers
equals JAX's exactly at every decode index, and ``parse_segments`` passes
the cases of ``tests/test_longform.py`` and equals JAX's on seeded token
streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.decode.timestamps import apply_timestamp_rules as jax_rules
from lyricalignment_tpu.decode.timestamps import parse_segments as jax_parse
from lyricalignment_tpu_torch.decode.timestamps import apply_timestamp_rules, parse_segments
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

# whisper's special-token layout scaled down (tests/test_longform.py's)
EOT, TS_BEGIN, V = 20, 28, 88


def _gen_buffer(rng, n, t):
    """Rows mixing text and timestamp tokens, some ending on a single
    timestamp, some on a pair, some with timestamps that go backwards."""
    gen = rng.integers(0, EOT, (n, t))
    is_ts = rng.random((n, t)) < 0.35
    gen = np.where(is_ts, TS_BEGIN + rng.integers(0, V - TS_BEGIN, (n, t)), gen)
    gen[0, 1:3] = TS_BEGIN + 7           # a pair at positions 1-2
    gen[1, 2] = TS_BEGIN + 3             # a single timestamp at position 2
    gen[1, 1] = 5
    return gen.astype(np.int32)


@pytest.mark.parametrize("i", [0, 1, 2, 3, 5, 9])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_timestamp_rules_equals_jax(seed, i):
    rng = np.random.default_rng(seed)
    n, t = 6, 9
    logits = (rng.standard_normal((n, V)) * 3).astype(np.float32)
    logits[:, EOT + 1: TS_BEGIN] = -1e30          # the suppress mask first
    logits[2, TS_BEGIN:] += 6.0                   # timestamp mass wins: rule 5
    gen = _gen_buffer(rng, n, t)
    want = np.asarray(jax_rules(jnp.asarray(logits), jnp.asarray(gen), jnp.asarray(i),
                                ts_begin=TS_BEGIN, eot=EOT))
    got = apply_timestamp_rules(torch.from_numpy(logits), torch.from_numpy(gen).long(), i,
                                ts_begin=TS_BEGIN, eot=EOT)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rule5_timestamp_mass_compares_against_eot():
    n_ts = V - TS_BEGIN
    logits = np.full((1, V), -10.0, np.float32)
    logits[0, 5] = 2.0                      # best text token
    logits[0, EOT] = 4.0                    # best non-timestamp overall
    logits[0, TS_BEGIN:] = 3.0 - np.log(n_ts)
    gen = torch.full((1, 8), 5)
    out = apply_timestamp_rules(torch.from_numpy(logits), gen, 1, ts_begin=TS_BEGIN, eot=EOT)
    assert out[0, 5] > -1e29
    logits[0, EOT] = -10.0
    out = apply_timestamp_rules(torch.from_numpy(logits), gen, 1, ts_begin=TS_BEGIN, eot=EOT)
    assert out[0, 5] < -1e29


# ---------------------------------------------------------------------------
# parse_segments: the cases of tests/test_longform.py, then seeded streams
# ---------------------------------------------------------------------------

TS = 1000  # stand-in timestamp_begin for parser tests


def test_parse_segments_pairs():
    toks = [TS + 0, 5, 6, TS + 50, TS + 50, 7, TS + 100, TS + 100, 8]
    segs, adv = parse_segments(toks, seek=0, segment_size=3000, ts_begin=TS)
    assert len(segs) == 2
    assert segs[0]["start"] == 0.0 and segs[0]["end"] == 1.0
    assert segs[1]["start"] == 1.0 and segs[1]["end"] == 2.0
    assert adv == 200


def test_parse_segments_single_ending():
    toks = [TS + 0, 5, TS + 50, TS + 50, 6, TS + 120]
    segs, adv = parse_segments(toks, seek=100, segment_size=3000, ts_begin=TS)
    assert len(segs) == 2
    assert segs[0]["start"] == pytest.approx(1.0)
    assert segs[1]["end"] == pytest.approx(1.0 + 2.4)
    assert adv == 3000


def test_parse_segments_no_pairs():
    segs, adv = parse_segments([TS + 10, 4, 5, 6], seek=0, segment_size=1500, ts_begin=TS)
    assert len(segs) == 1 and segs[0]["start"] == 0.0
    assert segs[0]["end"] == pytest.approx(0.2)
    assert adv == 1500
    segs, adv = parse_segments([4, 5, 6], seek=0, segment_size=1500, ts_begin=TS)
    assert segs[0]["end"] == pytest.approx(15.0) and adv == 1500
    segs, adv = parse_segments([TS + 10, 4, 5, TS + 200], seek=0, segment_size=1500,
                               ts_begin=TS)
    assert segs[0]["end"] == pytest.approx(4.0) and adv == 1500


@pytest.mark.parametrize("seed", range(4))
def test_parse_segments_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(0, 14))
        toks = np.where(rng.random(n) < 0.4, TS + np.sort(rng.integers(0, 1500, n)),
                        rng.integers(0, 50, n)).tolist()
        seek, size = int(rng.integers(0, 9000)), int(rng.integers(1, 3001))
        assert parse_segments(toks, seek, size, ts_begin=TS) == \
            jax_parse(toks, seek, size, ts_begin=TS)
