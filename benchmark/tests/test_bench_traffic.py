"""The traffic generator repeats by seed, and every seed asks for the same
work."""

import filecmp
import os

from benchmark import traffic

PARAMS = {"pool_groups": 2, "per_group": 3, "seconds": [1.0, 2.0], "lyric_chars": [4, 8],
          "stereo_44k_share": 0.5, "alignment_share": 0.5}
SEED = 2 ** 31 + 12345


def test_same_seed_same_pool(tmp_path):
    a = traffic.write_pool(PARAMS, SEED, str(tmp_path / "a"))
    b = traffic.write_pool(PARAMS, SEED, str(tmp_path / "b"))
    assert [(r.seconds, r.lyric, r.sample_rate, r.onset_offset) for r in a] == \
           [(r.seconds, r.lyric, r.sample_rate, r.onset_offset) for r in b]
    for x, y in zip(a, b):
        assert filecmp.cmp(x.path, y.path, shallow=False)


def test_other_seed_same_sizes_other_content(tmp_path):
    a = traffic.write_pool(PARAMS, SEED, str(tmp_path / "a"))
    b = traffic.write_pool(PARAMS, SEED + 1, str(tmp_path / "b"))
    assert sorted(r.seconds for r in a) == sorted(r.seconds for r in b)
    assert sorted(len(r.lyric) for r in a) == sorted(len(r.lyric) for r in b)
    assert sum(r.sample_rate == 44100 for r in a) == sum(r.sample_rate == 44100 for r in b) == 3
    assert [r.lyric for r in a] != [r.lyric for r in b]


def test_call_plan_repeats_and_covers_the_pool():
    p1 = traffic.call_plan(PARAMS, SEED, 6, 4, 6)
    assert p1 == traffic.call_plan(PARAMS, SEED, 6, 4, 6)
    flat = [i for call in p1 for i in call]
    assert sorted(flat[:6]) == list(range(6)) and all(len(c) == 4 for c in p1)


def test_vocab_maps_the_characters_onto_real_syllables(tmp_path):
    from benchmark.reference.align import load_labels

    classes = load_labels(traffic.write_vocab(str(tmp_path)), traffic.TABLE_PATH)
    chars = list(dict.fromkeys(traffic.CHARS))
    got = classes("".join(chars))
    assert min(got) >= 2 and len(set(got)) >= 40     # class 1 is the "bad" bucket
    assert os.path.basename(traffic.TABLE_PATH).endswith(".json")
