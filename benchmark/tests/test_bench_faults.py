"""The whole run on the CPU at a tiny size (the harness's look for a card
skipped), sound and with the timed path broken underneath: a sound run is
correct, and each fault a cell can have comes out not correct under the
cell's own limits. Also: without a card the command prints no result."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness

SEED = 2 ** 31 + 4242
# the cells' traffic mixes, cut to a tiny size
TRAFFIC = {"align-medium": "align-16x30s"}
SMALL = {
    "align-medium": {"pool_groups": 1, "per_group": 4, "seconds": [3.0, 4.5],
                     "lyric_chars": [4, 8], "requests_per_call": 4, "batch_size": 4,
                     "warm_calls": 1, "check_calls": 2},
}


def result(cell, tiny_cfg, tmp_path, capfd, control=None):
    """The result line of a small run of ``cell`` on the CPU."""
    bench = harness.spec()
    params = dict(harness.load_json(harness.HERE, "traffic", f"{TRAFFIC[cell]}.json"), **SMALL[cell])
    ctx = harness.Context(cell=cell, cfg=tiny_cfg, traffic=params,
                          limits=harness.load_json(harness.HERE, "workloads", f"{cell}.json")["limits"],
                          seed=SEED, dev=torch.device("cpu"), control=control, workdir=str(tmp_path))
    rc = harness._run(ctx, bench, types.SimpleNamespace(seconds=0.5, trace=0), 0.0)
    assert rc == 0
    return json.loads(capfd.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["align-medium"])
def test_sound_run_is_correct(cell, tiny_cfg, tmp_path, capfd):
    out = result(cell, tiny_cfg, tmp_path, capfd)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["metrics"]["setup_s"]["value"] > 0


def test_align_answer_altered(tiny_cfg, tmp_path, capfd, monkeypatch):
    """Every onset moved a frame later where the seconds are produced."""
    from lyricalignment_tpu_torch.cli import inference_alignment as ia

    real = ia.frames_to_seconds
    monkeypatch.setattr(ia, "frames_to_seconds", lambda on, off: real(on + 1, off))
    assert not result("align-medium", tiny_cfg, tmp_path, capfd)["correct"]


def test_program_int8_path_is_not_correct(tiny_cfg, tmp_path, capfd):
    """The program's own int8 encoder, the precision below the stated
    bfloat16, served in place of the configuration's model."""
    out = result("align-medium", tiny_cfg, tmp_path, capfd, control="int8")
    assert not out["correct"] and out["checks"]["align_narrow_tensors"]["value"] > 0


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                           "align-medium", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout
