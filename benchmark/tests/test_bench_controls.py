"""Each cell's controls come out not correct at the precision below the
configuration's bfloat16: the reference with FP8 matmuls in the program's
place (``fp8``), and the program's own int8 encoder (``int8``). On the card
only (the cells run the port's CUDA kernels), at the cells' own sizes with
a short window:

    python -m pytest benchmark/tests/test_bench_controls.py -q -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

pytestmark = pytest.mark.cuda
SEED = 2 ** 31 + 99
CELLS = [w["name"] for w in harness.spec()["workloads"]]


def _last_json(cmd):
    proc = subprocess.run([sys.executable] + cmd, capture_output=True, text=True,
                          cwd=harness.ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("control", ["fp8", "int8"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, control):
    out = _last_json([os.path.join(harness.HERE, "run.py"), "--workload", cell, "--seed", str(SEED),
                      "--seconds", "10", "--trace", "0", "--control", control])
    assert out["correct"] is False, out["checks"]
