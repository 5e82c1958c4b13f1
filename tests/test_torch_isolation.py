"""The port stands alone: importing every module of
``lyricalignment_tpu_torch`` (and ``chip_smoke.py``, without running it)
loads neither ``jax`` nor ``lyricalignment_tpu``; the entry points refuse to
run quietly on the CPU when CUDA is absent; and the kernel wrappers take a
plain path only for CPU tensors."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import lyricalignment_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "lyricalignment_tpu"))
print(len(names), bad)
assert len(names) >= 30 and not bad, bad
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_need_cuda_by_default(tmp_path, monkeypatch):
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.cli.common import load_model_dir
    from lyricalignment_tpu_torch.cli.inference_alignment import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model_dir(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LyricAligner.from_model_dir(str(tmp_path), synthetic_vocab=True)
    data = tmp_path / "test.json"
    data.write_text("[]")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-f", str(data), "--model-dir", str(tmp_path), "--synthetic-vocab"])
    from lyricalignment_tpu_torch.cli.train_multitask import main as train_main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--train-data", str(data), "--dev-data", str(data), "--synthetic-vocab",
                    "--save-dir", str(tmp_path / "result")])


def test_wrappers_refuse_devices_without_a_kernel():
    from lyricalignment_tpu_torch.ops.attention import (
        attention_dkdv,
        attention_dq,
        onepass_self_attention,
        self_attention,
    )
    from lyricalignment_tpu_torch.ops.mel import log10_mel
    from lyricalignment_tpu_torch.ops.viterbi import row_lse, viterbi_dp

    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        log10_mel(meta(1, 1000), 3, 80)
    with pytest.raises(ValueError, match="no kernel"):
        onepass_self_attention(meta(1, 4, 1, 64), meta(1, 4, 1, 64), meta(1, 4, 1, 64),
                               meta(1, 4))
    x = meta(1, 4, 1, 64)
    with pytest.raises(ValueError, match="no kernel"):
        self_attention(x.requires_grad_(), x, x)
    with pytest.raises(ValueError, match="no kernel"):
        attention_dkdv(x, x, x, x, meta(1, 1, 4), meta(1, 1, 4))
    with pytest.raises(ValueError, match="no kernel"):
        attention_dq(x, x, x, x, meta(1, 1, 4), meta(1, 1, 4))
    with pytest.raises(ValueError, match="no kernel"):
        row_lse(meta(4, 8), meta(5, 8), meta(5))
    with pytest.raises(ValueError, match="no kernel"):
        viterbi_dp(meta(1, 4, 2), meta(1, 4), meta(1, 2, dtype=torch.int32),
                   meta(1, dtype=torch.int32), meta(1, dtype=torch.int32))
