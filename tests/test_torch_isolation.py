"""The port stands alone: importing every module of
``lyricalignment_tpu_torch`` (and ``chip_smoke.py``, without running it)
loads neither ``jax`` nor ``lyricalignment_tpu``, nor any of ``orbax``,
``tensorstore``, ``zstandard``, ``msgpack`` and ``ml_dtypes`` (a GPU host
need not have them: the port reads orbax checkpoints itself, and reading
one loads none of them either); the entry points refuse to run quietly on
the CPU when CUDA is absent; and the kernel wrappers take a plain path only
for CPU tensors."""

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
refused = ("jax", "jaxlib", "lyricalignment_tpu", "orbax", "tensorstore", "zstandard",
           "msgpack", "ml_dtypes")
bad = sorted(n for n in sys.modules if n.split(".")[0] in refused)
print(len(names), bad)
assert len(names) >= 30 and not bad, bad
# the transcription path and its scoring are among the modules probed
need = {"api", "cli.inference_transcript", "cli.evaluate_transcript", "decode.beam",
        "decode.longform", "decode.timestamps", "decode.transcribe", "text.normalize",
        "text.heteronyms", "utils.metrics", "models.convert", "cli.convert_checkpoint",
        "cli.serve", "cli.inference_alignment_nogt", "cli.postprocess", "data.native_loader",
        "ops.ctc", "utils.observability", "train.losses", "parallel", "parallel.mesh",
        "parallel.pipeline", "prep", "prep.get_pronunce_table", "prep.mix_with_musdb",
        "prep.replace_path", "prep.separate_vocals", "train.orbax", "data.zstd"}
missing = {n for n in need if pkg.__name__ + "." + n not in names}
assert not missing, missing
from lyricalignment_tpu_torch.api import LyricAligner
assert callable(LyricAligner.transcribe_many)
# reading a JAX orbax checkpoint loads none of them either
from lyricalignment_tpu_torch.train.checkpoints import restore_pytree
tree = restore_pytree("tests/data/torch_orbax/tiny/best_model")
assert int(tree["step"]) == 3
bad = sorted(n for n in sys.modules if n.split(".")[0] in refused)
assert not bad, bad
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
    from lyricalignment_tpu_torch.ops.ctc import ctc_reduced_bwd, ctc_reduced_fwd
    from lyricalignment_tpu_torch.ops.viterbi import row_lse_bwd

    with pytest.raises(ValueError, match="no kernel"):
        row_lse(meta(4, 16).requires_grad_(), meta(5, 16), meta(5))
    with pytest.raises(ValueError, match="no kernel"):
        row_lse_bwd(meta(4, 16), meta(5, 16), meta(5), meta(4), meta(4))
    with pytest.raises(ValueError, match="no kernel"):
        row_lse_bwd(meta(4, 16), meta(5, 16), meta(5), meta(4), meta(4), (False, True, True))
    labels, valid = meta(1, 2, dtype=torch.int32), meta(1, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="no kernel"):
        ctc_reduced_fwd(meta(1, 4), meta(1, 4, 2), labels, valid)
    with pytest.raises(ValueError, match="no kernel"):
        ctc_reduced_bwd(meta(1, 4, 5), labels, valid, meta(1))


def test_transcription_entry_points_need_cuda_by_default(tmp_path, monkeypatch):
    """The transcript CLI and ``transcribe_many`` (through the aligner's
    ``from_model_dir``) raise without ``--device cpu`` when CUDA is absent;
    the evaluation CLI runs no model and needs no device."""
    import json

    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.cli import evaluate_transcript, inference_transcript

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "test.json"
    data.write_text("[]")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference_transcript.main(["-f", str(data), "--model-dir", str(tmp_path),
                                   "-o", str(tmp_path / "out.json")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LyricAligner.from_model_dir(str(tmp_path), synthetic_vocab=True).transcribe_many([])
    result = tmp_path / "result.json"
    result.write_text(json.dumps([{"lyric": "你好", "inference": "你们"}], ensure_ascii=False))
    rate, ops = evaluate_transcript.compute_cer(["你好"], ["你们"])
    evaluate_transcript.main(["-f", str(result)])
    assert rate == 0.5 and ops["substitution"] == 1


def test_serving_entry_points_need_cuda_by_default(tmp_path, monkeypatch):
    """``serve`` and the nogt CLI raise without ``--device cpu`` when CUDA is
    absent; ``la-convert`` and postprocess run on the host and need no
    device."""
    from lyricalignment_tpu_torch.cli import inference_alignment_nogt, postprocess, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "test.json"
    data.write_text("[]")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--model-dir", str(tmp_path), "--synthetic-vocab"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference_alignment_nogt.main(["-f", str(data), "--model-dir", str(tmp_path),
                                       "--synthetic-vocab"])
    assert serve.parse_args(["--model-dir", "m"]).device == "cuda"
    result = tmp_path / "result.json"
    result.write_text('[{"inference": "A 愛"}]')
    postprocess.main(["-f", str(result)])
    assert "爱" in result.read_text(encoding="utf-8")
