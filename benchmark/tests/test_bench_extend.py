"""A later change adds a configuration, a cell and a per-layer metric by
adding files and entries only: in a copy of the benchmark, new files and
new entries in BENCHMARK.json are found by name, no file that was there
changes, and the new cell runs (on the CPU, at a tiny size) with the new
metric in its traced result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

DRIVER = r'''
import json, sys, types
import torch
sys.path.insert(0, ".")
from benchmark import harness
bench = harness.spec()
assert [m["name"] for m in harness.cell_metrics(bench, "throwaway-cell", "per_layer")][-1] == \
    "throwaway_metric.align"
cell = next(w for w in bench["workloads"] if w["name"] == "throwaway-cell")
conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
ctx = harness.Context(cell="throwaway-cell", cfg=harness.load_json(harness.ROOT, conf["file"]),
                      traffic=harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json"),
                      limits=harness.load_json(harness.HERE, "workloads", "throwaway-cell.json")["limits"],
                      seed=11, dev=torch.device("cpu"), control=None, workdir=sys.argv[1])
torch.set_num_threads(2)
sys.exit(harness._run(ctx, bench, types.SimpleNamespace(seconds=0.2, trace=1), 0.0))
'''


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_config_cell_and_metric_take_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    os.symlink(os.path.join(harness.ROOT, "lyricalignment_tpu_torch"), root / "lyricalignment_tpu_torch")
    os.makedirs(root / "lyricalignment_tpu" / "assets")
    shutil.copy(os.path.join(harness.ROOT, "lyricalignment_tpu", "assets",
                             "bert_base_chinese_pronunce_table.json"),
                root / "lyricalignment_tpu" / "assets")
    before = _digests(root / "benchmark")

    b = root / "benchmark"
    shutil.copy(b / "tests" / "tiny.json", b / "configs" / "throwaway-config.json")
    mix = json.load(open(b / "traffic" / "align-16x30s.json"))
    mix.update(pool_groups=1, per_group=4, seconds=[3.0, 4.0], lyric_chars=[4, 6],
               requests_per_call=4, batch_size=4, warm_calls=1, check_calls=1, trace_calls=1)
    json.dump(mix, open(b / "traffic" / "throwaway-mix.json", "w"))
    limits = json.load(open(b / "workloads" / "align-medium.json"))
    json.dump(limits, open(b / "workloads" / "throwaway-cell.json", "w"))
    (b / "metrics" / "throwaway_metric.align.py").write_text(
        '"""A metric a later change adds."""\n\n\ndef read(run):\n    return 42.0\n')
    spec = json.load(open(root / "BENCHMARK.json"))
    spec["configs"].append({"name": "throwaway-config", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/throwaway-config.json", "reduced": [],
                            "why": "a miniature"})
    spec["workloads"].append({"name": "throwaway-cell", "config": "throwaway-config",
                              "traffic": "throwaway-mix", "chips": 1, "why": "a later cell"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("align_"):
            m["workloads"].append("throwaway-cell")
    spec["per_layer"].append({"name": "throwaway_metric.align", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "align_audio_s_per_s", "workloads": ["throwaway-cell"]})
    json.dump(spec, open(root / "BENCHMARK.json", "w"))

    proc = subprocess.run([sys.executable, "-c", DRIVER, str(tmp_path / "work")], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metrics"]["throwaway_metric.align"]["value"] == 42.0
    after = _digests(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
