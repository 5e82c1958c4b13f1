"""One run of one cell: set up, measure a closed loop for ``--seconds``,
read the per-layer metrics from a traced sub-window (``--trace 1``), judge
what the timed path produced against the plain reference, print the result.

Everything a cell needs is found by name: its configuration and traffic in
``BENCHMARK.json``, the configuration's sizes in ``configs/<config>.json``,
the mix in ``traffic/<traffic>.json`` (which names the entry,
``entries/<entry>.py``), the cell's limits in ``workloads/<cell>.json``, and
each metric's reader in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
JAX_NAMES = ("jax", "jaxlib", "flax", "lyricalignment_tpu")
# host threads of the run's own PyTorch CPU work: few, as a service on a
# shared host sets them; on an 8-core host the default (one a core) slows
# the host-bound launch path and widens its tail
THREADS = 2


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_metrics(bench: Dict, cell: str, key: str) -> List[Dict]:
    """The metrics of ``key`` ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, and those that list no cells and move an
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[key]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif key == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run in a checkout builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ.setdefault("USE_FLAX", "0")


@dataclass
class Context:
    cell: str
    cfg: Dict
    traffic: Dict
    limits: Dict
    seed: int
    dev: object
    control: Optional[str]
    workdir: str

    def tmp(self, sub: str = "") -> str:
        path = os.path.join(self.workdir, sub)
        os.makedirs(path, exist_ok=True)
        return path


@dataclass
class Run:
    """What the readers read."""

    calls: List[Dict] = field(default_factory=list)     # t0, t1 (s), units
    window_s: float = 0.0
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    trace: object = None                                # trace.Trace of the sub-window
    traced_calls: List[Dict] = field(default_factory=list)
    shapes: Dict = field(default_factory=dict)
    flops: float = 0.0

    def units(self, key: str) -> float:
        return sum(c["units"][key] for c in self.calls)


def entry_for(ctx: Context):
    mod = importlib.import_module(f"benchmark.entries.{ctx.traffic['entry']}")
    return mod.Entry(ctx)


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def measure(entry, seconds: float, run: Run) -> None:
    """The closed loop: calls until ``seconds`` have passed; the window
    ends with the last call."""
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        units = entry.call()
        t1 = time.perf_counter()
        run.calls.append({"t0": t0 - t_start, "t1": t1 - t_start, "units": units})
        if t1 - t_start >= seconds:
            break
    run.window_s = run.calls[-1]["t1"]


def trace_sub_window(entry, run: Run, n_calls: int, host: bool, on_card: bool) -> None:
    from benchmark import trace

    def calls():
        return [entry.call(record=False) for _ in range(n_calls)]

    run.traced_calls, prof, wall = trace.profile(calls, host, on_card)
    run.trace = trace.read_profile(prof, wall)


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="the comparison's control (never in a measured run): int8, the "
                         "program's int8 encoder; fp8, the reference's own answers with "
                         "FP8 matmuls judged in the program's place")
    args = ap.parse_args(argv)

    import torch

    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    set_cache_dirs()
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    from benchmark import program

    workdir = tempfile.mkdtemp(prefix=f"bench-{args.workload}-")
    ctx = Context(cell=args.workload, cfg=load_json(ROOT, conf["file"]),
                  traffic=load_json(HERE, "traffic", f"{cell['traffic']}.json"),
                  limits=load_json(HERE, "workloads", f"{args.workload}.json")["limits"],
                  seed=args.seed, dev=program.device("cuda"), control=args.control,
                  workdir=workdir)
    try:
        return _run(ctx, bench, args, t_process)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def _run(ctx: Context, bench: Dict, args, t_process: float) -> int:
    """The run after the device checks; on a CPU device (the tests) the
    device's counters read 0."""
    import torch

    if ctx.dev.type == "cuda":
        torch.set_num_threads(THREADS)
    from benchmark import program

    on_card = ctx.dev.type == "cuda"
    entry = entry_for(ctx)
    run = Run()
    entry.setup()
    if on_card:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_process
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    measure(entry, args.seconds, run)
    run.memory_peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    run.shapes = entry.shapes()
    run.flops = entry.window_flops(len(run.calls))
    if args.trace:
        trace_sub_window(entry, run, ctx.traffic["trace_calls"], ctx.traffic.get("trace_host", True),
                         on_card)
    found = jax_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs without JAX",
              file=sys.stderr)
        return 4

    key = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, ctx.cell, key):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    entry.release()
    # the entry's numbers; those the cell sets a limit for are compared,
    # the others are printed as readings only
    numbers = entry.check()
    checks = [dict(c, limit=ctx.limits[c["name"]]) for c in numbers if c["name"] in ctx.limits]
    correct = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks)
    for c in numbers:
        if c["name"] not in ctx.limits:
            print(f"reading {c['name']}: {c['value']!r}" + (f"; {c['note']}" if c.get("note") else ""),
                  file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})"
              + (f"; {c['note']}" if c.get("note") else ""), file=sys.stderr)
    result = {
        "correct": correct,
        "attempted": int(sum(c["units"].get("requests", 1) for c in run.calls)),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": 1,
                   "memory_peak_bytes": int(run.memory_peak_bytes)},
    }
    if args.trace and on_card:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    result["checks"] = {c["name"]: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for c in checks}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
