"""Build ``csrc/*.cu`` into one shared library with nvcc and bind it with
ctypes.

Every source is compiled for ``sm_90a`` by its own ``nvcc -c`` process, all
started together, and the objects are linked into
``lyricalignment_tpu_torch/_build/libla_kernels-<hash>.so``, where the hash
covers the sources and the flags, so an edited kernel is rebuilt on first
use and an unchanged one is reused. The C launchers take raw pointers and
the stream as ``void*`` and ints as ``int``, and return the launch's
``cudaError_t``; :func:`launch` raises on anything but 0. The build's
output (ptxas' register and spill report) is kept beside the library as
``libla_kernels-<hash>.log`` and read back when the library is reused.

Nothing here runs at import: the first :func:`library` call builds (on a
machine with ``nvcc``) and loads. A machine without a CUDA toolkit raises
there; no kernel has a quiet fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

from lyricalignment_tpu_torch.utils.observability import op_span

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the DP must reproduce the JAX scan's f32 adds bit for bit
PER_SOURCE_FLAGS: Dict[str, List[str]] = {"viterbi.cu": ["-fmad=false"]}

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher -> argument types, in the order of the C signatures in csrc/
SIGNATURES: Dict[str, list] = {
    # padded audio, window, twiddles, mel^T, band range, out, batch,
    # padded_len, n_frames, n_mels, stream
    "la_log10_mel": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, key_bias (or null), out, batch, seq, heads, is_bf16, stream
    "la_bias_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, key_bias (or null), out, row lse, batch, seq, heads, is_bf16,
    # stream
    "la_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, key_bias (or null), dk, dv, batch, seq,
    # heads, is_bf16, stream
    "la_attention_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, key_bias (or null), dq, batch, seq, heads,
    # is_bf16, stream
    "la_attention_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # h, w (first column row), b (first column), out, scratch (of
    # la_row_lse_scratch_floats(rows, feat, cols) floats), rows, feat, cols,
    # stream
    "la_row_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # h, w, b (the slice's first column), lse, g, dh, dw, db (each or null),
    # scratch (of la_row_lse_bwd_scratch_floats(rows, feat, cols) floats),
    # rows, feat, cols, stream
    "la_row_lse_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # blank_lp, label_lp, labels, valid (u8), alphas, nll, batch, frames,
    # labels_max, stream
    "la_ctc_reduced_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # alphas, labels, valid, g, scratch (of la_ctc_bwd_scratch_floats(batch,
    # frames, labels_max) floats: the _lse3 weights), d_blank, d_label,
    # batch, frames, labels_max, stream
    "la_ctc_reduced_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # lab, sil, labels, num_labels, num_frames, backpointer scratch (of
    # la_viterbi_scratch_words(batch, frames, labels_max) words), onset,
    # offset, batch, frames, labels_max, stream
    "la_viterbi": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # gi, w_hh, b_hh, lengths, out, batch, steps, hidden, directions, stream
    "la_gru_recurrence": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

#: kernel launches since the last reset, by launcher name; each wrapper in
#: ``ops/`` adds one where it launches its kernel and nowhere else
launches: Counter = Counter()

_lock = threading.Lock()
# the counts' own lock: threads launch at once (the long-form loop's groups)
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launch_counts() -> None:
    with _count_lock:
        launches.clear()


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr((ARCH_FLAGS, COMMON_FLAGS, PER_SOURCE_FLAGS)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link; return the library path.
    Reuses a library already built from the same sources and flags."""
    target = BUILD_DIR / f"libla_kernels-{_digest()}.so"
    log_path = target.with_suffix(".log")  # nvcc's and ptxas' output of the build
    if target.exists():
        log = log_path.read_text() if log_path.exists() else ""
        build_info.update(seconds=0.0, log=log, path=str(target), cached=True)
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = ([nvcc] + ARCH_FLAGS + COMMON_FLAGS
                   + PER_SOURCE_FLAGS.get(src.name, [])
                   + ["-I", str(CSRC_DIR), "-c", str(src), "-o", obj])
            procs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        log = "\n".join(logs)
        tmp_so = os.path.join(tmp, target.name)
        link = subprocess.run(
            [nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp_so]
            + [obj for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        tmp_log = os.path.join(tmp, log_path.name)
        Path(tmp_log).write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp_so, target)  # atomic: concurrent processes agree
    build_info.update(seconds=time.perf_counter() - t0, log=log, path=str(target),
                      cached=False)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.la_error_string.argtypes = [ctypes.c_int]
            lib.la_error_string.restype = ctypes.c_char_p
            lib.la_row_lse_scratch_floats.argtypes = [_I, _I, _I]
            lib.la_row_lse_scratch_floats.restype = ctypes.c_longlong
            lib.la_viterbi_scratch_words.argtypes = [_I, _I, _I]
            lib.la_viterbi_scratch_words.restype = ctypes.c_longlong
            lib.la_row_lse_bwd_scratch_floats.argtypes = [_I, _I, _I]
            lib.la_row_lse_bwd_scratch_floats.restype = ctypes.c_longlong
            lib.la_row_lse_bwd_plan.argtypes = [_I, _I, _I, _P]
            lib.la_row_lse_bwd_plan.restype = ctypes.c_int
            lib.la_ctc_max_labels.argtypes = []
            lib.la_ctc_max_labels.restype = ctypes.c_int
            lib.la_ctc_plan.argtypes = [_I, _I, _P]
            lib.la_ctc_plan.restype = ctypes.c_int
            lib.la_ctc_bwd_scratch_floats.argtypes = [_I, _I, _I]
            lib.la_ctc_bwd_scratch_floats.restype = ctypes.c_longlong
            lib.la_gru_plan.argtypes = [_I, _I, _I, _I, _P]
            lib.la_gru_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call launcher ``name``; raise if the launch was refused, else count
    it. In a profile the kernels it launches are linked to a host op named
    ``name``."""
    lib = library()
    with op_span(name):
        rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.la_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    with _count_lock:
        launches[name] += 1
