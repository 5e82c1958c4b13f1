"""Orbax checkpoints of the JAX package, read with numpy and the standard
library.

Every model dir and train state that the JAX package writes
(``lyricalignment_tpu/train/checkpoints.py:23-50``: ``save_pytree``,
``BestCheckpointPolicy``) is an orbax ``PyTreeCheckpointer`` directory:

* ``_METADATA`` (JSON): ``tree_metadata`` maps each leaf's key path to its
  ``key_metadata`` (``key_type`` 2 a dict key, 1 a sequence index) and
  ``value_metadata`` (``value_type`` ``np.ndarray``, ``jax.Array`` or
  ``scalar`` for arrays; ``None``, ``Dict``, ``List``, ``Tuple`` for empty
  nodes), beside ``use_ocdbt`` and ``use_zarr3``;
* the leaves as zarr v2 arrays named by their key path joined with ``.``:
  ``<name>/.zarray`` (JSON) and chunks ``<name>/0.0`` ..., each chunk a
  zstd frame;
* with ``use_ocdbt`` (orbax's default) those keys live in an OCDBT
  key-value store (tensorstore's format): ``manifest.ocdbt`` names the root
  of a b+tree whose nodes and values sit in data files (``d/<hex>``, and
  under ``ocdbt.process_<i>/`` for the files each process wrote). A
  manifest or node is a 4-byte big-endian magic, its total length (uint64
  LE), a varint format version and compression (1 = zstd), the (zstd)
  body, and a CRC-32C trailer over the bytes before it. A node body is its
  height, a table of data files, then its entries in columns: keys
  prefix-compressed against the previous key; a leaf's values inline or
  references (file, offset, length) into data files; an interior node's
  children (the subtree's common key prefix, file, offset, length and
  statistics), whose keys are stored without that prefix.
  Without ``use_ocdbt`` each key is a file under the checkpoint dir.

:func:`restore_pytree` rebuilds the tree: dicts, and lists for sequences
(JAX's restore without a template also gives lists for tuples), numpy
arrays for the leaves (0-d for scalars), a ``torch.bfloat16`` tensor (made
through a ``uint16`` view) for a bfloat16 leaf, since numpy has no
bfloat16. zstd comes from the hand-written decoder (``data/zstd.py``);
chunks decode on a thread pool. What orbax does not write is refused with
a message: zarr v3, numbered OCDBT manifests, Fortran order, filters and
compressors other than zstd.
"""

from __future__ import annotations

import json
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lyricalignment_tpu_torch.data import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ADDRESS = 2**64 - 1  # the root of an empty tree


class CheckpointFormatError(ValueError):
    """A checkpoint this reader does not understand, or a corrupt one."""


class _Cursor:
    """Reads the fields of a manifest or node body in order."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise CheckpointFormatError(f"{self.what} is truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise CheckpointFormatError(f"{self.what} has an overlong varint")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The body of an OCDBT manifest or node: header, CRC-32C and (zstd)
    compression checked and undone."""
    if len(raw) < 18:
        raise CheckpointFormatError(f"{what} is truncated ({len(raw)} bytes)")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise CheckpointFormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise CheckpointFormatError(f"{what}: header says {length} bytes, read {len(raw)}")
    crc = int.from_bytes(raw[-4:], "little")
    if zstd.crc32c(raw[:-4]) != crc:
        raise CheckpointFormatError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(raw[12:-4], what)
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise CheckpointFormatError(f"{what}: format version {version} is not supported")
    body = raw[12 + cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise CheckpointFormatError(f"{what}: {e}") from e
    raise CheckpointFormatError(f"{what}: compression {compression} is not supported")


def _data_files(cur: _Cursor) -> List[str]:
    """A data file table: each path prefix-compressed against the one
    before; a path is its base path and relative path joined."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)  # base-path lengths: the path is used whole
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise CheckpointFormatError(f"{cur.what}: bad data file table")
        prev = prev[:p] + cur.take(s)
        paths.append(prev.decode())
    return paths


class OcdbtStore:
    """The keys of an OCDBT store at its latest version, and their values.

    ``get(key)`` gives the bytes, ``ref(key)`` either the bytes (a value
    stored inline) or ``(path, offset, length)`` of a value in a data file.
    """

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self._fds: Dict[str, int] = {}
        self.refs: Dict[bytes, Any] = {}
        root_ref = self._latest_root()
        if root_ref is not None:
            self._walk(*root_ref, prefix=b"")

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def read(self, path: str, offset: int, length: int) -> bytes:
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                full = os.path.normpath(os.path.join(self.root, path))
                if not full.startswith(os.path.normpath(self.root) + os.sep):
                    raise CheckpointFormatError(f"data file {path!r} outside the store")
                fd = self._fds[path] = os.open(full, os.O_RDONLY)
        data = os.pread(fd, length, offset)
        if len(data) != length:
            raise CheckpointFormatError(
                f"{path}: {length} bytes at {offset} asked for, {len(data)} there")
        return data

    def _manifest(self, name: str) -> _Cursor:
        with open(os.path.join(self.root, name), "rb") as f:
            raw = f.read()
        return _Cursor(_unwrap(raw, MANIFEST_MAGIC, name), name)

    def _latest_root(self) -> Optional[Tuple[int, str, int, int]]:
        cur = self._manifest("manifest.ocdbt")
        cur.take(16)  # uuid
        kind = cur.varint()
        cur.varint(), cur.varint(), cur.u8()  # inline limit, node limit, arity
        method = cur.varint()
        if method == 1:
            cur.take(4)  # zstd level (int32)
        elif method != 0:
            raise CheckpointFormatError(f"manifest: compression method {method}")
        if kind != 0:  # 1: numbered manifests, which orbax does not write
            raise CheckpointFormatError(f"manifest kind {kind} is not supported")
        files = _data_files(cur)
        n = cur.varint()
        if n == 0:
            return None
        cur.varints(n)  # generation numbers
        heights = list(cur.take(n))
        ids, offsets, lengths, num_keys = (cur.varints(n) for _ in range(4))
        last = n - 1  # versions are stored oldest first
        if num_keys[last] == 0 or offsets[last] == _NO_ADDRESS:
            return None
        if ids[last] >= len(files):
            raise CheckpointFormatError("manifest: root in an unknown data file")
        return heights[last], files[ids[last]], offsets[last], lengths[last]

    def _walk(self, height: int, path: str, offset: int, length: int,
              prefix: bytes) -> None:
        what = f"b-tree node {path}:{offset}"
        cur = _Cursor(_unwrap(self.read(path, offset, length), NODE_MAGIC, what), what)
        if cur.u8() != height:
            raise CheckpointFormatError(f"{what}: height differs from its reference")
        files = _data_files(cur)
        n = cur.varint()
        key_prefix = [0] + cur.varints(n - 1) if n else []
        key_suffix = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for p, s in zip(key_prefix, key_suffix):
            if p > len(prev):
                raise CheckpointFormatError(f"{what}: bad key prefix")
            prev = prev[:p] + cur.take(s)
            keys.append(prev)

        def file(i):
            if i >= len(files):
                raise CheckpointFormatError(f"{what}: unknown data file {i}")
            return files[i]

        if height == 0:
            lengths = cur.varints(n)
            indirect = cur.varints(n)
            k = sum(1 for v in indirect if v)
            ids, offsets = cur.varints(k), cur.varints(k)
            j = 0
            for key, ln, kind in zip(keys, lengths, indirect):
                if kind:
                    self.refs[prefix + key] = (file(ids[j]), offsets[j], ln)
                    j += 1
                else:
                    self.refs[prefix + key] = cur.take(ln)
            return
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        for key, c, i, off, ln in zip(keys, common, ids, offsets, lengths):
            if c > len(key):
                raise CheckpointFormatError(f"{what}: bad subtree prefix")
            self._walk(height - 1, file(i), off, ln, prefix + key[:c])

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self.refs)

    def ref(self, key: str):
        return self.refs.get(key.encode())

    def get(self, key: str) -> Optional[bytes]:
        r = self.ref(key)
        return r if r is None or isinstance(r, bytes) else self.read(*r)


class _FileStore:
    """The keys of a checkpoint written without OCDBT: one file each."""

    def __init__(self, root: str):
        self.root = root

    def ref(self, key: str):
        path = os.path.join(self.root, key)
        return (path, 0, os.path.getsize(path)) if os.path.isfile(path) else None

    def read(self, path: str, offset: int, length: int) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def get(self, key: str) -> Optional[bytes]:
        r = self.ref(key)
        return None if r is None else self.read(*r)

    def close(self) -> None:
        pass


def _dtype(spec: str) -> Tuple[np.dtype, bool]:
    """The numpy dtype of a zarr dtype string, and whether it is bfloat16
    (read as its uint16 bits)."""
    if spec == "bfloat16":
        return np.dtype("<u2"), True
    try:
        return np.dtype(spec), False
    except TypeError as e:
        raise CheckpointFormatError(f"zarr dtype {spec!r} is not supported") from e


def _fill(value, dtype: np.dtype, bf16: bool):
    """The value of a missing chunk: zarr's ``fill_value`` (null reads as
    zero, as tensorstore reads it)."""
    if value is None:
        return 0
    if bf16:
        raise CheckpointFormatError(f"a bfloat16 fill_value ({value!r}) is not supported")
    return np.array(value).astype(dtype)  # numbers, "NaN", "Infinity", "-Infinity"


class _Array:
    """One zarr v2 array: its output buffer and the chunks to decode into
    it."""

    def __init__(self, store, name: str):
        raw = store.get(f"{name}/.zarray")
        if raw is None:
            raise CheckpointFormatError(f"array {name!r} is missing (no {name}/.zarray)")
        meta = json.loads(raw)
        if meta.get("zarr_format") != 2:
            raise CheckpointFormatError(f"{name}: zarr_format {meta.get('zarr_format')}")
        if meta.get("filters"):
            raise CheckpointFormatError(f"{name}: zarr filters are not supported")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise CheckpointFormatError(f"{name}: compressor {comp.get('id')!r} is not supported")
        if meta.get("order", "C") != "C":
            raise CheckpointFormatError(f"{name}: order {meta.get('order')!r} is not supported")
        self.name, self.store = name, store
        self.compressed = comp is not None
        self.dtype, self.bf16 = _dtype(meta["dtype"])
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.sep = meta.get("dimension_separator", ".")
        self.out = np.empty(self.shape, self.dtype.newbyteorder("="))
        self.fill = _fill(meta.get("fill_value"), self.dtype, self.bf16)

    def jobs(self) -> List[Callable[[], None]]:
        if not self.shape:
            return [lambda: self._chunk((), "0")]
        grid = [math.ceil(s / c) if c else 0 for s, c in zip(self.shape, self.chunks)]
        jobs = []
        for idx in np.ndindex(*grid):
            key = self.sep.join(str(i) for i in idx)
            jobs.append(lambda idx=idx, key=key: self._chunk(idx, key))
        return jobs

    def _chunk(self, idx: Tuple[int, ...], key: str) -> None:
        ref = self.store.ref(f"{self.name}/{key}")
        starts = [i * c for i, c in zip(idx, self.chunks)]
        region = tuple(slice(s, min(s + c, n)) for s, c, n in zip(starts, self.chunks, self.shape))
        if ref is None:
            self.out[region] = self.fill
            return
        data = ref if isinstance(ref, bytes) else self.store.read(*ref)
        full = self.chunks == self.shape and self.dtype.isnative
        buf = self.out if full else np.empty(self.chunks, self.dtype)
        want = buf.nbytes
        if self.compressed:
            try:
                got = zstd.decompress_into(data, buf)
            except zstd.ZstdError as e:
                raise CheckpointFormatError(f"{self.name}/{key}: {e}") from e
        else:
            got = len(data)
            buf.reshape(-1).view(np.uint8)[:min(got, want)] = np.frombuffer(data, np.uint8)[:want]
        if got != want:
            raise CheckpointFormatError(f"{self.name}/{key}: {got} bytes, expected {want}")
        if full:
            return
        self.out[region] = buf[tuple(slice(0, r.stop - r.start) for r in region)]

    def value(self):
        if self.bf16:
            return torch.from_numpy(self.out.view(np.int16)).view(torch.bfloat16)
        return self.out


_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")


def _build_tree(leaves: List[Tuple[List[Tuple[str, int]], Any]]):
    """Nested containers from (key path, value) pairs: key_type 1 (a
    sequence index) makes lists, any other key dicts."""
    if len(leaves) == 1 and not leaves[0][0]:
        return leaves[0][1]
    groups: Dict[Any, list] = {}
    seq = None
    for path, value in leaves:
        (key, key_type), rest = path[0], path[1:]
        is_seq = key_type == 1
        if seq is None:
            seq = is_seq
        elif seq != is_seq:
            raise CheckpointFormatError("a node mixes dict keys and sequence indices")
        groups.setdefault(int(key) if is_seq else key, []).append((rest, value))
    if seq:
        if sorted(groups) != list(range(len(groups))):
            raise CheckpointFormatError("a sequence in _METADATA has gaps")
        return [_build_tree(groups[i]) for i in range(len(groups))]
    return {k: _build_tree(v) for k, v in groups.items()}


def _open(path: str):
    """The leaves of a checkpoint dir as (key path, value type) pairs, and
    its key-value store."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise CheckpointFormatError(f"{path} has no _METADATA: not an orbax PyTree checkpoint "
                                    f"this reader supports")
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise CheckpointFormatError(f"{path} was written with use_zarr3=True; only zarr v2 "
                                    f"checkpoints (orbax's default) are supported")
    entries = [([(k["key"], k["key_type"]) for k in e["key_metadata"]],
                e["value_metadata"]["value_type"]) for e in meta["tree_metadata"].values()]
    for keys, vtype in entries:
        if vtype not in _EMPTY and vtype not in _ARRAY_TYPES:
            raise CheckpointFormatError(f"leaf {keys}: value type {vtype!r} is not supported")
    store = OcdbtStore(path) if meta.get("use_ocdbt", False) else _FileStore(path)
    return entries, store


def _read(store, entries) -> List[Any]:
    """The values of ``entries``, the arrays' chunks decoded on a thread
    pool."""
    try:
        values = [_Array(store, ".".join(k for k, _ in keys)) if vtype in _ARRAY_TYPES
                  else _EMPTY[vtype]() for keys, vtype in entries]
        jobs = [job for v in values if isinstance(v, _Array) for job in v.jobs()]
        n = min(8, os.cpu_count() or 1, len(jobs))
        with ThreadPoolExecutor(max_workers=max(1, n)) as pool:
            for fut in [pool.submit(job) for job in jobs]:
                fut.result()
    finally:
        store.close()
    return [v.value() if isinstance(v, _Array) else v for v in values]


def restore_pytree(path: str, top: Optional[str] = None) -> Any:
    """The tree of an orbax ``PyTreeCheckpointer`` directory (the JAX
    package's ``restore_pytree(path)`` without a template): numpy leaves,
    ``torch.bfloat16`` tensors for bfloat16 leaves. With ``top``, a tree
    whose root holds that dict key is read only under it, as ``{top:
    subtree}`` (a model's params without the optimizer state). Up to 8
    threads decode the chunks."""
    entries, store = _open(path)
    if any(keys[:1] == [(top, 2)] for keys, _ in entries):
        entries = [(keys, vtype) for keys, vtype in entries if keys[:1] == [(top, 2)]]
    values = _read(store, entries)
    return _build_tree([(keys, v) for (keys, _), v in zip(entries, values)])


def read_leaves(path: str, names: List[str]) -> Dict[str, Any]:
    """``{name: value}`` of the named leaves of a checkpoint dir, a name
    being the key path joined with ``.`` (``params.whisper.encoder.conv1.w``).
    """
    entries, store = _open(path)
    by_name = {".".join(k for k, _ in keys): (keys, vtype) for keys, vtype in entries}
    missing = [n for n in names if n not in by_name]
    if missing:
        store.close()
        raise KeyError(f"{path} has no leaves {missing}")
    return dict(zip(names, _read(store, [by_name[n] for n in names])))
