"""Read and write the JAX package's orbax checkpoints without JAX, orbax or
tensorstore (yolo_dual_tpu/train/checkpoint.py:38 load_checkpoint and :26
save_checkpoint).

    ckpt = OrbaxCheckpoint("runs/train-seg/exp/last")
    ema = ckpt.read("ema/ema")        # decodes only the leaves under ema/ema
    tree = load_checkpoint("runs/train-seg/exp/last")   # everything
    save_checkpoint("runs/train-seg/exp/stripped", tree)  # orbax restores it

orbax's PyTreeCheckpointer writes a directory holding:

- `_METADATA`, JSON: `tree_metadata` maps each leaf's path to its keys (key
  type 2 a dict key, 1 a sequence index) and its value type (`np.ndarray`,
  `jax.Array`, `scalar`, `string`, or an empty `None`, `Dict` or `List`);
- `_strings.json`: the `string` leaves by name;
- an OCDBT key-value store, tensorstore's copy-on-write B+tree:
  `manifest.ocdbt` names the newest version's root node, and the tree's
  leaves map keys to values held inline or as spans of the files under `d/`
  (the per-process store `ocdbt.process_0/` included);
- in that store, a zarr v2 array a leaf under its path joined by ".":
  `<name>/.zarray` (JSON: shape, chunks, dtype, order, compressor) and one
  zstd-compressed chunk a grid cell, `<name>/0.0`.

A manifest or B-tree node is a header (magic, total length, format version,
compression), a body of varint arrays, zstd-compressed, and a CRC32C footer.
Every zstd frame is decoded by the system's libzstd.so.1 through ctypes: a
machine without it raises an OSError that names it.

Leaves come back as numpy arrays (a jax.Array leaf too), Python scalars,
strings or None. numpy has no bfloat16: a bfloat16 array comes back as the
float32 array of the same values (exact; the low 16 bits are zero).

`save_checkpoint` writes what orbax 0.11's PyTreeCheckpointer().save writes
for numpy leaves, in one OCDBT database at the directory's root (orbax's
per-process `ocdbt.process_0/` stores are merged into that root on save, and
its restore reads only the root): one data file under `d/` holding the zarr
chunks of more than 1024 bytes and the single B-tree leaf node (the smaller
values inline in it), and the manifest naming that node. Each array is one
zstd chunk (level 1, as orbax's zarr driver writes), compressed by
libzstd.so.1's ZSTD_compress.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import shutil
import struct
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from yolo_dual_tpu_torch.io.protowire import varint as _varint

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1        # the root offset of an empty tree
_ZSTD_UNKNOWN = (1 << 64) - 2   # ZSTD_getFrameContentSize: unknown (-1) or error (-2)
_SEQUENCE = 1                    # orbax's KeyType of a list or tuple index (2: a dict key)


class _Zstd:
    """zstd decompression through the system's libzstd.so.1."""

    def __init__(self):
        try:
            lib = ctypes.CDLL("libzstd.so.1")
        except OSError as e:
            raise OSError("reading an orbax checkpoint needs the zstd system library "
                          f"libzstd.so.1, which did not load: {e}") from e
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                      ctypes.c_size_t, ctypes.c_int]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        self.lib = lib

    def compress(self, data: bytes, level: int = 1) -> bytes:
        """One zstd frame of `data` (its content size in the frame header)."""
        cap = self.lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(max(cap, 1))
        got = self.lib.ZSTD_compress(out, cap, data, len(data), level)
        if self.lib.ZSTD_isError(got):
            raise ValueError(f"zstd: {self.lib.ZSTD_getErrorName(got).decode()}")
        return out.raw[:got]

    def decompress(self, data: bytes, size: Optional[int] = None, limit: int = 1 << 31) -> bytes:
        """The frames in `data`, decompressed. `size` is the decoded size where
        the caller knows it (a zarr chunk's frame records none); otherwise the
        frame header's, or, where that is absent too (tensorstore writes many
        B-tree nodes' frames without it), the output buffer doubles until it
        holds the frames, up to `limit` bytes."""
        if size is None:
            n = self.lib.ZSTD_getFrameContentSize(data, len(data))
            if n < _ZSTD_UNKNOWN:
                size = n
        cap = size if size is not None else max(4 * len(data), 1 << 16)
        while True:
            out = ctypes.create_string_buffer(max(cap, 1))
            got = self.lib.ZSTD_decompress(out, cap, data, len(data))
            if not self.lib.ZSTD_isError(got):
                break
            err = self.lib.ZSTD_getErrorName(got).decode()
            if size is not None or cap >= limit or "too small" not in err:
                raise ValueError(f"zstd: {err}")
            cap = min(2 * cap, limit)
        if size is not None and got != size:
            raise ValueError(f"zstd: {got} bytes decoded where {size} were expected")
        return out.raw[:got]


@functools.cache
def _zstd() -> _Zstd:
    return _Zstd()


class _Reader:
    """Little-endian varints, bytes and integers from a buffer."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def varint(self) -> int:
        n = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if b < 0x80:
                return n
            shift += 7

    def varints(self, count: int) -> List[int]:
        return [self.varint() for _ in range(count)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("OCDBT: record runs past the end of its buffer")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _unframe(buf: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or B-tree node: header checked, footer dropped,
    decompressed."""
    if len(buf) < 18 or struct.unpack(">I", buf[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT record (magic {buf[:4].hex()})")
    if struct.unpack("<Q", buf[4:12])[0] != len(buf):
        raise ValueError(f"{what}: length field disagrees with the record's size")
    r = _Reader(buf, 12)
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} is not read here")
    body = buf[r.pos:-4]
    if compression == 1:
        return _zstd().decompress(body)
    if compression != 0:
        raise ValueError(f"{what}: compression {compression} is not read here")
    return body


def _data_files(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """A record's data file table -> [(the file's path, the base path of the
    records inside it)], both relative to the database's directory. Paths are
    prefix-compressed against the previous entry; a record's paths are
    relative to the base path of the file holding that record."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        full = prev[:prefix[i]] + r.take(suffix[i])
        prev = full
        files.append((base + full.decode(), base + full[:base_len[i]].decode()))
    return files


class OcdbtStore:
    """Read-only view of one OCDBT database directory: the newest version's
    keys and values."""

    def __init__(self, root):
        self.root = Path(root)
        r = _Reader(_unframe((self.root / "manifest.ocdbt").read_bytes(), MANIFEST_MAGIC,
                             str(self.root / "manifest.ocdbt")))
        r.take(16)  # uuid
        if r.varint() != 0:
            raise NotImplementedError(f"{self.root}: numbered OCDBT manifests are not read here "
                                      "(orbax writes the single-file kind)")
        r.varint()           # max_inline_value_bytes
        r.varint()           # max_decoded_node_bytes
        r.byte()             # version_tree_arity_log2
        if r.varint() == 1:  # zstd, then its level
            r.take(4)
        files = _data_files(r, "")
        n = r.varint()
        if n == 0:
            raise NotImplementedError(f"{self.root}: the manifest holds no inline version")
        gen = r.varints(n)
        height = [r.byte() for _ in range(n)]
        fid, offset, length = r.varints(n), r.varints(n), r.varints(n)
        last = max(range(n), key=gen.__getitem__)
        self._root = (None if offset[last] == _MISSING else
                      (files[fid[last]], offset[last], length[last], height[last]))

    def _read_span(self, path: str, offset: int, length: int) -> bytes:
        with open(self.root / path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{self.root / path}: {length} bytes wanted at {offset}, "
                             f"{len(data)} there")
        return data

    def entries(self, prefix: bytes = b"") -> Dict[bytes, tuple]:
        """{key: value reference} of every key starting with `prefix`; a
        reference is ("inline", bytes) or (file, offset, length). Interior
        nodes whose key range misses the prefix are not read."""
        out: Dict[bytes, tuple] = {}
        if self._root is not None:
            (path, base), offset, length, height = self._root
            self._walk(path, base, offset, length, height, b"", prefix, out)
        return out

    def _walk(self, path, base, offset, length, height, inherited, prefix, out):
        where = f"{self.root / path}@{offset}"
        r = _Reader(_unframe(self._read_span(path, offset, length), NODE_MAGIC, where))
        if r.byte() != height:
            raise ValueError(f"{where}: node height disagrees with its reference")
        files = _data_files(r, base)
        n = r.varint()
        kprefix = [0] + r.varints(max(n - 1, 0))
        ksuffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:kprefix[i]] + r.take(ksuffix[i])
            keys.append(inherited + prev)
        if height == 0:
            vlen = r.varints(n)
            kinds = r.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            ids, offs = r.varints(len(indirect)), r.varints(len(indirect))
            ref = dict(zip(indirect, zip(ids, offs)))
            for i in range(n):
                if kinds[i] not in (0, 1):
                    raise ValueError(f"{where}: value kind {kinds[i]}")
                value = (("inline", r.take(vlen[i])) if kinds[i] == 0 else
                         (files[ref[i][0]][0], ref[i][1], vlen[i]))
                if keys[i].startswith(prefix):
                    out[keys[i]] = value
            return
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        for i in range(n):
            hi = keys[i + 1] if i + 1 < n else None
            if hi is not None and hi <= prefix:
                continue  # the child's keys all sort before the prefix
            if keys[i] > prefix and not keys[i].startswith(prefix):
                break     # ... or all after the keys that start with it
            child_path, child_base = files[ids[i]]
            self._walk(child_path, child_base, offs[i], lens[i], height - 1,
                       keys[i][:len(inherited) + common[i]], prefix, out)

    def value(self, ref: tuple) -> bytes:
        if ref[0] == "inline":
            return ref[1]
        return self._read_span(*ref)


def _bfloat16_to_float32(raw: np.ndarray) -> np.ndarray:
    return (raw.astype(np.uint32) << 16).view(np.float32)


def _zarr_dtype(name: str) -> Tuple[np.dtype, bool]:
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name), False


def read_zarr(store: OcdbtStore, entries: Dict[bytes, tuple], name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`, from its `.zarray` and chunks
    (C or F order within a chunk; edge chunks are stored whole and cropped).
    A chunk absent from the store is the fill value (0 where it is null)."""
    key = f"{name}/.zarray".encode()
    if key not in entries:
        raise KeyError(f"{store.root}: no array {name!r}")
    meta = json.loads(store.value(entries[key]))
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise NotImplementedError(f"{name}: zarr filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise NotImplementedError(f"{name}: zarr compressor {comp.get('id')!r} "
                                  "(orbax writes zstd)")
    dtype, bf16 = _zarr_dtype(meta["dtype"])
    shape, chunks, order = tuple(meta["shape"]), tuple(meta["chunks"]), meta["order"]
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if fill is not None and bf16:  # the fill's bfloat16 bits
        fill = int(np.array(fill, np.float32).view(np.uint32)) >> 16
    out = np.full(shape, 0 if fill is None else fill, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        ref = entries.get(f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode())
        if ref is None:
            continue
        data = store.value(ref)
        if comp is not None:
            data = _zstd().decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"{name}: chunk {idx} holds {len(data)} bytes, not {chunk_bytes}")
        block = np.frombuffer(data, dtype).reshape(chunks, order=order)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    return _bfloat16_to_float32(out) if bf16 else out


PathLike = Union[str, Tuple[str, ...]]


def _as_path(prefix: PathLike) -> Tuple[str, ...]:
    if isinstance(prefix, str):
        return tuple(p for p in prefix.split("/") if p)
    return tuple(str(p) for p in prefix)


class OrbaxCheckpoint:
    """One orbax PyTree checkpoint directory, read lazily: `read(prefix)`
    decodes only the leaves under `prefix` (a "/"-joined path such as
    "ema/ema", or a tuple of keys)."""

    def __init__(self, path):
        self.path = Path(path)
        meta_file = self.path / "_METADATA"
        if not meta_file.is_file():
            raise FileNotFoundError(f"{self.path}: no _METADATA; not an orbax checkpoint")
        meta = json.loads(meta_file.read_text())
        if not meta.get("use_ocdbt", False):
            raise NotImplementedError(f"{self.path}: only OCDBT checkpoints are read "
                                      "(orbax's default)")
        if meta.get("use_zarr3", False):
            raise NotImplementedError(f"{self.path}: zarr3 arrays are not read here "
                                      "(orbax's default is zarr v2)")
        self.leaves = []
        for entry in meta["tree_metadata"].values():
            keys = tuple((k["key"], k["key_type"]) for k in entry["key_metadata"])
            self.leaves.append((keys, entry["value_metadata"]))
        self._store: Optional[OcdbtStore] = None

    @property
    def store(self) -> OcdbtStore:
        if self._store is None:
            self._store = OcdbtStore(self.path)
        return self._store

    def _under(self, prefix: Tuple[str, ...]):
        n = len(prefix)
        return [(keys, vm) for keys, vm in self.leaves
                if tuple(k for k, _ in keys[:n]) == prefix]

    def has(self, prefix: PathLike) -> bool:
        """Whether the subtree at `prefix` is a non-empty container or a leaf
        that is not None (the truth value of the restored subtree, as JAX's
        `ckpt.get("ema")` tests it)."""
        p = _as_path(prefix)
        for keys, vm in self._under(p):
            if len(keys) > len(p) or vm["value_type"] not in ("None", "Dict", "List"):
                return True
        return False

    def contains(self, prefix: PathLike) -> bool:
        """Whether any leaf, None and empty containers included, lies at or
        under `prefix` (`key in ckpt`)."""
        return bool(self._under(_as_path(prefix)))

    def read(self, prefix: PathLike = ""):
        """The subtree at `prefix` as orbax restores it without a target:
        nested dicts and lists, numpy arrays, Python scalars, strings and None."""
        p = _as_path(prefix)
        leaves = self._under(p)
        if not leaves:
            raise KeyError(f"{self.path}: nothing under {'/'.join(p) or '/'}")
        entries = None
        strings = None
        root: dict = {}
        for keys, vm in leaves:
            name = ".".join(k for k, _ in keys)
            kind = vm["value_type"]
            if kind in ("np.ndarray", "jax.Array", "scalar"):
                if entries is None:
                    entries = self.store.entries(".".join(p).encode())
                value = read_zarr(self.store, entries, name)
                if kind == "scalar":
                    value = value.item()
            elif kind == "string":
                if strings is None:
                    strings = json.loads((self.path / "_strings.json").read_text())
                value = strings[name]
            elif kind in ("None", "Dict", "List"):
                value = {"None": None, "Dict": {}, "List": []}[kind]
            else:
                raise NotImplementedError(f"{self.path}: leaf {name} of type {kind!r}")
            node = root
            for key, _ in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1][0]] = value
        tree = _containers(root, dict(_key_types(leaves)))
        for k in p:
            tree = tree[int(k)] if isinstance(tree, list) else tree[k]
        return tree


def _key_types(leaves):
    for keys, _ in leaves:
        for i in range(len(keys)):
            yield tuple(k for k, _ in keys[:i + 1]), keys[i][1]


def _containers(node, types: Dict[tuple, int], path: tuple = ()):
    """Dicts whose keys are sequence indices -> lists, in index order."""
    if not isinstance(node, dict):
        return node
    children = {k: _containers(v, types, path + (k,)) for k, v in node.items()}
    if children and all(types.get(path + (k,)) == _SEQUENCE for k in children):
        return [children[k] for k in sorted(children, key=int)]
    return children


def load_checkpoint(path, prefix: PathLike = ""):
    """The checkpoint at `path` (or its subtree at `prefix`) as JAX's
    `load_checkpoint(path)` restores it, with numpy arrays at the leaves."""
    return OrbaxCheckpoint(path).read(prefix)


# ---------------------------------------------------------------------------
# the write side
# ---------------------------------------------------------------------------

MAX_INLINE_VALUE_BYTES = 1024         # orbax's OCDBT settings (its manifests' config)
MAX_DECODED_NODE_BYTES = 100_000_000
_DICT_KEY = 2


def _varints(ns) -> bytes:
    return b"".join(_varint(n) for n in ns)


@functools.cache
def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), as OCDBT's record footers and TF's tables hold it."""
    table = _crc32c_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _frame(body: bytes, magic: int) -> bytes:
    """A manifest or B-tree node record: header, zstd body, CRC32C footer
    (the inverse of _unframe)."""
    packed = _zstd().compress(body, 0)
    head = _varint(0) + _varint(1)            # format version 0, zstd
    rec = struct.pack(">I", magic) + struct.pack("<Q", 4 + 8 + len(head) + len(packed) + 4)
    rec += head + packed
    return rec + struct.pack("<I", crc32c(rec))


def _file_table(paths: List[str]) -> bytes:
    """A data file table of paths with empty base paths, unshared prefixes."""
    enc = [p.encode() for p in paths]
    return (_varint(len(enc)) + _varints([0] * max(len(enc) - 1, 0)) + _varints(map(len, enc))
            + _varints([0] * len(enc)) + b"".join(enc))


def _leaf_node(items: List[Tuple[bytes, bytes]], data_file: str,
               offsets: Dict[bytes, int]) -> bytes:
    """The body of a B-tree leaf node over sorted (key, value) items; the
    values in `offsets` are held in `data_file` at those offsets."""
    keys = [k for k, _ in items]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    body = bytes([0]) + _file_table([data_file] if offsets else [])
    body += _varint(len(keys)) + _varints(prefix)
    body += _varints(len(k) - p for k, p in zip(keys, [0] + prefix))
    body += b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
    body += _varints(len(v) for _, v in items)
    body += _varints(int(k in offsets) for k in keys)
    indirect = [k for k in keys if k in offsets]
    body += _varints([0] * len(indirect)) + _varints(offsets[k] for k in indirect)
    return body + b"".join(v for k, v in items if k not in offsets)


def write_ocdbt(root, kv: Dict[bytes, bytes]) -> None:
    """An OCDBT database of one version holding `kv` under `root`: the data
    file `d/<random>` (the values over MAX_INLINE_VALUE_BYTES, then the leaf
    node) and `manifest.ocdbt`."""
    root = Path(root)
    items = sorted(kv.items())
    data_file = f"d/{os.urandom(16).hex()}"
    blob, offsets = bytearray(), {}
    for k, v in items:
        if len(v) > MAX_INLINE_VALUE_BYTES:
            offsets[k] = len(blob)
            blob += v
    indirect_bytes = len(blob)
    body = _leaf_node(items, data_file, offsets)
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"OCDBT: a leaf node of {len(body)} bytes exceeds "
                         f"{MAX_DECODED_NODE_BYTES}")
    node = _frame(body, NODE_MAGIC)
    node_offset = len(blob)
    blob += node
    (root / "d").mkdir(parents=True, exist_ok=True)
    (root / data_file).write_bytes(bytes(blob))
    config = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([4]) + _varint(1) + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(node_offset)
               + _varint(len(node)) + _varint(len(items)) + _varint(len(node))
               + _varint(indirect_bytes) + struct.pack("<Q", time.time_ns()) + _varint(0))
    manifest = _frame(config + _file_table([data_file]) + version, MANIFEST_MAGIC)
    (root / "manifest.ocdbt").write_bytes(manifest)


def _zarr_meta(arr: np.ndarray) -> bytes:
    dtype = "bfloat16" if arr.dtype.name == "bfloat16" else arr.dtype.str
    meta = {"chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None,
            "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def _leaves(tree, keys: tuple = ()):
    """(keys, value) of each leaf of nested dicts and lists; a key is
    (name, orbax KeyType). Empty containers are leaves. A named tuple (an
    optax state) is keyed by its field names, as orbax keys it, and an empty
    one (optax's EmptyState) is None, as orbax restores it."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict() or None
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _leaves(v, keys + ((str(k), _DICT_KEY),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + ((str(i), _SEQUENCE),))
    else:
        yield keys, tree


def _leaf_value(name: str, value) -> Tuple[str, Optional[np.ndarray]]:
    """(orbax value type, the array to store or None)."""
    if value is None:
        return "None", None
    if isinstance(value, dict):
        return "Dict", None
    if isinstance(value, (list, tuple)):
        return "List", None
    if isinstance(value, str):
        return "string", None
    if isinstance(value, (bool, int, float, np.generic)):
        return "scalar", np.asarray(value)
    if hasattr(value, "__array__") and not isinstance(value, np.ndarray):
        value = np.asarray(value)          # a jax.Array or a CPU tensor
    if isinstance(value, np.ndarray):
        if value.size == 0:
            raise ValueError(f"{name}: orbax saves no array of zero size")
        return "np.ndarray", value
    raise TypeError(f"{name}: a leaf of type {type(value).__name__} is not written "
                    "(numpy arrays, Python and numpy scalars, strings and None are)")


def save_checkpoint(path, tree: dict) -> Path:
    """Write `tree` (nested dicts and lists of numpy arrays, scalars, strings,
    None and empty containers) as an orbax PyTree checkpoint directory that
    orbax's PyTreeCheckpointer().restore and `load_checkpoint` read back. As
    JAX's save_checkpoint, an existing directory or file at `path` is
    replaced; the checkpoint is written beside it first and renamed into
    place, so a run killed while saving leaves the previous one whole."""
    path = Path(path).resolve()
    tmp = path.with_name(path.name + ".orbax-checkpoint-tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    meta, strings, kv = {}, {}, {}
    for keys, value in _leaves(tree):
        if not keys:
            raise ValueError("an orbax checkpoint is a dict or list at its root")
        name = ".".join(k for k, _ in keys)
        kind, arr = _leaf_value(name, value)
        meta[repr(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": kind,
                               "skip_deserialize": kind in ("None", "Dict", "List")}}
        if kind == "string":
            strings[name] = value
        if arr is not None:
            arr = np.asarray(arr, order="C")  # ascontiguousarray makes 0-d 1-d
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("<"))
            kv[f"{name}/.zarray".encode()] = _zarr_meta(arr)
            chunk = ".".join("0" * arr.ndim) or "0"
            kv[f"{name}/{chunk}".encode()] = _zstd().compress(arr.tobytes(), 1)
    (tmp / "_METADATA").write_text(json.dumps({
        "tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    if strings:
        (tmp / "_strings.json").write_text(json.dumps(strings))
    if kv:
        write_ocdbt(tmp, kv)
    now = time.time_ns()
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                         "PyTreeCheckpointHandler",
        "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": now,
        "commit_timestamp_nsecs": now, "custom_metadata": {}}))
    if path.is_dir():
        shutil.rmtree(path)
    elif path.exists():
        path.unlink()
    os.replace(tmp, path)
    return path
