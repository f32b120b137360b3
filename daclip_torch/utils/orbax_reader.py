"""Orbax checkpoints read without JAX: OCDBT and zarr v2 in Python, zstd in
C++ (`utils/zstd.py`).

The read half of `daclip_tpu/utils/checkpoint.py` (`latest_step` :74,
`restore_checkpoint` :83 without a target). A train dir holds one dir per
step, `<dir>/<step>/`, with `_CHECKPOINT_METADATA` and the item `default/`:

  * `_METADATA`: JSON whose `tree_metadata` lists every leaf by its key path
    (`key_type` 1 for a sequence index, 2 for a dict key) and value type;
    `use_ocdbt` and `use_zarr3` say how the arrays are stored.
  * With `use_ocdbt` (orbax's default), a tensorstore OCDBT key-value store:
    `manifest.ocdbt` and `d/<file>` at the top, `ocdbt.process_<n>/…` beneath
    it. The manifest holds the config and the version tree; its latest
    version names the B+tree root. Interior nodes list their children by key
    range, leaves their keys with each value inline or as (data file,
    offset, length). Keys are prefix-coded and relative to the prefix their
    ancestors share; manifests and nodes start with a magic number and
    length, end with a CRC-32C, and their bodies are zstd frames or plain.
    The format is tensorstore's ("OCDBT on-disk format" in its
    documentation).
  * Without OCDBT, each array is a directory of files.

Either way each leaf is a zarr v2 array named by its key path joined with
'.': `<name>/.zarray` (JSON: shape, chunks, dtype, compressor, fill_value,
order, filters, dimension_separator) and one value a chunk,
`<name>/<i>.<j>` (`<name>/0` for a 0-d array), every chunk stored at the
full chunk shape. A missing chunk takes `fill_value`.

`restore_checkpoint` rebuilds the tree as orbax restores it without a
target: dicts, lists for sequences, torch CPU tensors for arrays (bit for
bit the arrays orbax returns), Python numbers for scalars, and `{}`, `[]`
or None where orbax stored an empty node. `prefix` restores only the leaves
whose name starts with it (`"ema.params."`), so that serving a UNet decodes
its EMA weights and not the optimizer's moments.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from daclip_torch.utils import HOST_THREADS, zstd

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_NO_OFFSET = (1 << 64) - 1
# "<f8" is how orbax stores a Python float leaf
_DTYPES = {"<f4": torch.float32, "<f2": torch.float16, "bfloat16": torch.bfloat16,
           "<f8": torch.float64, "<i4": torch.int32, "<i8": torch.int64, "|u1": torch.uint8,
           "|b1": torch.bool}


class CheckpointFormatError(ValueError):
    """A checkpoint that is malformed or outside what this reader takes."""


# ---------------------------------------------------------------------------
# steps


def step_dirs(directory: str) -> List[int]:
    """The steps of a train dir: numeric subdirs holding
    `_CHECKPOINT_METADATA` (orbax's temporary dirs are skipped)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(e) for e in os.listdir(directory)
                  if e.isdigit() and os.path.isfile(
                      os.path.join(directory, e, "_CHECKPOINT_METADATA")))


def latest_step(directory: str) -> Optional[int]:
    steps = step_dirs(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# OCDBT


class _Reader:
    """Cursor over a decoded manifest or node body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise CheckpointFormatError(f"{self.what}: {why}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift, data = 0, 0, self.data
        while True:
            if self.pos >= len(data):
                self.fail("truncated varint")
            b = data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _envelope(data: bytes, magic: int, what: str, limit: int = 1 << 30) -> _Reader:
    """The body of a manifest or node: magic, length, version 0, compression
    (0 plain, 1 zstd; at most `limit` bytes decoded), body, CRC-32C of all
    before it."""
    if len(data) < 18:
        raise CheckpointFormatError(f"{what}: truncated")
    if struct.unpack(">I", data[:4])[0] != magic:
        raise CheckpointFormatError(f"{what}: bad magic number {data[:4].hex()}")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise CheckpointFormatError(f"{what}: length field does not match the data")
    if struct.unpack("<I", data[-4:])[0] != zstd.crc32c(data[:-4]):
        raise CheckpointFormatError(f"{what}: CRC-32C mismatch")
    head = _Reader(data[:-4], what)
    head.pos = 12
    if head.varint() != 0:
        head.fail("unknown format version")
    method = head.u8()
    body = data[head.pos:-4]
    if method == 1:
        try:
            body = zstd.decompress(body, limit=limit)
        except zstd.ZstdError as e:
            raise CheckpointFormatError(f"{what}: {e}") from e
    elif method != 0:
        head.fail(f"unknown compression {method}")
    return _Reader(body, what)


def _file_table(r: _Reader) -> List[str]:
    """Data file paths, relative to the database root (base path and
    relative path joined, prefix-coded on the previous path)."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the split of each path, not needed
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file prefix longer than the previous path")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the previous key")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    for c, k in zip(common, keys):
        if c > len(k):
            r.fail("subtree prefix longer than its key")
    return keys, common


def _file_ref(r: _Reader, paths: List[str], fid: int) -> str:
    if fid >= len(paths):
        r.fail(f"data file id {fid} outside its table")
    return paths[fid]


class OcdbtStore:
    """A read-only OCDBT database at `root` (the directory holding
    `manifest.ocdbt`)."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, Any] = {}
        self._lock = threading.Lock()
        r = _envelope(self._read_whole("manifest.ocdbt"), _MANIFEST_MAGIC,
                      f"{root}/manifest.ocdbt")
        r.take(16)  # uuid
        if r.varint() != 0:
            r.fail("numbered manifests are not read (orbax writes a single manifest)")
        r.varint()  # max inline value bytes
        # nodes are written up to this size: a decoded node may not pass twice it
        self.node_limit = 2 * r.varint() + (1 << 20)
        r.u8()  # version tree arity log2
        if r.varint() == 1:
            r.take(4)  # zstd level
        paths = _file_table(r)
        n = r.varint()
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        if not n:
            r.fail("no version in the manifest")
        i = max(range(n), key=gens.__getitem__)
        self._root = (None if offs[i] == _NO_OFFSET
                      else (_file_ref(r, paths, fids[i]), offs[i], lens[i], heights[i]))

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_whole(self, rel: str) -> bytes:
        path = os.path.join(self.root, rel)
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as e:
            raise CheckpointFormatError(f"cannot read {path}: {e}") from e

    def _fd(self, rel: str) -> int:
        with self._lock:
            f = self._files.get(rel)
            if f is None:
                path = os.path.normpath(os.path.join(self.root, rel))
                if not path.startswith(os.path.normpath(self.root) + os.sep):
                    raise CheckpointFormatError(f"{self.root}: data file {rel!r} outside the store")
                try:
                    f = self._files[rel] = open(path, "rb")
                except OSError as e:
                    raise CheckpointFormatError(f"cannot open {path}: {e}") from e
        return f.fileno()

    def read_range(self, rel: str, offset: int, length: int) -> bytes:
        data = os.pread(self._fd(rel), length, offset)
        if len(data) != length:
            raise CheckpointFormatError(
                f"{self.root}/{rel}: {length} bytes at {offset} past the file's end")
        return data

    def read_range_into(self, rel: str, offset: int, dst: torch.Tensor) -> None:
        """`dst.numel()` bytes at `offset` of data file `rel`, read straight
        into the contiguous uint8 tensor `dst` (no copy on the way)."""
        fd, view, done = self._fd(rel), memoryview(dst.numpy()), 0
        while done < len(view):
            n = os.preadv(fd, [view[done:]], offset + done)
            if n <= 0:
                raise CheckpointFormatError(
                    f"{self.root}/{rel}: {len(view)} bytes at {offset} past the file's end")
            done += n

    def entries(self, prefix: bytes = b"") -> Dict[bytes, Any]:
        """Every key starting with `prefix`, mapped to its value: bytes when
        inline, else (data file, offset, length)."""
        out: Dict[bytes, Any] = {}
        if self._root is not None:
            path, off, length, height = self._root
            self._visit(path, off, length, height, b"", prefix, out)
        return out

    def _visit(self, path, off, length, height, base, want, out):
        what = f"{self.root}/{path}@{off}"
        r = _envelope(self.read_range(path, off, length), _NODE_MAGIC, what, self.node_limit)
        if r.u8() != height:
            r.fail("node height does not match its reference")
        paths = _file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics
            for i in range(n):
                lo = base + keys[i]
                hi = base + keys[i + 1] if i + 1 < n else None
                if hi is not None and hi <= want:
                    continue
                if lo > want and not lo.startswith(want):
                    break
                self._visit(_file_ref(r, paths, fids[i]), offs[i], lens[i], height - 1,
                            lo[:len(base) + common[i]], want, out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            r.fail("unknown value kind")
        fids, offs = r.varints(len(indirect)), r.varints(len(indirect))
        where = dict(zip(indirect, zip(fids, offs)))
        for i in range(n):
            key = base + keys[i]
            if i in where:
                fid, o = where[i]
                value = (_file_ref(r, paths, fid), o, lengths[i])
            else:
                value = r.take(lengths[i])
            if key.startswith(want):
                out[key] = value


class _OcdbtKeys:
    """The zarr keys of an OCDBT store, read once for a prefix."""

    def __init__(self, store: OcdbtStore, prefix: str):
        self.store = store
        self.entries = store.entries(prefix.encode())

    def get(self, key: str) -> Optional[bytes]:
        v = self.entries.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        return self.store.read_range(*v)

    def read_into(self, key: str, dst: torch.Tensor) -> bool:
        """An uncompressed chunk read straight into the uint8 tensor `dst`;
        False when the key is missing."""
        v = self.entries.get(key.encode())
        if v is None:
            return False
        size = len(v) if isinstance(v, bytes) else v[2]
        if size != dst.numel():
            raise CheckpointFormatError(f"{key}: chunk of {size} bytes, {dst.numel()} expected")
        if isinstance(v, bytes):
            dst.copy_(torch.frombuffer(bytearray(v), dtype=torch.uint8))
        else:
            self.store.read_range_into(v[0], v[1], dst)
        return True


class _FileKeys:
    """The zarr keys of a `use_ocdbt: false` item: one file a key."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> Optional[bytes]:
        path = os.path.normpath(os.path.join(self.root, *key.split("/")))
        if not path.startswith(os.path.normpath(self.root) + os.sep):
            raise CheckpointFormatError(f"{self.root}: key {key!r} outside the item")
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


# ---------------------------------------------------------------------------
# zarr v2


def _fill(meta: Dict, dtype: torch.dtype):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):
        named = {"NaN": float("nan"), "Infinity": float("inf"), "-Infinity": float("-inf")}
        if v not in named:
            raise CheckpointFormatError(f"fill_value {v!r} is not read")
        return named[v]
    return v


def _array_meta(keys, name: str) -> Dict:
    raw = keys.get(f"{name}/.zarray")
    if raw is None:
        raise CheckpointFormatError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise CheckpointFormatError(f"{name}: zarr_format {meta.get('zarr_format')} is not read")
    if meta.get("dtype") not in _DTYPES:
        raise CheckpointFormatError(f"{name}: dtype {meta.get('dtype')!r} is not read "
                                    f"(read: {', '.join(_DTYPES)})")
    if meta.get("order", "C") != "C":
        raise CheckpointFormatError(f"{name}: order {meta['order']!r} is not read (only C)")
    if meta.get("filters") is not None:
        raise CheckpointFormatError(f"{name}: filters {meta['filters']!r} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise CheckpointFormatError(f"{name}: compressor {comp.get('id')!r} is not read "
                                    "(zstd or none)")
    if len(meta["chunks"]) != len(meta["shape"]) or any(c < 1 for c in meta["chunks"]):
        raise CheckpointFormatError(f"{name}: chunks {meta['chunks']} do not fit shape "
                                    f"{meta['shape']}")
    return meta


def _decode_chunk(raw: bytes, meta: Dict, out: torch.Tensor, name: str):
    """Decodes a chunk's stored bytes into the contiguous tensor `out`."""
    dst = out.view(-1).view(torch.uint8)
    try:
        if meta.get("compressor") is None:
            if len(raw) != dst.numel():
                raise CheckpointFormatError(f"{name}: chunk of {len(raw)} bytes, "
                                            f"{dst.numel()} expected")
            dst.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
        else:
            zstd.decompress_into(raw, dst)
    except zstd.ZstdError as e:
        raise CheckpointFormatError(f"{name}: {e}") from e


def read_array(keys, name: str) -> torch.Tensor:
    """A zarr v2 array as a CPU tensor, every chunk assembled (edge chunks
    cut to the shape, missing ones at `fill_value`). A chunk that is a whole
    contiguous slab of the array (the array itself, or rows of it spanning
    every other axis) decodes straight into it (stored without a
    compressor, it is read into it); others through one chunk buffer."""
    meta = _array_meta(keys, name)
    dtype, shape, chunks = _DTYPES[meta["dtype"]], list(meta["shape"]), list(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = torch.empty(shape, dtype=dtype)
    if out.numel() == 0:
        return out
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    index = [0] * len(shape)
    scratch = None
    while True:
        key = f"{name}/{sep.join(map(str, index)) if shape else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        slab = chunks == shape or (chunks[1:] == shape[1:]
                                   and region[0].stop - region[0].start == chunks[0])
        if slab and meta.get("compressor") is None and isinstance(keys, _OcdbtKeys):
            # stored bytes of a whole slab: read straight into the array
            if not keys.read_into(key, out[region].view(-1).view(torch.uint8)):
                out[region] = _fill(meta, dtype)
        elif (raw := keys.get(key)) is None:
            out[region] = _fill(meta, dtype)
        elif slab:
            _decode_chunk(raw, meta, out[region], key)
        else:
            if scratch is None:
                scratch = torch.empty(chunks, dtype=dtype)
            _decode_chunk(raw, meta, scratch, key)
            out[region] = scratch[tuple(slice(0, r.stop - r.start) for r in region)]
        for d in reversed(range(len(shape))):
            index[d] += 1
            if index[d] < grid[d]:
                break
            index[d] = 0
        else:
            return out


# ---------------------------------------------------------------------------
# the tree


def _item_dir(step_dir: str) -> str:
    for cand in (os.path.join(step_dir, "default"), step_dir):
        if os.path.isfile(os.path.join(cand, "_METADATA")):
            return cand
    raise FileNotFoundError(f"{step_dir!r} holds no orbax item (_METADATA)")


def _leaves(meta: Dict) -> Iterable[Tuple[List[Tuple[str, int]], Dict]]:
    for entry in meta["tree_metadata"].values():
        path = [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]
        yield path, entry["value_metadata"]


def _insert(tree: Dict, path: List[Tuple[str, int]], value: Any):
    node = tree
    for (key, _), (_, child_type) in zip(path[:-1], path[1:]):
        node = node.setdefault(key, {} if child_type == 2 else {"__seq__": True})
    node[path[-1][0]] = value


def _finish(node: Any) -> Any:
    """Sequences were built as dicts of their indices; make them lists."""
    if not isinstance(node, dict):
        return node
    if node.pop("__seq__", False):
        return [_finish(node[k]) for k in sorted(node, key=int)]
    return {k: _finish(v) for k, v in node.items()}


_EMPTY = {"Dict": dict, "List": list, "None": lambda: None}


def _metadata(item_dir: str) -> Dict:
    with open(os.path.join(item_dir, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise CheckpointFormatError(f"{item_dir}: zarr3 checkpoints are not read (use_zarr3: true)")
    return meta


def top_level_keys(directory: str, step: int) -> List[str]:
    """The names at the top of the tree saved at `step`, from its metadata
    alone."""
    meta = _metadata(_item_dir(os.path.join(directory, str(step))))
    return sorted({path[0][0] for path, _ in _leaves(meta)})


def restore_item(item_dir: str, prefix: str = "") -> Dict:
    """The tree of one orbax item dir (`<step>/default`), as orbax restores
    it without a target; only the leaves named from `prefix` when given."""
    meta = _metadata(item_dir)
    wanted = []
    tree: Dict = {}
    for path, value in _leaves(meta):
        if path[0][1] == 1:
            tree["__seq__"] = True
        name = ".".join(k for k, _ in path)
        if not name.startswith(prefix):
            continue
        vtype = value.get("value_type")
        if vtype in _EMPTY:
            _insert(tree, path, _EMPTY[vtype]())
        elif value.get("skip_deserialize"):
            continue
        elif vtype in ("jax.Array", "np.ndarray", "scalar"):
            wanted.append((path, name, vtype))
        else:
            raise CheckpointFormatError(f"{item_dir}: leaf {name} of type {vtype!r} is not read")
    store = OcdbtStore(item_dir) if meta.get("use_ocdbt", True) else None
    try:
        keys = _OcdbtKeys(store, prefix) if store is not None else _FileKeys(item_dir)
        with ThreadPoolExecutor(HOST_THREADS) as pool:
            arrays = list(pool.map(lambda w: read_array(keys, w[1]), wanted))
    finally:
        if store is not None:
            store.close()
    for (path, _, vtype), arr in zip(wanted, arrays):
        _insert(tree, path, arr.item() if vtype == "scalar" else arr)
    return _finish(tree)


def restore_checkpoint(directory: str, step: Optional[int] = None, prefix: str = "") -> Dict:
    """The tree saved at `step` (the latest by default) of an orbax train
    dir written by `daclip_tpu.utils.checkpoint.save_checkpoint`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return restore_item(_item_dir(os.path.join(directory, str(step))), prefix)
