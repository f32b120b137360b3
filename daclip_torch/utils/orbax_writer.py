"""Orbax checkpoints written without JAX: the write half of
`daclip_tpu/utils/checkpoint.py` (`save_checkpoint` :59, `wait_all` :36, the
drain at exit :45) and the inverse of `utils/orbax_reader.py`.

`save_checkpoint(directory, step, tree)` writes `<directory>/<step>/` as
orbax's `StandardSave` through a `CheckpointManager` does, so that
daclip_tpu's `restore_checkpoint` (with a target or without) and this
package's reader both restore it:

  * `_CHECKPOINT_METADATA`: the item's handler and the timestamps;
  * `default/_METADATA`: every leaf by its key path (`key_type` 2 for a
    dict key or a field, 1 for a sequence index) and value type, as orbax
    writes them: `jax.Array` for a tensor (with its `write_shape`),
    `scalar` for a Python int (stored `<i8`) or float (`<f8`), and the
    empty nodes `None`, `Dict` and `List` (None, `{}`, `[]`: an optax
    `EmptyState` is `None` there);
  * `default/_sharding`: each tensor's sharding, urlsafe-base64 of its name
    to the JSON that daclip_tpu's single-device runs write (a replicated
    NamedSharding on the (data, fsdp) mesh of device 0), which a restore
    without a target reads;
  * `default/array_metadatas/process_0`: each tensor's write and chunk
    shape;
  * the arrays: one OCDBT database at `default/` (`manifest.ocdbt`, one
    B+tree leaf node and every value in one data file `d/<hex>`), each leaf
    a zarr v2 array of one chunk, no compressor.

The OCDBT records are those `orbax_reader` parses: a magic number and
length, format version 0, compression 0 (plain), the body, a CRC-32C
(`zstd.crc32c`); varints, prefix-coded keys in byte order, each value an
indirect reference (data file, offset, length); the manifest holds the
config and one version whose root is the leaf node.

Every file goes into `<step>.orbax-checkpoint-tmp-<ns>`, orbax's own name
for an unfinished step dir, renamed to `<step>` at the end: both packages'
readers skip it. As orbax's manager does, a save is skipped when the
directory already holds a step at or past `step`, and `max_to_keep` then
keeps the newest step dirs, daclip_tpu's and this package's alike (the
port's `.pt` files are no step dirs).

`wait=False` copies the tree's tensors into one host buffer at once; one
background thread per directory then hands its saves in turn to a writer
process (a fresh interpreter started at the first, fed through a pipe)
and waits for each, so that two saves to one directory run in order and
never race, and the write shares no interpreter lock with the caller. A write that fails raises at the next save to
any directory, at `wait_all()`, or at exit (the drain then ends the process
with status 1).
"""
from __future__ import annotations

import atexit
import base64
import importlib
import itertools
import json
import os
import pickle
import shutil
import struct
import subprocess
import sys
import threading
import time
import traceback
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from daclip_torch.utils import HOST_THREADS, orbax_reader, zstd

HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
TMP_SUFFIX = ".orbax-checkpoint-tmp-"
# what daclip_tpu's single-device runs store for every array (its fixtures)
SHARDING = json.dumps({"sharding_type": "NamedSharding", "shape": [1, 1],
                       "axis_names": ["data", "fsdp"],
                       "axis_types": ["AxisType.Auto", "AxisType.Auto"],
                       "partition_spec": [], "device_mesh": {"mesh": [[{"id": 0}]]}})
_ZARR_DTYPES = {v: k for k, v in orbax_reader._DTYPES.items()}
_EMPTY = {type(None): "None", dict: "Dict", list: "List"}
# tensorstore's defaults, as orbax's manifests hold them
_MAX_INLINE = 1024
_MAX_NODE_BYTES = 100_000_000
_ARITY_LOG2 = 4


# ---------------------------------------------------------------------------
# the tree


def _leaves(tree: Any) -> List[Tuple[List[Tuple[str, int]], Any]]:
    """(key path, leaf) of every leaf in order: a dict's keys (type 2) and a
    list's or tuple's indices (type 1); an empty dict or list, or None, is a
    leaf of its own."""
    out = []

    def walk(node, path):
        if isinstance(node, dict) and node:
            for k, v in node.items():
                if not isinstance(k, str) or not k:
                    raise TypeError(f"{'.'.join(p for p, _ in path)}: key {k!r} is not a "
                                    "non-empty string")
                walk(v, path + [(k, 2)])
        elif isinstance(node, (list, tuple)) and node:
            for i, v in enumerate(node):
                walk(v, path + [(str(i), 1)])
        else:
            if not path:
                raise TypeError("the tree is a leaf: orbax saves a dict or a sequence")
            out.append((path, node))

    walk(tree, [])
    return out


def _value(leaf: Any, name: str) -> Tuple[Dict, Optional[torch.Tensor]]:
    """(value_metadata, the array to store or None) of one leaf."""
    if type(leaf) in _EMPTY:
        return {"value_type": _EMPTY[type(leaf)], "skip_deserialize": True}, None
    if isinstance(leaf, bool):
        raise TypeError(f"{name}: a bool leaf is not written (orbax stores none)")
    if isinstance(leaf, int):
        return ({"value_type": "scalar", "skip_deserialize": False},
                torch.tensor(leaf, dtype=torch.int64))
    if isinstance(leaf, float):
        return ({"value_type": "scalar", "skip_deserialize": False},
                torch.tensor(leaf, dtype=torch.float64))
    if torch.is_tensor(leaf):
        if leaf.dtype not in _ZARR_DTYPES:
            raise TypeError(f"{name}: dtype {leaf.dtype} is not written "
                            f"(written: {', '.join(map(str, _ZARR_DTYPES))})")
        return ({"value_type": "jax.Array", "skip_deserialize": False,
                 "write_shape": list(leaf.shape)}, leaf)
    raise TypeError(f"{name}: a leaf of type {type(leaf).__name__} is not written "
                    "(tensors, Python numbers, None, {} and [] are)")


# ---------------------------------------------------------------------------
# OCDBT


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _envelope(magic: int, body: bytes) -> bytes:
    """magic, length, version 0, compression 0, body, CRC-32C of all before."""
    head = _varint(0) + b"\x00"
    length = 4 + 8 + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return data + struct.pack("<I", zstd.crc32c(data))


def _file_table(paths: List[str]) -> bytes:
    """Data file paths relative to the database root: prefix-coded on the
    previous path, each with a base path of length 0."""
    raw = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(raw, raw[1:])]
    suffix = [len(p) - c for p, c in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(suffix) + _varints([0] * len(raw))
            + b"".join(p[c:] for p, c in zip(raw, [0] + prefix)))


def _leaf_node(data_file: str, entries: List[Tuple[bytes, int, int]]) -> bytes:
    """A B+tree leaf (height 0) holding `entries` (key, offset, length),
    sorted by key, every value indirect in data file 0."""
    keys = [k for k, _, _ in entries]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    body = (b"\x00" + _file_table([data_file]) + _varint(len(keys)) + _varints(prefix)
            + _varints(len(k) - c for k, c in zip(keys, [0] + prefix))
            + b"".join(k[c:] for k, c in zip(keys, [0] + prefix))
            + _varints(n for _, _, n in entries) + _varints([1] * len(keys))
            + _varints([0] * len(keys)) + _varints(o for _, o, _ in entries))
    return _envelope(orbax_reader._NODE_MAGIC, body)


def _manifest(data_file: str, node_offset: int, node_length: int, num_keys: int,
              value_bytes: int) -> bytes:
    """A single manifest: config (no compression), the data file, one
    version (generation 1) whose root is the leaf node, no version tree
    nodes."""
    body = (uuid.uuid4().bytes + _varint(0) + _varint(_MAX_INLINE) + _varint(_MAX_NODE_BYTES)
            + bytes([_ARITY_LOG2]) + _varint(0) + _file_table([data_file])
            + _varint(1) + _varint(1) + b"\x00" + _varint(0) + _varint(node_offset)
            + _varint(node_length) + _varint(num_keys) + _varint(node_length)
            + _varint(value_bytes) + struct.pack("<Q", time.time_ns()) + _varint(0))
    return _envelope(orbax_reader._MANIFEST_MAGIC, body)


def _zarray(t: torch.Tensor) -> bytes:
    shape = list(t.shape)
    return json.dumps({"chunks": [max(s, 1) for s in shape], "compressor": None,
                       "dimension_separator": ".", "dtype": _ZARR_DTYPES[t.dtype],
                       "fill_value": None, "filters": None, "order": "C", "shape": shape,
                       "zarr_format": 2}, separators=(",", ":"), sort_keys=True).encode()


def _raw(t: torch.Tensor) -> memoryview:
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    elif t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return memoryview(t.numpy()).cast("B")


def _write_item(item_dir: str, leaves) -> None:
    """`default/`: the metadata files and the OCDBT store of the arrays."""
    os.makedirs(os.path.join(item_dir, "d"))
    os.makedirs(os.path.join(item_dir, "array_metadatas"))
    tree_meta, sharding, array_meta, arrays = {}, {}, [], []
    for path, leaf in leaves:
        name = ".".join(k for k, _ in path)
        meta, arr = _value(leaf, name)
        tree_meta[str(tuple(k for k, _ in path))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": meta}
        if arr is None:
            continue
        arrays.append((name, arr))
        if meta["value_type"] == "jax.Array":
            sharding[base64.urlsafe_b64encode(name.encode()).decode()] = SHARDING
            array_meta.append({"array_metadata": {
                "param_name": name, "write_shape": list(arr.shape),
                "chunk_shape": list(arr.shape), "ext_metadata": None}})
    if len({n for n, _ in arrays}) != len(arrays):
        raise ValueError("two leaves share one '.'-joined name")

    # values in key order, then the node, all in one data file
    data_file = f"d/{uuid.uuid4().hex}"
    values = []
    for name, arr in arrays:
        values.append((f"{name}/.zarray".encode(), _zarray(arr)))
        if arr.numel():
            chunk = "0" if arr.dim() == 0 else ".".join("0" * arr.dim())
            values.append((f"{name}/{chunk}".encode(), _raw(arr)))
    values.sort(key=lambda kv: kv[0])
    offsets = list(itertools.accumulate((len(v) for _, v in values), initial=0))
    offset = offsets[-1]
    entries = [(key, o, len(v)) for (key, v), o in zip(values, offsets)]
    node = _leaf_node(data_file, entries)
    fd = os.open(os.path.join(item_dir, data_file), os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    try:  # the values at their offsets on several threads (the copies release the GIL)
        with ThreadPoolExecutor(HOST_THREADS) as pool:
            list(pool.map(lambda v, o: _pwrite(fd, v, o), [v for _, v in values], offsets))
        _pwrite(fd, node, offset)
    finally:
        os.close(fd)
    with open(os.path.join(item_dir, "manifest.ocdbt"), "wb") as f:
        f.write(_manifest(data_file, offset, len(node), len(entries), offset))
    _write_json(os.path.join(item_dir, "_METADATA"), {
        "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(item_dir, "_sharding"), sharding)
    _write_json(os.path.join(item_dir, "array_metadatas", "process_0"),
                {"array_metadatas": array_meta})


def _pwrite(fd: int, data, offset: int) -> None:
    view, done = memoryview(data), 0
    while done < len(view):
        done += os.pwrite(fd, view[done:], offset + done)


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(obj))  # (json.dump encodes in Python, several times slower)


def _write_step(directory: str, step: int, tree: Any, build,
                max_to_keep: Optional[int]) -> Optional[str]:
    """One save, in the calling thread: `build(tree)` (or `tree`) as the step
    dir (None when skipped, as orbax skips a step at or before its latest),
    then `max_to_keep`."""
    latest = orbax_reader.latest_step(directory)
    if latest is not None and latest >= step:
        return None
    leaves = _leaves(tree if build is None else build(tree))
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f"{step}{TMP_SUFFIX}{time.time_ns()}")
    init = time.time_ns()
    os.makedirs(tmp)
    try:
        _write_item(os.path.join(tmp, "default"), leaves)
        _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": {"default": HANDLER}, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if max_to_keep is not None:
        for old in orbax_reader.step_dirs(directory)[:-max_to_keep]:
            shutil.rmtree(os.path.join(directory, str(old)))
    return final


# ---------------------------------------------------------------------------
# the writer process


class _Packed(NamedTuple):
    """A tensor of a packed tree: its bytes at `offset` of the flat buffer."""
    dtype: torch.dtype
    shape: Tuple[int, ...]
    offset: int


_ALIGN = 64


def _pack(tree: Any) -> Tuple[Any, torch.Tensor]:
    """(skeleton, flat): every tensor of `tree` copied into one uint8 CPU
    buffer `flat` (so that the caller may change its tensors while a write
    runs), and in the skeleton replaced by where it lies there."""
    tensors: List[torch.Tensor] = []

    def skeleton(node, offset):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                out[k], offset = skeleton(v, offset)
            return out, offset
        if isinstance(node, (list, tuple)):
            out = []
            for v in node:
                leaf, offset = skeleton(v, offset)
                out.append(leaf)
            return out, offset
        if torch.is_tensor(node):
            tensors.append(node)
            packed = _Packed(node.dtype, tuple(node.shape), offset)
            return packed, offset + -(-node.numel() * node.element_size() // _ALIGN) * _ALIGN
        return node, offset

    skel, size = skeleton(tree, 0)
    flat = torch.empty(size, dtype=torch.uint8)
    for t, view in zip(tensors, _views(flat, tensors)):
        view.copy_(t.detach())
    return skel, flat


def _views(flat: torch.Tensor, tensors) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(flat[offset:offset + n].view(t.dtype).view(t.shape))
        offset += -(-n // _ALIGN) * _ALIGN
    return out


def _unpack(node: Any, flat: torch.Tensor) -> Any:
    """The tree of `_pack`'s skeleton, each tensor a view of `flat`."""
    if isinstance(node, _Packed):
        n = torch.Size(node.shape).numel() * torch.empty((), dtype=node.dtype).element_size()
        return flat[node.offset:node.offset + n].view(node.dtype).view(node.shape)
    if isinstance(node, dict):
        return {k: _unpack(v, flat) for k, v in node.items()}
    if isinstance(node, list):
        return [_unpack(v, flat) for v in node]
    return node


def _send(f, obj: Any) -> None:
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)))
    f.write(data)
    f.flush()


def _recv(f) -> Any:
    head = f.read(8)
    if len(head) < 8:
        raise EOFError
    return pickle.loads(_read_exactly(f, struct.unpack("<Q", head)[0]))


def _read_exactly(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) < n:
        raise EOFError
    return data


def _read_into(f, flat: torch.Tensor) -> None:
    view, done = memoryview(flat.numpy()), 0
    while done < len(view):
        got = f.readinto(view[done:])
        if not got:
            raise EOFError
        done += got


def _serve() -> None:
    """The writer process: the modules named in its arguments imported, then
    each request on stdin ({directory, step, skeleton, build, max_to_keep,
    bytes}, then the flat buffer) written by `_write_step`, its result or
    exception sent back on stdout, until stdin closes."""
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # what a build prints stays off the results' pipe
    for name in sys.argv[1:]:
        importlib.import_module(name)
    while True:
        try:
            req = _recv(inp)
            flat = torch.empty(req["bytes"], dtype=torch.uint8)
            _read_into(inp, flat)
        except EOFError:
            return
        try:
            res = (True, _write_step(req["directory"], req["step"], _unpack(req["skeleton"], flat),
                                     req["build"], req["max_to_keep"]), "")
        except BaseException as e:
            res = (False, e, traceback.format_exc())
        del flat
        try:
            _send(out, res)
        except Exception:  # an exception that does not pickle
            _send(out, (False, None, res[2]))


class _WriterProcess:
    """One process of this interpreter that writes the async saves, started
    at the first; saves reach it one at a time."""

    def __init__(self):
        self.lock = threading.Lock()
        self.proc: Optional[subprocess.Popen] = None

    def start(self, preload=()) -> None:
        """Start the process unless it runs (call with the lock held)."""
        if self.proc is not None and self.proc.poll() is None:
            return
        # this package first, then what this interpreter imports from (a
        # build is pickled by its module's name)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in sys.path if p and os.path.isdir(p)]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "from daclip_torch.utils.orbax_writer import _serve; _serve()",
             *preload], stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    def write(self, directory: str, step: int, packed, build,
              max_to_keep: Optional[int]) -> Optional[str]:
        skeleton, flat = packed
        where = os.path.join(directory, str(step))
        with self.lock:
            self.start()
            try:
                _send(self.proc.stdin, {"directory": directory, "step": step,
                                        "skeleton": skeleton, "build": build,
                                        "max_to_keep": max_to_keep, "bytes": flat.numel()})
                self.proc.stdin.write(memoryview(flat.numpy()))
                self.proc.stdin.flush()
                del flat, packed
                ok, value, tb = _recv(self.proc.stdout)
            except (EOFError, BrokenPipeError) as e:
                status = self.proc.wait()
                raise RuntimeError(f"the process writing {where} ended with status {status} "
                                   "and no result") from e
        if ok:
            return value
        if value is None:  # an exception that does not pickle
            raise RuntimeError(f"writing {where} failed:\n{tb}")
        value.add_note(f"(in the process writing {where})\n{tb}")
        raise value

    def close(self) -> None:
        with self.lock:
            if self.proc is not None:
                self.proc.stdin.close()
                self.proc.wait()
                self.proc.stdout.close()
                self.proc = None


_process = _WriterProcess()


def start_writer(preload: Tuple[str, ...] = ()) -> None:
    """Start the writer process of the async saves now, importing the
    modules in `preload` (those of the builds to come), so that the first
    `wait=False` save waits for neither; nothing when it runs."""
    with _process.lock:
        _process.start(preload)


def _write_step_in_process(directory: str, step: int, packed, build,
                           max_to_keep: Optional[int]) -> Optional[str]:
    """`_write_step` of a `_pack`ed tree in the writer process, which the
    calling thread waits for. The build and the write run Python between
    their copies; in a thread of the training process they took the
    interpreter lock from a host-bound loop, whose step took 2-3x as long
    on the card until the write ended, and a child forked for the write
    held it while the fork copied the page tables of a process of many GB. The writer process is a fresh interpreter: the
    tree reaches it through a pipe, and `build` and the tree's other
    leaves by pickle."""
    return _process.write(directory, step, packed, build, max_to_keep)


# ---------------------------------------------------------------------------
# saves, in order a directory


class _DirWriter:
    """One background thread of one directory's saves, and their futures."""

    def __init__(self):
        self.pool = ThreadPoolExecutor(1, thread_name_prefix="orbax-writer")
        self.pending: List[Future] = []
        self.lock = threading.Lock()

    def submit(self, fn, *args) -> Future:
        with self.lock:
            fut = self.pool.submit(fn, *args)
            self.pending.append(fut)
        return fut

    def join(self) -> None:
        """Wait for every pending save, then raise the first that failed."""
        with self.lock:
            pending, self.pending = self.pending, []
        for fut in pending:
            fut.exception()
        for fut in pending:
            fut.result()

    def raise_failed(self) -> None:
        """Raise now if a finished save failed (unfinished ones stay)."""
        with self.lock:
            done = [f for f in self.pending if f.done()]
            self.pending = [f for f in self.pending if f not in done]
        for fut in done:
            fut.result()


_writers: Dict[str, _DirWriter] = {}
_writers_lock = threading.Lock()


def _writer(directory: str) -> _DirWriter:
    with _writers_lock:
        key = os.path.abspath(directory)
        if key not in _writers:
            _writers[key] = _DirWriter()
        return _writers[key]


def save_checkpoint(directory: str, step: int, tree: Any, max_to_keep: Optional[int] = None,
                    wait: bool = True, build=None) -> str:
    """Write `tree` (nested dicts and lists of tensors, Python numbers and
    empty nodes, in daclip_tpu's tree layout), or `build(tree)` when a
    `build` function is given, as the orbax step dir `<directory>/<step>/`,
    then keep its newest `max_to_keep` step dirs (all when None); returns
    the step dir's path. `wait=False` returns once `tree`'s tensors are
    copied to the host, the build and the write running in the writer
    process behind the directory's earlier saves (`build` and the tree's
    leaves other than tensors must pickle); a save that failed before
    raises here first. The save is skipped, as orbax's is, when the
    directory already holds a step at or past `step`."""
    for w in list(_writers.values()):
        w.raise_failed()
    writer = _writer(directory)
    if wait:
        fut = writer.submit(_write_step, directory, int(step), tree, build, max_to_keep)
        writer.join()
        fut.result()
    else:
        try:  # refused here, not in the writer's thread
            pickle.dumps(build)
        except Exception as e:
            raise TypeError(f"{os.path.join(directory, str(int(step)))}: an async save's build "
                            f"runs in the writer process and must pickle: {e}") from e
        writer.submit(_write_step_in_process, directory, int(step), _pack(tree), build,
                      max_to_keep)
    return os.path.join(directory, str(int(step)))


def wait_all() -> None:
    """Join every pending write; raises the first that failed."""
    errors = []
    for w in list(_writers.values()):
        try:
            w.join()
        except Exception as e:  # every directory is joined before raising
            errors.append(e)
    if errors:
        raise errors[0]


def _drain_at_exit() -> None:
    try:
        wait_all()
        _process.close()
    except Exception:
        traceback.print_exc()
        sys.stderr.write("orbax_writer: a checkpoint write failed; exiting with status 1\n")
        sys.stderr.flush()
        os._exit(1)


atexit.register(_drain_at_exit)
