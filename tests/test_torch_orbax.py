"""daclip_tpu's orbax train dirs read by the port without JAX, on the CPU.

  * zstd (`daclip_torch/native/zstd.cc` through `utils/zstd.py`) against the
    `zstandard` package: levels -5 to 22, with and without the checksum and
    the content size, inputs from 0 B to 1 MiB, several and skippable
    frames, a bounded hypothesis fuzz, and malformed frames that raise;
  * OCDBT and zarr v2 (`utils/orbax_reader.py`) against tensorstore and
    daclip_tpu's `restore_checkpoint`, bit for bit, on trees written by
    orbax: every dtype and empty node, several chunks and data files, AdamW
    state, several steps, a tree sharded over 4 devices, a `use_ocdbt=False`
    dir, B+tree interior nodes, edge and missing chunks;
  * the committed fixture (`tests/fixtures/orbax`, written by daclip_tpu's
    own CLIs, `scripts/torch_orbax_fixture.py`) through every entry point
    that loads a train dir, against daclip_tpu's loaders and its stored
    restore, and in a process that cannot import jax, orbax, tensorstore
    or zstandard.
"""
import functools
import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from daclip_torch import pipeline as tpipe
from daclip_torch.convert import daclip_state_dict_from_jax, unet_state_dict_from_jax
from daclip_torch.utils import native_checkpoint as tnc
from daclip_torch.utils import orbax_reader, zstd
from daclip_tpu import pipeline as jpipe
from daclip_tpu.utils import checkpoint as jckpt
from daclip_tpu.utils import native_checkpoint as jnc

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "orbax"
NAME = "daclip_test-tiny"


def _psnr(a, b):  # tests/test_torch_checkpoint.py's restore bound: > 40 dB
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


# -- zstd -------------------------------------------------------------------------
def _inputs():
    rng = np.random.default_rng(0)
    text = b"".join((REPO / p).read_bytes() for p in (
        "README.md", "ROADMAP.md", "daclip_torch/native/zstd.cc", "daclip_torch/pipeline.py",
        "daclip_tpu/pipeline.py", "daclip_torch/data/native_io.py"))
    return {"empty": b"", "one": b"\x7f", "rand_128k-1": rng.bytes(128 * 1024 - 1),
            "rand_128k": rng.bytes(128 * 1024), "rand_128k+1": rng.bytes(128 * 1024 + 1),
            "rand_1m": rng.bytes(1 << 20), "zero_1m": bytes(1 << 20),
            "text": (text * (1 + (1 << 20) // len(text)))[:1 << 20],
            "f32_weights": (0.02 * rng.standard_normal(1 << 18)).astype(np.float32).tobytes()}


INPUTS = _inputs()


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
def test_zstd_equals_zstandard(level):
    for checksum in (False, True):
        for content_size in (False, True):
            c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                         write_content_size=content_size)
            for name, data in INPUTS.items():
                if level >= 19 and name == "rand_1m" and not (checksum and content_size):
                    continue  # 0.25 s a compression; raw blocks, as at every level
                frame = c.compress(data)
                assert zstd.decompress(frame) == data, (name, checksum, content_size)
                assert zstd.content_size(frame) == (len(data) if content_size else None)
                out = torch.empty(len(data), dtype=torch.uint8)
                zstd.decompress_into(frame, out)
                assert out.numpy().tobytes() == data


def test_zstd_streamed_frames_several_and_skippable():
    """Frames of a stream (no content size, blocks as written), several in a
    row, skippable frames between them."""
    parts = [INPUTS["text"][:300_000], INPUTS["rand_128k+1"], b"", INPUTS["f32_weights"]]
    frames = []
    for i, part in enumerate(parts):
        cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
        frames.append(cobj.compress(part[:1000]) + cobj.compress(part[1000:]) + cobj.flush())
        frames.append((0x184D2A50 + i).to_bytes(4, "little") + (5).to_bytes(4, "little")
                      + b"skip!")
    data = b"".join(frames)
    assert zstd.content_size(data) is None
    assert zstd.decompress(data) == b"".join(parts)
    out = torch.empty(sum(map(len, parts)), dtype=torch.uint8)
    assert zstd.decompress_into(data, out).numpy().tobytes() == b"".join(parts)
    with pytest.raises(zstd.ZstdError):  # one byte short of the output
        zstd.decompress_into(data, torch.empty(out.numel() - 1, dtype=torch.uint8))
    with pytest.raises(zstd.ZstdError):  # one byte more than the output
        zstd.decompress_into(data, torch.empty(out.numel() + 1, dtype=torch.uint8))


def test_zstd_malformed_frames_raise():
    data = INPUTS["text"][:200_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    rng = np.random.default_rng(1)
    for pos in rng.integers(4, len(frame), 64):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(bad))
    for cut in (1, 3, 5, 7, len(frame) // 2, len(frame) - 5, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])
    wrong = frame[:-4] + bytes(b ^ 0xFF for b in frame[-4:])
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(wrong)
    # frame header: a window byte, then a one-byte dictionary ID of 5
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(b"\x28\xb5\x2f\xfd" + bytes([0x01, 0x00, 0x05]) + b"\x01\x00\x00")
    reserved = bytearray(frame)
    reserved[4] |= 0x08
    with pytest.raises(zstd.ZstdError, match="reserved"):
        zstd.decompress(bytes(reserved))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(data=st.binary(max_size=3000), level=st.sampled_from([-3, 1, 5, 19]),
       flips=st.lists(st.tuples(st.integers(0, 1 << 16), st.integers(0, 7)), max_size=3))
def test_zstd_hypothesis_roundtrip_and_mutants(data, level, flips):
    """Any input round-trips; a mutant of its frame decodes or raises
    ZstdError, and never gives a wrong output when the checksum is on."""
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data * 3)
    assert zstd.decompress(frame) == data * 3
    bad = bytearray(frame)
    for pos, bit in flips:
        bad[pos % len(bad)] ^= 1 << bit
    try:
        got = zstd.decompress(bytes(bad), limit=1 << 20)
    except zstd.ZstdError:
        return
    assert got == data * 3 or not flips


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0


# -- OCDBT and zarr against tensorstore and restore_checkpoint -------------------------
def _flat(tree, prefix=""):
    """(path, kind, value) of every node, dict keys in sorted order: arrays
    (numpy, JAX or torch) by dtype name, shape and bytes."""
    if isinstance(tree, dict):
        yield prefix, "dict", sorted(tree)
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        yield prefix, "seq", len(tree)
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    elif tree is None or isinstance(tree, (int, float)):
        yield prefix, type(tree).__name__, tree
    elif torch.is_tensor(tree):
        a = tree.view(torch.int16) if tree.dtype == torch.bfloat16 else tree
        yield prefix, str(tree.dtype).replace("torch.", ""), (tuple(tree.shape),
                                                              a.numpy().tobytes())
    else:
        a = np.asarray(tree)
        raw = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        yield prefix, str(a.dtype), (a.shape, raw.tobytes())


def assert_same_tree(directory, step=None, prefix=""):
    """The port's restore of every leaf equals daclip_tpu's, bit for bit."""
    want = list(_flat(jckpt.restore_checkpoint(str(directory), step=step)))
    got = list(_flat(orbax_reader.restore_checkpoint(str(directory), step)))
    assert [w[:2] for w in want] == [g[:2] for g in got]
    assert want == got


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(rng.standard_normal((96, 40)), jnp.float32),
                       "b16": jnp.asarray(rng.standard_normal((7, 3)), jnp.bfloat16),
                       "ids": jnp.arange(11, dtype=jnp.int32) - 5,
                       "h": jnp.asarray(rng.standard_normal((3,)), jnp.float16),
                       "mask": jnp.asarray(rng.random(5) > 0.5),
                       "u8": jnp.asarray(rng.integers(0, 255, (2, 2)), jnp.uint8)},
            "seq": [jnp.ones((2, 3)), {"deep": jnp.zeros((1,))}, jnp.asarray(2.5)],
            "step": jnp.asarray(seed, jnp.int32), "count": 7, "lr": 0.25,
            "empty": {}, "empty_list": [], "none": None}


def test_trees_saved_by_save_checkpoint_equal_restore_checkpoint(tmp_path):
    """f32, bf16, f16, i32, bool, u8, 0-d, Python scalars, empty nodes,
    nesting through sequences, several steps and a chunk past the inline
    limit (its own data file)."""
    big = {"big": jnp.asarray(np.random.default_rng(3).standard_normal((300, 900)),
                              jnp.float32)}
    for step in (5, 10, 15):
        jckpt.save_checkpoint(str(tmp_path / "run"), step, dict(_tree(step), **big))
    jckpt.wait_all()
    assert orbax_reader.step_dirs(str(tmp_path / "run")) == [5, 10, 15]
    assert orbax_reader.latest_step(str(tmp_path / "run")) == jckpt.latest_step(
        str(tmp_path / "run")) == 15
    for step in (None, 5, 10):
        assert_same_tree(tmp_path / "run", step)
    # orbax's temporary dirs and step dirs without metadata are not steps
    (tmp_path / "run" / "20.orbax-checkpoint-tmp-3").mkdir()
    (tmp_path / "run" / "25").mkdir()
    assert orbax_reader.latest_step(str(tmp_path / "run")) == 15
    part = orbax_reader.restore_checkpoint(str(tmp_path / "run"), prefix="params.")
    assert set(part) == {"params"} and set(part["params"]) == set(_tree(0)["params"])


def test_optax_adamw_state_and_sharded_leaves(tmp_path):
    """AdamW's state (namedtuples, an empty state), and leaves sharded over
    4 devices, so that each is several chunks smaller than its shape."""
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    params = {"k": jnp.asarray(np.random.default_rng(0).standard_normal((64, 24)), jnp.float32),
              "b": jnp.zeros((24,), jnp.float32)}
    opt = optax.adamw(1e-3)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: p * 0.1 + 0.01, params)
    _, state = opt.update(grads, state, params)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    sharded = {"rows": jax.device_put(jnp.arange(64 * 6, dtype=jnp.float32).reshape(64, 6),
                                      NamedSharding(mesh, P("x"))),
               "grid": jax.device_put(jnp.asarray(np.random.default_rng(1).standard_normal(
                   (10, 8)), jnp.bfloat16), NamedSharding(mesh, P("x", "y")))}
    jckpt.save_checkpoint(str(tmp_path / "run"), 1, {"params": params, "opt_state": state,
                                                     "sharded": sharded})
    jckpt.wait_all()
    item = tmp_path / "run" / "1" / "default"
    meta = json.loads(orbax_reader.OcdbtStore(str(item)).entries(b"sharded.grid/")[
        b"sharded.grid/.zarray"])
    assert meta["chunks"] == [5, 4] and meta["shape"] == [10, 8]
    assert_same_tree(tmp_path / "run")


def test_multi_file_leaf_uncompressed_and_use_ocdbt_false(tmp_path):
    """A leaf of many chunks spread over several data files (the data-file
    table prefix-coded), chunks without a compressor, and a dir whose
    arrays are files (`use_ocdbt: false`)."""
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(2)
    tree = {"w": jnp.asarray(rng.standard_normal((64, 256)), jnp.float32),
            "v": jnp.asarray(rng.standard_normal((33, 7)), jnp.bfloat16),
            "s": jnp.asarray(3, jnp.int32)}
    args = {"w": ocp.SaveArgs(chunk_byte_size=8 * 1024), "v": ocp.SaveArgs(),
            "s": ocp.SaveArgs()}
    cases = {"multi": ocp.PyTreeCheckpointHandler(),
             "plain": ocp.PyTreeCheckpointHandler(use_compression=False),
             "files": ocp.PyTreeCheckpointHandler(use_ocdbt=False)}
    for name, handler in cases.items():
        with ocp.Checkpointer(handler) as ckptr:
            ckptr.save(tmp_path / name / "1" / "default", args=ocp.args.PyTreeSave(
                tree, save_args=args, ocdbt_target_data_file_size=16 * 1024))
        (tmp_path / name / "1" / "_CHECKPOINT_METADATA").write_text("{}")
        want = ocp.PyTreeCheckpointer().restore(tmp_path / name / "1" / "default")
        got = orbax_reader.restore_checkpoint(str(tmp_path / name))
        assert list(_flat(want)) == list(_flat(got)), name
    store = orbax_reader.OcdbtStore(str(tmp_path / "multi" / "1" / "default"))
    files = {v[0] for v in store.entries(b"w/").values() if isinstance(v, tuple)}
    assert len(files) > 2, files
    meta = json.loads(store.entries()[b"w/.zarray"])
    assert meta["chunks"] != meta["shape"]
    plain = orbax_reader.OcdbtStore(str(tmp_path / "plain" / "1" / "default"))
    assert json.loads(plain.entries()[b"w/.zarray"])["compressor"] is None
    assert (tmp_path / "files" / "1" / "default" / "w" / ".zarray").is_file()


@pytest.mark.parametrize("node_bytes,key", [
    (300, lambda i: f"k{i % 7}/{i:04d}/{'x' * (i % 5)}"),
    # long prefixes shared at every level: keys relative to their ancestors'
    (200, lambda i: f"params.level{i % 3}.block_with_long_name/sub{i % 4}/item{i:03d}")])
def test_ocdbt_interior_nodes_against_tensorstore(tmp_path, node_bytes, key):
    """Stores whose trees have interior nodes (small node limits), inline
    and indirect values: every key and value as tensorstore reads them, and
    prefixes that prune subtrees."""
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/db/",
            "config": {"max_decoded_node_bytes": node_bytes, "max_inline_value_bytes": 8}}
    kv = ts.KvStore.open(spec).result()
    with ts.Transaction() as txn:
        for i in range(120):
            kv.with_transaction(txn)[key(i)] = bytes([i]) * (i % 23)
    reader = ts.KvStore.open(f"file://{tmp_path}/db/").result()
    assert ts.ocdbt.dump(reader).result()["versions"][-1]["root_height"] > 1
    with orbax_reader.OcdbtStore(str(tmp_path / "db")) as store:
        got = store.entries()
        keys = kv.list().result()
        assert sorted(got) == sorted(keys)
        for k, v in got.items():
            value = v if isinstance(v, bytes) else store.read_range(*v)
            assert value == kv.read(k).result().value
        for prefix in (key(3)[:3].encode(), key(5)[:-3].encode(), key(7).encode(), b"zz"):
            assert sorted(store.entries(prefix)) == sorted(k for k in keys
                                                           if k.startswith(prefix))


def test_zarr_edge_chunks_missing_chunks_and_fill_values(tmp_path):
    """Arrays tensorstore writes as zarr v2 files: edge chunks past the
    shape, a chunk never written (read as fill_value), '/' separators."""
    import tensorstore as ts

    cases = [("f32", "<f4", [10, 7], [4, 3], 1.5, "."),
             ("i64", "<i8", [9], [4], 7, "/"),
             ("nan", "<f4", [5, 5], [2, 5], "NaN", "."),
             ("bool", "|b1", [6, 2], [4, 1], True, ".")]
    for name, dtype, shape, chunks, fill, sep in cases:
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/{name}",
                       "metadata": {"dtype": dtype, "shape": shape, "chunks": chunks,
                                    "fill_value": fill, "dimension_separator": sep,
                                    "compressor": {"id": "zstd", "level": 3}}},
                      create=True).result()
        full = np.random.default_rng(0).standard_normal(shape) * 10
        full = full.astype(arr.dtype.numpy_dtype)
        region = tuple(slice(0, s - 1) for s in shape)  # leaves the last chunk(s) unwritten
        arr[region] = full[region]
        want = arr.read().result()
        got = orbax_reader.read_array(orbax_reader._FileKeys(str(tmp_path)), name)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("change,match", [
    (lambda m: m.update(dtype="<c8"), "dtype"),
    (lambda m: m.update(order="F"), "order"),
    (lambda m: m.update(filters=[{"id": "delta", "dtype": "<f4"}]), "filters"),
    (lambda m: m.update(compressor={"id": "blosc"}), "blosc"),
    (lambda m: m.update(zarr_format=3), "zarr_format"),
])
def test_zarr_metadata_outside_the_reader_is_refused_by_name(tmp_path, change, match):
    (tmp_path / "a").mkdir()
    meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
            "compressor": None, "fill_value": 0, "order": "C", "filters": None}
    change(meta)
    (tmp_path / "a" / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(orbax_reader.CheckpointFormatError, match=match):
        orbax_reader.read_array(orbax_reader._FileKeys(str(tmp_path)), "a")


def test_corrupt_store_and_zarr3_are_refused(tmp_path):
    shutil.copytree(FIXTURE / "daclip", tmp_path / "run")
    item = tmp_path / "run" / "1" / "default"
    manifest = bytearray((item / "manifest.ocdbt").read_bytes())
    manifest[20] ^= 0x10
    (item / "manifest.ocdbt").write_bytes(bytes(manifest))
    with pytest.raises(orbax_reader.CheckpointFormatError, match="CRC-32C"):
        orbax_reader.restore_checkpoint(str(tmp_path / "run"))
    meta = json.loads((item / "_METADATA").read_text())
    meta["use_zarr3"] = True
    (item / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(orbax_reader.CheckpointFormatError, match="zarr3"):
        orbax_reader.restore_checkpoint(str(tmp_path / "run"))
    with pytest.raises(FileNotFoundError):
        orbax_reader.restore_checkpoint(str(tmp_path / "nothing"))


# -- the committed fixture through the entry points -----------------------------------
@pytest.mark.parametrize("name,step", [("restoration", None), ("restoration", 2),
                                       ("daclip", None)])
def test_load_train_tree_equals_jax(name, step):
    ours, s = tnc.load_train_tree(str(FIXTURE / name), step)
    want, ws = jnc.load_train_tree(str(FIXTURE / name), step)
    assert s == ws
    assert list(_flat(want)) == list(_flat(ours))


def test_fixture_leaves_equal_the_stored_digests():
    """The digests the generator took from daclip_tpu's restore."""
    stored = json.loads((FIXTURE / "leaves.json").read_text())
    for name in ("restoration", "daclip"):
        tree, _ = tnc.load_train_tree(str(FIXTURE / name))
        got = {}
        for key, kind, value in _flat(tree):
            if kind in ("dict", "seq"):
                continue
            if kind in ("int", "float", "NoneType"):
                got[key[:-1]] = {"scalar": value}
            else:
                shape, raw = value
                got[key[:-1]] = {"dtype": kind, "shape": list(shape),
                                 "sha256": hashlib.sha256(raw).hexdigest()}
        assert got == stored[name]


@functools.lru_cache(maxsize=None)
def _jax_unet(path: str, use_ema: bool):
    """daclip_tpu's `load_restoration_params` of a fixture path, once."""
    return jnc.load_restoration_params(str(FIXTURE / path), use_ema=use_ema)


@pytest.mark.parametrize("path,use_ema", [("restoration", True), ("restoration", False),
                                          ("restoration/2", True)])
def test_unet_params_equal_jax(path, use_ema):
    """`load_restoration_params`, and `load_unet_any`'s state dict and
    arch, as daclip_tpu's `load_unet_any` reads the same params."""
    ours, s = tnc.load_restoration_params(str(FIXTURE / path), use_ema=use_ema)
    want, ws = _jax_unet(path, use_ema)
    assert s == ws == (2 if path.endswith("2") else 4)
    assert list(_flat(want)) == list(_flat(ours))
    sd, arch = tnc.load_unet_any(str(FIXTURE / path), use_ema=use_ema)
    assert arch == jnc.infer_unet_arch_from_params(want)
    want_sd = unet_state_dict_from_jax(jax.tree.map(np.asarray, want),
                                       depth=len(arch["ch_mult"]))
    assert sd.keys() == want_sd.keys()
    assert all(torch.equal(sd[k], want_sd[k]) for k in sd)


def test_daclip_params_equal_jax():
    ours, s = tnc.load_daclip_train_params(str(FIXTURE / "daclip"))
    want, ws = jnc.load_daclip_train_params(str(FIXTURE / "daclip"))
    assert s == ws == 1
    assert list(_flat(want)) == list(_flat(ours))
    sd = tnc.load_daclip_any(str(FIXTURE / "daclip" / "1"), step=1)
    want_sd = daclip_state_dict_from_jax(jax.tree.map(np.asarray, jnc.load_daclip_any(
        str(FIXTURE / "daclip"), step=1)))
    assert sd.keys() == want_sd.keys()
    assert all(torch.equal(sd[k], want_sd[k]) for k in sd)
    with pytest.raises(ValueError, match="restoration train dir"):
        tnc.load_restoration_params(str(FIXTURE / "daclip"))


@pytest.mark.parametrize("unet,use_ema", [("restoration", True), ("restoration", False),
                                          ("restoration/2", True)])
def test_restorer_loads_the_fixture_as_jax(unet, use_ema):
    """`DACLIPRestorer.load` and `from_train_dir` on both dirs: the UNet's
    weights those of daclip_tpu's params; for the latest EMA UNet, the
    contexts against daclip_tpu's `load` unpacked in the same order, and the
    restore through daclip_tpu's noise bank within
    tests/test_torch_checkpoint.py's bound of its stored restore."""
    expected = np.load(FIXTURE / "expected.npz")
    kw = dict(model_name=NAME, T=int(expected["T"]), dtype="float32")
    ours = tpipe.DACLIPRestorer.load(str(FIXTURE / unet), str(FIXTURE / "daclip"),
                                     tpipe.RestorerConfig(**kw), use_ema=use_ema, device="cpu")
    params = _jax_unet(unet, use_ema)[0]
    want = unet_state_dict_from_jax(
        jax.tree.map(np.asarray, params),
        depth=len(jnc.infer_unet_arch_from_params(params)["ch_mult"]))
    for restorer in (ours, tpipe.DACLIPRestorer.from_train_dir(
            str(FIXTURE / unet), str(FIXTURE / "daclip"), tpipe.RestorerConfig(**kw),
            use_ema=use_ema, device="cpu")):
        got = restorer.unet.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    if not (unet == "restoration" and use_ema):
        return
    ref = jpipe.DACLIPRestorer.load(str(FIXTURE / unet), str(FIXTURE / "daclip"),
                                    jpipe.RestorerConfig(**kw))
    lq = expected["lq"]
    ictx, tctx = ours.contexts(lq)
    jictx, jtctx = ref.contexts(lq)
    np.testing.assert_allclose(ictx.numpy(), np.asarray(jictx), atol=1e-4)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jtctx), atol=1e-4)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))
    with torch.no_grad():
        out = ours.sde.reverse_posterior(ours.unet, nchw(expected["x_T"]), nchw(lq[None]),
                                         noises=nchw(expected["noises"]), text_context=tctx,
                                         image_context=ictx)
    assert _psnr(out[0].numpy().transpose(1, 2, 0), expected["ref_out"]) > 40.0


def test_factory_takes_the_daclip_dir():
    """daclip_tpu's `create_model(pretrained=<train dir>)` takes
    `load_daclip_any`'s params over its seeded ones, the predictor dropped
    (factory.py:121-140); the port's model holds those weights."""
    from daclip_torch.factory import create_model

    model = create_model(NAME, pretrained=str(FIXTURE / "daclip"))
    params = dict(jnc.load_daclip_any(str(FIXTURE / "daclip")))
    params.pop("predictor", None)
    want = daclip_state_dict_from_jax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.fixture(scope="module")
def npz_twin(tmp_path_factory):
    """The fixture's DA-CLIP as the `.npz` daclip_tpu's save_params_npz
    writes: the port's tools already equal daclip_tpu's on it."""
    d = tmp_path_factory.mktemp("twin")
    params, _ = jnc.load_daclip_train_params(str(FIXTURE / "daclip"))
    return jnc.save_params_npz(str(d / "daclip.npz"), jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def class_tree(tmp_path_factory):
    from daclip_torch.data import png

    root = tmp_path_factory.mktemp("classes")
    rng = np.random.RandomState(3)
    for c in ("noisy", "blurry"):
        (root / c / "LQ").mkdir(parents=True)
        for i in range(2):
            png.write(str(root / c / "LQ" / f"{i}.png"),
                      (rng.rand(40, 36, 3) * 255).astype(np.uint8))
    return root


def test_eval_clis_and_encode_folder_take_the_daclip_dir(npz_twin, class_tree, tmp_path):
    from daclip_torch.eval import evaluate_daclip, evaluate_numclip
    from daclip_torch.tools import encode_folder

    results = {}
    for ckpt, out in ((str(FIXTURE / "daclip"), "dir"), (npz_twin, "npz")):
        results[out] = evaluate_daclip.evaluate_checkpoint(
            ckpt, str(class_tree), NAME, out_dir=str(tmp_path / f"ed_{out}"),
            display_name="x", device="cpu")
        encode_folder.encode_folder(ckpt, str(class_tree), str(tmp_path / f"enc_{out}"), NAME,
                                    device="cpu")
    assert json.dumps(results["dir"], sort_keys=True, default=str) == json.dumps(
        results["npz"], sort_keys=True, default=str)
    # evaluate_numclip loads through the same `eval.load_daclip`
    numclip = evaluate_numclip.evaluate_checkpoint(
        str(FIXTURE / "daclip"), str(class_tree), NAME, out_dir=str(tmp_path / "en"),
        display_name="x", device="cpu")
    assert numclip and json.dumps(numclip, default=str)
    for f in ("all_embeddings.npy", "labels.npy", "filenames.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "enc_dir" / f),
                                      np.load(tmp_path / "enc_npz" / f))


@pytest.mark.parametrize("path", ["restoration", "restoration/2", "daclip"])
def test_inspect_checkpoint_lists_the_tree_as_jax(path):
    from daclip_torch.tools import inspect_checkpoint as t_inspect
    from daclip_tpu.tools import inspect_checkpoint as j_inspect

    lines = {}
    for pkg, mod in (("jax", j_inspect), ("torch", t_inspect)):
        tree, fmt = mod.load_tree(str(FIXTURE / path))
        lines[pkg] = [fmt]
        lines[pkg].append(mod.describe(tree, fmt, keys_only=True, _print=lines[pkg].append))
        arrays = []
        mod.describe(tree, fmt, _print=arrays.append)
        lines[pkg] += [ln for ln in arrays if "[" not in ln]  # a list's repr differs
    assert lines["torch"] == lines["jax"]


def test_predict_cli_restores_with_the_fixture(tmp_path):
    from daclip_torch.cli import predict
    from daclip_torch.data import png

    expected = np.load(FIXTURE / "expected.npz")
    png.write(str(tmp_path / "lq.png"), (expected["lq"] * 255).astype(np.uint8))
    predict.main(["-i", str(tmp_path / "lq.png"), "-o", str(tmp_path / "out"),
                  "--checkpoint", str(FIXTURE / "restoration"), "--daclip",
                  str(FIXTURE / "daclip"), "--model-name", NAME, "--T", "3", "--device", "cpu"])
    out = png.decode((tmp_path / "out" / "lq.png").read_bytes())
    assert out.shape == (32, 32, 3)
    with pytest.raises(SystemExit):
        predict.main(["-i", str(tmp_path / "lq.png"), "--checkpoint", str(tmp_path),
                      "--device", "cpu"])


_NO_JAX = r"""
import hashlib, json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'tensorstore', 'zstandard', 'flax',
                                  'optax', 'daclip_tpu'):
            raise ImportError(f'{name} is blocked')
sys.meta_path.insert(0, Block())
import numpy as np, torch
from daclip_torch import pipeline
from daclip_torch.utils import native_checkpoint as nc
F = sys.argv[1]
stored = json.load(open(F + '/leaves.json'))
for name in ('restoration', 'daclip'):
    tree, _ = nc.load_train_tree(F + '/' + name)
    def walk(t, p=''):
        if isinstance(t, dict):
            for k, v in t.items(): yield from walk(v, p + k + '.')
        elif isinstance(t, list):
            for i, v in enumerate(t): yield from walk(v, p + str(i) + '.')
        else: yield p[:-1], t
    n = 0
    for key, leaf in walk(tree):
        want = stored[name][key]
        if 'scalar' in want:
            assert leaf == want['scalar'], key
        else:
            raw = leaf.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            assert hashlib.sha256(raw).hexdigest() == want['sha256'], key
        n += 1
    assert n == len(stored[name]), name
e = np.load(F + '/expected.npz')
r = pipeline.DACLIPRestorer.load(F + '/restoration', F + '/daclip',
    pipeline.RestorerConfig(model_name='daclip_test-tiny', T=int(e['T']), dtype='float32'),
    device='cpu')
ictx, tctx = r.contexts(e['lq'])
nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))
with torch.no_grad():
    out = r.sde.reverse_posterior(r.unet, nchw(e['x_T']), nchw(e['lq'][None]),
        noises=nchw(e['noises']), text_context=tctx, image_context=ictx)
out = out[0].numpy().transpose(1, 2, 0)
mse = float(np.mean((np.clip(out, 0, 1) - np.clip(e['ref_out'], 0, 1)) ** 2))
assert 10 * np.log10(1 / max(mse, 1e-12)) > 40
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'orbax', 'tensorstore', 'zstandard')]
assert not bad, bad
print('ok')
"""


def test_fixture_loads_where_jax_orbax_tensorstore_and_zstandard_cannot_import():
    res = subprocess.run([sys.executable, "-c", _NO_JAX, str(FIXTURE)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_empty_or_foreign_step_dirs_raise_clearly(tmp_path):
    (tmp_path / "run" / "100").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tnc.load_unet_any(str(tmp_path / "run"))
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        tnc.load_daclip_any(str(tmp_path / "run" / "100"))
