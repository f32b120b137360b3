"""daclip_torch's webdataset reader against daclip_tpu's on the CPU: brace
expansion, the shard order of each epoch (shuffled, resampled, resampled
with per-source weights, strided over 2 hosts), the samples byte for byte
through a shuffle buffer, `ClipWebLoader`'s batches across epochs with its
fill-up passes, the host striding read off `torch.distributed`, and the
train CLI's webdataset loader against daclip_tpu's."""
import io
import os
import random
import tarfile
from functools import partial

import numpy as np
import pytest
import torch
from PIL import Image

from daclip_torch import transforms as ttf
from daclip_torch.cli import params as tparams
from daclip_torch.cli import train_daclip as tcli
from daclip_torch.data import webdataset as twds
from daclip_torch.tokenizer import tokenize as ttokenize
from daclip_tpu import transforms as jtf
from daclip_tpu.data import webdataset as jwds
from daclip_tpu.tokenizer import tokenize as jtokenize

torch.set_num_threads(1)
L = 16


def write_shards(root, shards=4, per_shard=5, seed=0, extra=True):
    """Seeded tar shards of (png, txt) samples; with `extra` a json member
    and a sample without a caption too. Returns the brace pattern."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(shards):
        with tarfile.open(os.path.join(root, f"shard-{s:03d}.tar"), "w") as tf:
            for i in range(per_shard):
                key = f"s{s}_{i:03d}"
                h, w = rng.randint(24, 48, size=2)
                buf = io.BytesIO()
                Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(buf, "png")
                members = [("png", buf.getvalue())]
                if not (extra and i == 2):
                    members.append(("txt", f"a photo {s} {i} of thing {rng.randint(99)}"
                                    .encode()))
                if extra and i == 0:
                    members.append(("json", b'{"id": %d}' % s))
                for ext, data in members:
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return os.path.join(root, "shard-{000..%03d}.tar" % (shards - 1))


@pytest.mark.parametrize("pattern", [
    "a/shard-{000..011}.tar", "b/x-{7..12}.tar", "c/{train,val,test}.tar", "plain.tar",
    "a/{00..03}.tar::b/{0..2}.tar", "s3://bucket/{a,b}/data.tar"])
def test_brace_expansion_equals_jax(pattern):
    assert twds.expand_urls(pattern) == jwds.expand_urls(pattern)
    for part in pattern.split("::"):
        assert twds.brace_expand(part) == jwds.brace_expand(part)


@pytest.mark.parametrize("kw", [
    dict(), dict(resampled=True), dict(resampled=True, weights=[1.0, 3.0]),
    dict(host_id=0, num_hosts=2), dict(host_id=1, num_hosts=2),
    dict(resampled=True, host_id=1, num_hosts=2, weights=[2.0, 0.5])])
def test_shard_order_equals_jax(kw):
    urls = "a/{000..009}.tar::b/{00..05}.tar"
    if "weights" not in kw:
        urls = "a/{000..009}.tar"
    ours = twds.WebDataset(urls, seed=3, **kw)
    ref = jwds.WebDataset(urls, seed=3, **kw)
    assert ours.shards == ref.shards and ours.shard_weights == ref.shard_weights
    for epoch in range(4):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert ours._shard_list() == ref._shard_list(), epoch


def test_weights_must_match_the_sources():
    with pytest.raises(ValueError, match="2 upsampling factors for 1 sources"):
        twds.WebDataset("a/{0..3}.tar", weights=[1.0, 2.0])


def _same_sample(a, b):
    assert set(a) == set(b)
    for k, v in b.items():
        if k == "png":
            np.testing.assert_array_equal(a[k], np.asarray(v), err_msg=a["__key__"])
            assert a[k].dtype == np.uint8 and a[k].ndim == 3
        else:
            assert a[k] == v, (a["__key__"], k)


@pytest.mark.parametrize("kw", [dict(shuffle_buffer=0), dict(shuffle_buffer=6),
                                dict(shuffle_buffer=4, samples_per_epoch=9),
                                dict(shuffle_buffer=3, host_id=1, num_hosts=2),
                                dict(shuffle_buffer=5, resampled=True)])
def test_samples_equal_jax_byte_for_byte(tmp_path, kw):
    pattern = write_shards(str(tmp_path))
    ours = twds.WebDataset(pattern, seed=5, **kw)
    ref = jwds.WebDataset(pattern, seed=5, **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert [s["__key__"] for s in got] == [s["__key__"] for s in want]
        assert got
        for a, b in zip(got, want):
            _same_sample(a, b)


@pytest.mark.parametrize("num_samples,batch", [(12, 4), (40, 4), (9, 3)])
def test_clip_web_loader_batches_equal_jax(tmp_path, num_samples, batch):
    """16 usable samples a pass: 40 samples take two fill-up passes, each
    at the next shuffle epoch; the transform's crop draws from equal
    streams (the port's Random(7), daclip_tpu's seeded transform)."""
    pattern = write_shards(str(tmp_path))
    ours = twds.ClipWebLoader(twds.WebDataset(pattern, shuffle_buffer=4, seed=2),
                              ttf.image_transform(32, is_train=True, rng=random.Random(7)),
                              partial(ttokenize, context_length=L), batch, num_samples)
    ref = jwds.ClipWebLoader(jwds.WebDataset(pattern, shuffle_buffer=4, seed=2),
                             jtf.image_transform(32, is_train=True, seed=7),
                             partial(jtokenize, context_length=L), batch, num_samples)
    assert len(ours) == len(ref) == num_samples // batch
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert set(a) == set(b) == {"images", "texts"}
            assert a["images"].dtype == np.float32 and a["texts"].dtype == np.int32
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert ours.wds.epoch == ref.wds.epoch


def test_clip_web_loader_refusals(tmp_path):
    with pytest.raises(ValueError, match="--train-num-samples"):
        twds.ClipWebLoader(twds.WebDataset("x.tar"), None, None, 4, 0)
    root = tmp_path / "nocap"
    root.mkdir()
    with tarfile.open(root / "0.tar", "w") as tf:
        info = tarfile.TarInfo("a.json")
        info.size = 2
        tf.addfile(info, io.BytesIO(b"{}"))
    loader = twds.ClipWebLoader(twds.WebDataset(str(root / "0.tar")), None, None, 1, 2)
    with pytest.raises(RuntimeError, match="no usable image\\+text samples"):
        list(loader)


def test_hosts_come_from_torch_distributed(monkeypatch):
    assert twds.host_rank_and_count() == (0, 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    ours = twds.WebDataset("a/{000..009}.tar", seed=1)
    assert (ours.host_id, ours.num_hosts) == (1, 2)
    ref = jwds.WebDataset("a/{000..009}.tar", seed=1, host_id=1, num_hosts=2)
    assert ours._shard_list() == ref._shard_list()


def _wds_argv(pattern, *extra):
    return ["--train-data", pattern, "--train-num-samples", "12", "--model", "test-tiny",
            "--batch-size", "4", "--workers", "0", "--device", "cpu", *extra]


@pytest.mark.parametrize("extra", [[], ["--dataset-resampled"]])
def test_cli_webdataset_loader_equals_jax(tmp_path, extra):
    """`auto` takes a `{` pattern for webdataset; the CLI's loader gives
    daclip_tpu's batches (its shuffle buffer of 5000, its seed)."""
    pattern = write_shards(str(tmp_path))
    args = tparams.parse_args(_wds_argv(pattern, *extra))
    assert tcli.dataset_type(args) == "webdataset"
    pp = ttf.image_transform(32, is_train=True, rng=random.Random(args.seed))
    loader, banks, val_ds = tcli.build_data(args, pp, None,
                                            partial(ttokenize, context_length=L), 32)
    assert banks is None and val_ds is None
    ref = jwds.ClipWebLoader(
        jwds.WebDataset(pattern, shuffle_buffer=5000, seed=args.seed,
                        resampled=bool(extra)),
        jtf.image_transform(32, is_train=True, seed=args.seed),
        partial(jtokenize, context_length=L), 4, 12)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        for a, b in zip(loader, ref):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_webdataset_upsampling_factors_and_auto_dispatch(tmp_path):
    a = write_shards(str(tmp_path / "a"), shards=2, seed=1)
    b = write_shards(str(tmp_path / "b"), shards=3, seed=2)
    args = tparams.parse_args(_wds_argv(f"{a}::{b}", "--dataset-resampled",
                                        "--train-data-upsampling-factors", "1::4"))
    loader = tcli.build_data(args, lambda x: x, None, None, 32)[0]
    ref = jwds.WebDataset(f"{a}::{b}", shuffle_buffer=5000, seed=args.seed, resampled=True,
                          weights=[1.0, 4.0])
    assert loader.wds.shard_weights == ref.shard_weights == [1.0] * 2 + [4.0] * 3
    for epoch in range(3):
        loader.wds.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert loader.wds._shard_list() == ref._shard_list()
    for data, kind in (("x.tar", "webdataset"), ("x.csv", "csv"), ("a::b", "webdataset"),
                       ("", "synthetic")):
        assert tcli.dataset_type(tparams.parse_args(["--train-data", data])) == kind


def test_cli_refuses_da_with_webdataset(tmp_path):
    pattern = write_shards(str(tmp_path))
    argv = _wds_argv(pattern, "--da", "--logs", str(tmp_path / "logs"))
    with pytest.raises(SystemExit) as ours:
        tcli.main(argv)
    assert "webdataset sources carry no degradation metadata" in str(ours.value)
