"""daclip_torch's `DACLIPRestorer.shard_tiles` on the CPU: a tiled restore
whose UNet calls are split over two devices (the CPU listed twice, as one
card listed twice is on a one-card machine) against the unsharded one, its
tile batches against daclip_tpu's sharded `_restore_tiled` over the 8
virtual CPU devices of tests/conftest.py, the blend with padding, and the
refusals."""
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from daclip_torch import pipeline as tpipe
from daclip_tpu import pipeline as jpipe
from tests.test_torch_pipeline import _seeded_unet_checkpoint

torch.set_num_threads(1)
FIXTURE = pathlib.Path(__file__).resolve().parent / "parity" / "fixtures" / "e2e"
# 112 × 208 at tile_size 64, overlap 16 is 2 × 4 tiles of 64²: one full batch
FULL = (112, 208)


def _cfg(**kw):
    return tpipe.RestorerConfig(model_name="daclip_test-tiny", sample_T=3, dtype="float32",
                                tile_size=64, tile_overlap=16, tile_batch=8, **kw)


@pytest.fixture(scope="module")
def restorers():
    """(unsharded, sharded over ["cpu", "cpu"]) on the fixture's UNet and
    DA-CLIP, with both contexts on."""
    load = lambda: tpipe.DACLIPRestorer.load(str(FIXTURE / "unet.pth"),
                                             str(FIXTURE / "daclip.pt"), _cfg(), device="cpu")
    return load(), load().shard_tiles(["cpu", "cpu"])


def test_sharded_full_batch_equals_unsharded(restorers):
    plain, sharded = restorers
    img = np.random.RandomState(0).rand(*FULL, 3).astype(np.float32)
    batches = []
    hook = sharded.unet.register_forward_pre_hook(
        lambda m, args: batches.append(args[0].shape[0]))
    try:
        b = sharded.restore(img, seed=3, return_uint8=False)
    finally:
        hook.remove()
    a = plain.restore(img, seed=3, return_uint8=False)
    assert batches == [4, 4] * 3        # two chunks of 4 tiles a step, 3 steps
    assert a.shape == b.shape == FULL + (3,)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(sharded.restore(img, seed=3, return_uint8=False), b)


def test_sharded_unet_call_splits_and_gathers(restorers):
    """The split call equals the whole batch's UNet forward, with (1, D)
    contexts broadcast to each chunk and (B, D) ones split."""
    plain, sharded = restorers
    rng = np.random.RandomState(1)
    x, mu = (torch.from_numpy(rng.randn(8, 3, 32, 32).astype(np.float32)) for _ in range(2))
    t = torch.arange(8, dtype=torch.float32) * 7
    for B in (1, 8):
        tc, ic = (torch.from_numpy(rng.randn(B, plain.cfg.context_dim).astype(np.float32))
                  for _ in range(2))
        with torch.no_grad():
            want = plain.unet(x, mu, t, text_context=tc, image_context=ic)
            got = sharded._sharded_unet(x, mu, t, text_context=tc, image_context=ic)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def _record(restorer, monkeypatch, kw_name):
    """Replace `restorer._sample` by an identity that records its batches."""
    seen = []

    def sample(lq, key, a, b, **kw):
        assert set(kw) <= {kw_name}
        seen.append(np.asarray(lq))
        return np.asarray(lq)

    monkeypatch.setattr(restorer, "_sample", sample)
    return seen


@pytest.fixture(scope="module")
def unet_only(tmp_path_factory):
    """A small seeded UNet without contexts, loaded by both packages."""
    path = str(tmp_path_factory.mktemp("unet") / "unet.pth")
    _seeded_unet_checkpoint(path, nf=16, ch_mult=(1, 2), context_dim=0,
                            use_degra_context=False, use_image_context=False)
    return path


@pytest.mark.parametrize("shape,tile_batch,devices", [
    ((150, 100), 8, 2),       # 6 tiles: one batch of 8, 2 of it padding
    ((112, 272), 8, 8),       # 2 × 6 = 12 tiles: 8 + 8, 4 of it padding
    ((208, 208), 8, 4),       # 4 × 4 = 16 tiles: two full batches
    ((300, 140), 16, 2)])     # 6 × 3 = 18 tiles: 16 + 16, 14 of it padding
def test_sharded_tile_batches_equal_jax(unet_only, monkeypatch, shape, tile_batch, devices):
    cfg = dict(tile_size=64, tile_overlap=16, tile_batch=tile_batch, dtype="float32")
    ours = tpipe.DACLIPRestorer.load(unet_only, None, tpipe.RestorerConfig(**cfg),
                                     device="cpu").shard_tiles(["cpu"] * devices)
    ref = jpipe.DACLIPRestorer.load(unet_only, None, jpipe.RestorerConfig(**cfg))
    ref.shard_tiles(Mesh(np.array(jax.devices("cpu")[:8]), ("data",)))
    img = np.random.RandomState(2).rand(*shape, 3).astype(np.float32)
    got = _record(ours, monkeypatch, "noise_fn")
    want = _record(ref, monkeypatch, "")
    a = ours._restore_tiled(img, 0, None, None)
    b = ref._restore_tiled(img, jax.random.PRNGKey(0), None, None)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.shape[0] == tile_batch for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n_real = (len(tpipe._adaptive_tile_axis(shape[0], 64, 16, 64, [64])[0])
              * len(tpipe._adaptive_tile_axis(shape[1], 64, 16, 64, [64])[0]))
    assert len(got) == -(-n_real // tile_batch)
    r = n_real - (len(got) - 1) * tile_batch  # the last batch's real tiles
    for j in range(r, tile_batch):           # padding: copies of the last tile
        np.testing.assert_array_equal(got[-1][j], got[-1][r - 1])
    np.testing.assert_allclose(a, img, atol=1e-6)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_sharded_blend_with_identity_sampler_returns_input(restorers, monkeypatch):
    """The padding's outputs are discarded: an identity sampler gives back
    the input, remainder or not."""
    _, sharded = restorers
    seen = _record(sharded, monkeypatch, "noise_fn")
    for shape in ((150, 100), FULL, (200, 90)):
        img = np.random.RandomState(1).rand(*shape, 3).astype(np.float32)
        np.testing.assert_allclose(sharded._restore_tiled(img, 0, None, None), img,
                                   atol=1e-6)
    assert {len(b) for b in seen} == {8}


def test_shard_tiles_refusals(unet_only, monkeypatch):
    r = tpipe.DACLIPRestorer.load(unet_only, None, _cfg(), device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the 3 devices"):
        r.shard_tiles(["cpu"] * 3)
    with pytest.raises(ValueError, match="at least one device"):
        r.shard_tiles([])
    with pytest.raises(ValueError, match="is not a cpu device"):
        r.shard_tiles(["cpu", "cuda:0"])
    assert r._tile_devices is None          # nothing changed by a refusal
    monkeypatch.setattr(r, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="device cpu is not a cuda device"):
        r.shard_tiles(["cpu", "cpu"])


def test_shard_tiles_keeps_one_unet_a_device(unet_only):
    r = tpipe.DACLIPRestorer.load(unet_only, None, _cfg(), device="cpu")
    assert r.shard_tiles([torch.device("cpu")] * 4) is r
    assert r._tile_devices == [torch.device("cpu")] * 4
    assert list(r._tile_unets) == [torch.device("cpu")]
    assert r._tile_unets[torch.device("cpu")] is r.unet   # the restorer's own device
