"""daclip_torch end to end on the CPU: the committed golden fixture replayed
through the port (and through daclip_tpu), the pipeline's host-side pieces
against daclip_tpu's, the entry points, and the import boundary."""
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch import pipeline as tpipe
from daclip_torch.convert import infer_unet_arch, load_torch_state_dict
from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
from daclip_torch.models.unet import ConditionalUNet
from daclip_torch.sde import IRSDE
from daclip_torch.transforms import clip_transform
from daclip_torch.utils.metrics import array2img

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "parity" / "fixtures" / "e2e"


def _psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def replay():
    """The fixture's sampler run through the port: contexts from the port's
    DaCLIP, the fixture UNet, the fixture's x_T and noise bank, float32."""
    meta = json.loads((FIXTURE / "meta.json").read_text())
    arrs = dict(np.load(FIXTURE / "arrays.npz"))
    daclip = DaCLIP(CLIPCfg.from_dict(get_model_config(meta["model_name"]))).eval()
    daclip.load_state_dict(load_torch_state_dict(str(FIXTURE / "daclip.pt")), strict=True)
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    arch = infer_unet_arch(sd)
    unet = ConditionalUNet(**{k: v for k, v in arch.items()
                              if k not in ("in_nc", "out_nc")}).eval()
    unet.load_state_dict(sd, strict=True)
    sde = IRSDE(max_sigma=meta["max_sigma"], T=meta["T"], schedule=meta["schedule"],
                eps=meta["eps"])
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))
    with torch.no_grad():
        img_ctx, degra_ctx = daclip.encode_image(nchw(arrs["img4clip"][None]), control=True)
        out = sde.reverse_posterior(unet, nchw(arrs["x_T"][None]), nchw(arrs["lq"][None]),
                                    noises=nchw(arrs["noises"]), text_context=degra_ctx,
                                    image_context=img_ctx)
    return meta, arrs, out[0].numpy().transpose(1, 2, 0), (img_ctx, degra_ctx)


def test_fixture_replay_matches_reference(replay):
    meta, arrs, ours, _ = replay
    psnr_ours, psnr_ref = _psnr(ours, arrs["gt"]), _psnr(arrs["ref_out"], arrs["gt"])
    assert abs(psnr_ref - meta["ref_psnr_vs_gt"]) < 1e-3  # fixture integrity
    assert abs(psnr_ours - psnr_ref) < 0.1, (psnr_ours, psnr_ref)
    assert _psnr(ours, arrs["ref_out"]) > 40.0


def test_fixture_replay_matches_jax(replay):
    from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
    from daclip_tpu.sde import IRSDE as JaxSDE
    from daclip_tpu.utils.torch_convert import convert_unet

    meta, arrs, ours, (img_ctx, degra_ctx) = replay
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    arch = infer_unet_arch(sd)
    net = JaxUNet(nf=arch["nf"], ch_mult=arch["ch_mult"], context_dim=arch["context_dim"],
                  use_degra_context=True, use_image_context=True, dtype=jnp.float32)
    params = {"params": convert_unet({k: v.numpy() for k, v in sd.items()},
                                     depth=len(arch["ch_mult"]))}
    sde = JaxSDE(max_sigma=meta["max_sigma"], T=meta["T"], schedule=meta["schedule"],
                 eps=meta["eps"])
    fn = lambda x, mu, tb, **c: net.apply(params, x, mu, tb, c["text_context"],
                                          c["image_context"])
    out = jax.jit(lambda xt, mu, zs, tc, ic: sde.reverse_posterior(
        fn, xt, mu, jax.random.PRNGKey(0), noises=zs, text_context=tc,
        image_context=ic))(arrs["x_T"][None], arrs["lq"][None], arrs["noises"],
                           degra_ctx.numpy(), img_ctx.numpy())
    assert _psnr(ours, np.asarray(out[0])) > 40.0


def test_tiling_and_buckets_equal_jax():
    from daclip_tpu import pipeline as jpipe

    assert tpipe.default_buckets() == jpipe.default_buckets()
    buckets = tpipe.default_buckets(step=64)
    for x in (1, 63, 64, 65, 200, 1000, 1024, 1025, 3000):
        assert tpipe._bucketize(x, buckets) == jpipe._bucketize(x, buckets)
    for D in (100, 480, 512, 513, 640, 1000, 1024, 2048, 4000):
        for ts, ov, step in ((512, 64, 64), (384, 32, 64), (500, 64, 64), (512, 0, 64)):
            for sizes in (None, (256, 384, 512)):
                assert (tpipe._adaptive_tile_axis(D, ts, ov, step, sizes)
                        == jpipe._adaptive_tile_axis(D, ts, ov, step, sizes))


def test_array2img_and_clip_transform_equal_jax():
    from daclip_tpu.transforms import clip_transform as jax_clip_transform
    from daclip_tpu.utils.metrics import array2img as jax_array2img

    rng = np.random.RandomState(0)
    for shape in ((32, 32, 3), (200, 300, 3), (300, 120, 3), (17, 23, 3)):
        img = (rng.rand(*shape) * 1.2 - 0.1).astype(np.float32)
        np.testing.assert_array_equal(array2img(img), jax_array2img(img))
        # the resampler reproduces PIL's bytes, so the views are equal
        for res in (224, 32):
            np.testing.assert_array_equal(clip_transform(img, res),
                                          jax_clip_transform(img, res))


@pytest.fixture(scope="module")
def restorer():
    cfg = tpipe.RestorerConfig(model_name="daclip_test-tiny", sample_T=10,
                               dtype="float32", tile_size=64, tile_overlap=16)
    return tpipe.DACLIPRestorer.load(str(FIXTURE / "unet.pth"),
                                     str(FIXTURE / "daclip.pt"), cfg, device="cpu")


def test_tiled_blend_with_identity_sampler_returns_input(restorer, monkeypatch):
    monkeypatch.setattr(restorer, "_sample", lambda lq, gen, t, i: lq)
    img = np.random.RandomState(1).rand(150, 100, 3).astype(np.float32)
    out = restorer._restore_tiled(img, 0, None, None)
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_restore_entry_points_on_cpu(restorer, tmp_path):
    rng = np.random.RandomState(2)
    img = rng.rand(40, 50, 3).astype(np.float32)
    out = restorer.restore(img, seed=3)
    assert out.shape == (40, 50, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, restorer.restore(img, seed=3))  # seeded
    tiled = restorer.restore(rng.rand(80, 60, 3).astype(np.float32), return_uint8=False)
    assert tiled.shape == (80, 60, 3) and np.isfinite(tiled).all()
    batch = restorer.restore_batch([img, img[:30, :20]])
    assert [b.shape for b in batch] == [(40, 50, 3), (30, 20, 3)]

    import cv2
    from daclip_torch.cli.predict import main
    cv2.imwrite(str(tmp_path / "in.png"), (img * 255).astype(np.uint8))
    main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "out"), "--device", "cpu",
          "--unet", str(FIXTURE / "unet.pth"), "--daclip", str(FIXTURE / "daclip.pt"),
          "--model-name", "daclip_test-tiny", "--sample-T", "2"])
    assert cv2.imread(str(tmp_path / "out" / "in.png")).shape == (40, 50, 3)


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.resolve_device(None)
    assert tpipe.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import daclip_torch\n"
        "for m in pkgutil.walk_packages(daclip_torch.__path__, 'daclip_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'orbax', 'tensorstore',\n"
        "                                                     'zstandard')\n"
        "       or m.startswith('daclip_tpu')]\n"
        "assert not bad, bad\n"
        "need = ['daclip_torch.train.restoration', 'daclip_torch.train.schedules',\n"
        "        'daclip_torch.losses.matching', 'daclip_torch.utils.ema',\n"
        "        'daclip_torch.utils.checkpoint', 'daclip_torch.flags',\n"
        "        'daclip_torch.ops.pointwise', 'daclip_torch.ops.conv3x3',\n"
        "        'daclip_torch.tokenizer', 'daclip_torch.data.csv_dataset',\n"
        "        'daclip_torch.data.util', 'daclip_torch.eval.zero_shot',\n"
        "        'daclip_torch.eval.retrieval', 'daclip_torch.utils.metrics',\n"
        "        'daclip_torch.utils.native_checkpoint', 'daclip_torch.losses.clip_loss',\n"
        "        'daclip_torch.train.clip_train', 'daclip_torch.train.locking',\n"
        "        'daclip_torch.factory', 'daclip_torch.cli.params',\n"
        "        'daclip_torch.cli.train_daclip', 'daclip_torch.utils.logging',\n"
        "        'daclip_torch.eval.evaluate_daclip', 'daclip_torch.eval.evaluate_numclip',\n"
        "        'daclip_torch.eval.imagenet_zero_shot', 'daclip_torch.eval.plots',\n"
        "        'daclip_torch.tools.encode_folder', 'daclip_torch.tools.inspect_checkpoint',\n"
        "        'daclip_torch.tools.visualize', 'daclip_torch.utils.lpips',\n"
        "        'daclip_torch.utils.profile', 'daclip_torch.utils.stage_profile',\n"
        "        'daclip_torch.data.degradations', 'daclip_torch.tools.generate_lq',\n"
        "        'daclip_torch.tools.generate_masked', 'daclip_torch.data.webdataset',\n"
        "        'daclip_torch.utils.file_utils', 'daclip_torch.models.pretrained',\n"
        "        'daclip_torch.tools.generate_captions', 'daclip_torch.serve.gradio_app',\n"
        "        'daclip_torch.parallel', 'daclip_torch.parallel.mesh',\n"
        "        'daclip_torch.cli.train_restoration', 'daclip_torch.models.resnet',\n"
        "        'daclip_torch.models.convnext', 'daclip_torch.models.timm_model',\n"
        "        'daclip_torch.models.timm_vit', 'daclip_torch.models.swin',\n"
        "        'daclip_torch.models.eva', 'daclip_torch.models.coca',\n"
        "        'daclip_torch.models.hf_text', 'daclip_torch.tools.push_to_hf_hub',\n"
        "        'daclip_torch.data.native_io', 'daclip_torch.data.png',\n"
        "        'daclip_torch.utils.orbax_reader', 'daclip_torch.utils.zstd']\n"
        "assert all(m in sys.modules for m in need), need\n"
        "# the native decoder is built at first use, never at import\n"
        "assert sys.modules['daclip_torch.data.native_io']._lib is None\n"
        "assert sys.modules['daclip_torch.utils.zstd']._lib is None\n"
        "# imported only inside calls: the card's machine is not known to have them\n"
        "absent = [m for m in sys.modules if m.split('.')[0] in ('regex', 'cv2', 'PIL', 'ftfy',\n"
        "                                                        'matplotlib', 'sklearn',\n"
        "                                                        'scipy', 'gradio', 'fsspec',\n"
        "                                                        'huggingface_hub',\n"
        "                                                        'transformers', 'timm')]\n"
        "assert not absent, absent\n"
        "print(len([m for m in sys.modules if m.startswith('daclip_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 84


# -- a restore without DA-CLIP, as daclip_tpu's `load` serves it ------------------
def _seeded_unet_checkpoint(path, **kw):
    """A reference-named UNet state dict filled from a numpy seed (fan-in
    scaled weights, gains near 1), saved where `load` reads it."""
    rng = np.random.RandomState(4)
    sd = {}
    for key, v in ConditionalUNet(**kw).state_dict().items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith(".g") or (key.endswith(".weight") and len(shape) == 1):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        sd[key] = torch.from_numpy(np.asarray(a, np.float32))
    torch.save(sd, path)
    return sd


def test_load_without_daclip_matches_jax_on_a_degradation_context_unet(tmp_path):
    """daclip_tpu's `load` turns both contexts off without DA-CLIP; the port
    does too, drops the degradation-context weights, and its UNet forward
    equals the JAX one on the same inputs."""
    from daclip_tpu import pipeline as jpipe

    path = str(tmp_path / "unet.pth")
    sd = _seeded_unet_checkpoint(path, nf=16, ch_mult=(1, 2), context_dim=32,
                                 use_degra_context=True, use_image_context=False)
    assert "prompt" in sd and "text_mlp.0.weight" in sd
    ours = tpipe.DACLIPRestorer.load(path, None, tpipe.RestorerConfig(dtype="float32"),
                                     device="cpu")
    ref = jpipe.DACLIPRestorer.load(path, None, jpipe.RestorerConfig(dtype="float32"))
    flags = lambda cfg: (cfg.use_degra_context, cfg.use_image_context)
    assert flags(ours.cfg) == flags(ref.cfg) == (False, False)
    assert ours.contexts(np.zeros((32, 32, 3), np.float32)) == (None, None)
    assert not hasattr(ours.unet, "text_mlp")

    rng = np.random.RandomState(5)
    xt = rng.randn(1, 32, 32, 3).astype(np.float32)
    cond = rng.rand(1, 32, 32, 3).astype(np.float32)
    t = np.asarray([37.0], np.float32)
    want = np.asarray(ref.unet.apply({"params": ref.unet_params}, xt, cond, t, None, None))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = ours.unet(nchw(xt), nchw(cond), torch.from_numpy(t)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_an_image_context_unet_without_daclip_is_refused(tmp_path):
    """Its SpatialTransformers need DA-CLIP's image features: the port's
    `load` and constructor refuse it with a ValueError; daclip_tpu's `load`
    gives a restorer whose first restore fails (its context-free UNet finds
    no parameters for the linear attention at the spatial level)."""
    from daclip_tpu import pipeline as jpipe

    path = str(tmp_path / "unet.pth")
    kw = dict(nf=32, ch_mult=(1, 2), context_dim=32, use_degra_context=True,
              use_image_context=True, spatial_attn_min_level=1)
    sd = _seeded_unet_checkpoint(path, **kw)
    with pytest.raises(ValueError, match="image-context"):
        tpipe.DACLIPRestorer.load(path, None, tpipe.RestorerConfig(dtype="float32"),
                                  device="cpu")
    cfg = tpipe.RestorerConfig(nf=32, ch_mult=(1, 2), context_dim=32,
                               spatial_attn_min_level=1, dtype="float32")
    with pytest.raises(ValueError, match="image-context"):
        tpipe.DACLIPRestorer(cfg, sd, None, device="cpu")
    ref = jpipe.DACLIPRestorer.load(path, None, jpipe.RestorerConfig(dtype="float32"))
    with pytest.raises(Exception, match="Could not find parameter"):
        ref.restore(np.random.RandomState(1).rand(32, 32, 3).astype(np.float32))
