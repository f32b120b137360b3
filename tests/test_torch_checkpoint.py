"""daclip_torch's checkpoint loading against daclip_tpu's on the CPU: the
flat `.npz` params that daclip_tpu's `save_params_npz` writes (a tiny UNet,
a DaCLIP with the fork's predictor), the UNet architecture read off them, a
restore loaded from them, the ViT position-embedding resize of a torch
checkpoint, the refusal of train dirs, and the CLI's classification."""
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from daclip_torch import pipeline as tpipe
from daclip_torch.convert import daclip_state_dict_from_jax, resize_pos_embed
from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
from daclip_torch.models.unet import ConditionalUNet
from daclip_torch.utils import native_checkpoint as tnc
from daclip_tpu import pipeline as jpipe
from daclip_tpu.utils import native_checkpoint as jnc
from daclip_tpu.utils import torch_convert as jconv
from tests.test_torch_text import NAME, jax_daclip_params, jax_unet_params

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "parity" / "fixtures" / "e2e"
UNET_KW = dict(nf=32, ch_mult=(1, 2), context_dim=32, use_degra_context=True,
               use_image_context=True, spatial_attn_min_level=1)


def _psnr(a, b):  # tests/test_torch_pipeline.py's restore bound: > 40 dB
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A JAX tiny UNet and DaCLIP (predictor included) written by
    daclip_tpu's save_params_npz."""
    d = tmp_path_factory.mktemp("npz")
    unet, daclip = jax_unet_params(seed=21, **UNET_KW), jax_daclip_params(seed=22)
    return (jnc.save_params_npz(str(d / "unet.npz"), unet),
            jnc.save_params_npz(str(d / "daclip.npz"), daclip), unet, daclip)


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_npz_written_by_jax_loads_in_the_port(npz, tmp_path):
    unet_path, daclip_path, unet, daclip = npz
    _assert_tree_equal(tnc.load_params_npz(unet_path), jnc.load_params_npz(unet_path))
    _assert_tree_equal(tnc.load_params_npz(daclip_path), daclip)
    sd, arch = tnc.load_unet_any(unet_path)
    ConditionalUNet(**{k: v for k, v in arch.items() if k not in ("in_nc", "out_nc")}
                    ).load_state_dict(sd, strict=True)
    dsd = tnc.load_daclip_any(daclip_path, 32, 16)
    assert "predictor.regressors.3.2.bias" in dsd
    model = DaCLIP(CLIPCfg.from_dict(get_model_config(NAME)), use_predictor=True)
    model.load_state_dict(dsd, strict=True)
    # the port's writer gives daclip_tpu's files
    back = tnc.save_params_npz(str(tmp_path / "back.npz"), tnc.load_params_npz(daclip_path))
    _assert_tree_equal(jnc.load_params_npz(back), daclip)


@pytest.mark.parametrize("kw", [
    UNET_KW,
    dict(nf=16, ch_mult=(1, 2, 2), context_dim=32, use_degra_context=True),
    dict(nf=32, ch_mult=(1, 2), context_dim=24, use_degra_context=False,
         use_image_context=True, spatial_attn_min_level=0),
    dict(nf=32, ch_mult=(1, 2), context_dim=32, use_degra_context=True,
         use_image_context=True, scale=0.5),
])
def test_infer_unet_arch_from_params_equals_jax(kw):
    params = jax_unet_params(seed=23, **kw)
    arch = tnc.infer_unet_arch_from_params(params)
    assert arch == jnc.infer_unet_arch_from_params(params)
    assert arch["scale"] == kw.get("scale", 1.0) and arch["nf"] == kw["nf"]


def test_restorer_loaded_from_npz_restores_as_jax(npz):
    """Both packages' `DACLIPRestorer.load` on the same two .npz files, float32:
    the same arch and contexts, and the same restore through an explicit
    noise bank."""
    unet_path, daclip_path, _, _ = npz
    kw = dict(model_name=NAME, T=4, dtype="float32")
    ours = tpipe.DACLIPRestorer.load(unet_path, daclip_path, tpipe.RestorerConfig(**kw),
                                     device="cpu")
    ref = jpipe.DACLIPRestorer.load(unet_path, daclip_path, jpipe.RestorerConfig(**kw))
    fields = ("nf", "ch_mult", "context_dim", "use_degra_context", "use_image_context",
              "scale", "spatial_attn_min_level")
    assert [getattr(ours.cfg, f) for f in fields] == [getattr(ref.cfg, f) for f in fields]
    assert ours.daclip.predictor is None     # the fork's head is dropped, as in JAX

    rng = np.random.RandomState(24)
    lq = rng.rand(32, 32, 3).astype(np.float32)
    tctx, ictx = ours.contexts([lq])
    jictx, jtctx = ref.contexts(lq)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jtctx), atol=1e-4)
    np.testing.assert_allclose(ictx.numpy(), np.asarray(jictx), atol=1e-4)
    x_T = (lq + 0.5 * rng.randn(*lq.shape)).astype(np.float32)[None]
    noises = rng.randn(4, 1, 32, 32, 3).astype(np.float32)
    fn = lambda x, mu, tb, **c: ref.unet.apply({"params": ref.unet_params}, x, mu, tb,
                                               c["text_context"], c["image_context"])
    want = jax.jit(lambda xt, mu, zs, tc, ic: ref.sde.reverse_posterior(
        fn, xt, mu, jax.random.PRNGKey(0), noises=zs, text_context=tc,
        image_context=ic))(x_T, lq[None], noises, jtctx, jictx)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))
    with torch.no_grad():
        got = ours.sde.reverse_posterior(ours.unet, nchw(x_T), nchw(lq[None]),
                                         noises=nchw(noises), text_context=tctx,
                                         image_context=ictx)
    got = got[0].numpy().transpose(1, 2, 0)
    assert np.isfinite(got).all()
    assert _psnr(got, np.asarray(want[0])) > 40.0
    assert ours.restore(lq, seed=0).shape == (32, 32, 3)


@pytest.mark.parametrize("g_old,g_new", [(7, 14), (14, 7), (7, 7), (4, 2)])
def test_resize_pos_embed_equals_jax(g_old, g_new):
    """JAX computes its cubic weights in float32: ≤ 1e-5 on N(0, 1) values."""
    pos = np.random.RandomState(g_old * 31 + g_new).randn(g_old * g_old + 1, 24)
    pos = pos.astype(np.float32)
    want = jconv.resize_pos_embed({"positional_embedding": pos}, g_new * 16, 16)
    got = resize_pos_embed(torch.from_numpy(pos), g_new * 16, 16)
    assert got.shape == (g_new * g_new + 1, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want["positional_embedding"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0].numpy(), pos[0])          # the class token


def test_torch_daclip_at_another_grid_is_resized_on_load(tmp_path):
    """A reference .pt whose ViTs were trained on a 4×4 grid, loaded for the
    2×2 grid of `daclip_test-tiny`: both ViTs' position embeddings are
    resized as daclip_tpu's `convert_daclip` resizes them."""
    cfg = get_model_config(NAME)
    cfg["vision_cfg"]["image_size"] = 64
    sd = DaCLIP(CLIPCfg.from_dict(cfg)).state_dict()
    rng = np.random.RandomState(25)
    sd = {k: torch.from_numpy(np.asarray(rng.randn(*v.shape), np.float32))
          for k, v in sd.items()}
    sd["visual.positional_embedding"] = sd["clip.visual.positional_embedding"]
    path = str(tmp_path / "daclip.pt")
    torch.save(sd, path)
    ours = tnc.load_daclip_any(path, 32, 16)
    want = jnc.load_daclip_any(path, 32, 16)
    for key, tree in (("clip.visual", want["clip"]["visual"]),
                      ("visual_control", want["visual_control"])):
        np.testing.assert_allclose(ours[f"{key}.positional_embedding"].numpy(),
                                   tree["positional_embedding"], atol=1e-5, rtol=0)
    DaCLIP(CLIPCfg.from_dict(get_model_config(NAME))).load_state_dict(ours, strict=True)


def test_train_dirs_are_refused(tmp_path, npz):
    plain, run = tmp_path / "plain", tmp_path / "run"
    plain.mkdir()
    (run / "100").mkdir(parents=True)
    for path in (str(plain), str(run), str(run / "100"), npz[0], str(FIXTURE / "unet.pth")):
        try:
            want = jnc.checkpoint_kind(path)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                tnc.checkpoint_kind(path)
            continue
        assert tnc.checkpoint_kind(path) == want
    for path in (str(run), str(run / "100")):
        with pytest.raises(NotImplementedError, match="save_params_npz"):
            tnc.load_unet_any(path)
        with pytest.raises(NotImplementedError, match="orbax"):
            tnc.load_daclip_any(path)
    for unet, daclip in ((str(run), None), (npz[0], str(plain))):
        with pytest.raises(NotImplementedError, match=r"\.npz"):
            tpipe.DACLIPRestorer.load(unet, daclip, device="cpu")


def test_cli_classifies_and_restores_from_torch_and_npz(tmp_path, npz):
    import cv2

    from daclip_torch.cli.predict import main

    img = (np.random.RandomState(26).rand(40, 48, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), img)
    for i, (unet, daclip) in enumerate(((FIXTURE / "unet.pth", FIXTURE / "daclip.pt"),
                                        npz[:2])):
        out = tmp_path / f"out{i}"
        res = subprocess.run(
            [sys.executable, "-m", "daclip_torch.cli.predict", "-i", str(tmp_path / "in.png"),
             "-o", str(out), "--unet", str(unet), "--daclip", str(daclip), "--classify",
             "--device", "cpu", "--model-name", NAME, "--sample-T", "2"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        line = res.stdout.splitlines()[0]
        assert line.startswith("in.png: degradation=")
        assert line.split("=")[1].split(" ")[0] in tpipe.DEGRADATION_CLASSES
        assert cv2.imread(str(out / "in.png")).shape == (40, 48, 3)
    with pytest.raises(SystemExit):
        main(["-i", str(tmp_path / "in.png"), "--checkpoint", str(tmp_path), "--device", "cpu"])
