"""daclip_torch's image towers (ModifiedResNet, ConvNeXt, the timm ViTs,
Swin, EVA in its three block forms, the layer-scale ViT) and CustomTextCLIP's
text layout against daclip_tpu's on the CPU, in float32: seeded JAX
parameters → `convert.clip_state_dict_from_jax` → `load_state_dict(strict=
True)` → the same features; the state dict back through daclip_tpu's
`convert_clip` → the same JAX tree; the factory over every vendored config;
the lock masks. Tiny variants are added at run time to both packages'
variant and config tables and removed after."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daclip_torch.factory as tfactory
import daclip_tpu.factory as jfactory
from daclip_torch.convert import clip_state_dict_from_jax
from daclip_torch.models import clip as tclip
from daclip_torch.models import convnext as tconvnext
from daclip_torch.models import eva as teva
from daclip_torch.models import swin as tswin
from daclip_torch.models import timm_vit as ttimm_vit
from daclip_torch.train import locking as tlock
from daclip_tpu.models import clip as jclip
from daclip_tpu.models import convnext as jconvnext
from daclip_tpu.models import eva as jeva
from daclip_tpu.models import swin as jswin
from daclip_tpu.models import timm_vit as jtimm_vit
from daclip_tpu.train import locking as jlock
from daclip_tpu.utils.torch_convert import convert_clip

torch.set_num_threads(1)

TEXT = {"context_length": 8, "vocab_size": 64, "width": 32, "heads": 2, "layers": 2}
EVA = dict(patch=8, width=32, depth=2, heads=4, hidden=40, ref_feat=None)
VARIANTS = {
    "convnext": {"convnext_tt": ((1, 2), (16, 32))},
    "eva": {"eva02_tt": dict(EVA, swiglu=True, clip_extras=True, rope=True, post_norm=False,
                             fused_qkv=False, ref_feat=(4, 4)),
            "eva01_tt": dict(EVA, swiglu=False, clip_extras=False, rope=False,
                             post_norm=False, fused_qkv=True),
            "eva02_e_tt": dict(EVA, swiglu=False, clip_extras=False, rope=False,
                               post_norm=True, fused_qkv=True)},
    "swin": {"swin_tt": dict(patch=4, embed=16, depths=(2, 2), heads=(2, 4), window=2,
                             mlp_ratio=4.0)},
    "timm_vit": {"vit_gap_tt": dict(patch=8, width=32, depth=2, heads=4, mlp_ratio=4.0,
                                    qkv_bias=False, class_token=False, pool="avg",
                                    ls_init=1e-6, relpos=False),
                 "vit_relpos_tt": dict(patch=8, width=32, depth=2, heads=4, mlp_ratio=4.0,
                                       qkv_bias=False, class_token=True, pool="token",
                                       ls_init=1e-6, relpos=True, rel_pos_dim=16)},
}
TABLES = [(jconvnext.VARIANTS, tconvnext.VARIANTS, "convnext"),
          (jeva.EVA_VARIANTS, teva.EVA_VARIANTS, "eva"),
          (jswin.SWIN_VARIANTS, tswin.SWIN_VARIANTS, "swin"),
          (jtimm_vit.TIMM_VIT_VARIANTS, ttimm_vit.TIMM_VIT_VARIANTS, "timm_vit")]


def _timm(name, size=32, pool="", proj="linear", custom=False):
    cfg = {"embed_dim": 16, "text_cfg": dict(TEXT),
           "vision_cfg": {"timm_model_name": name, "timm_pool": pool, "timm_proj": proj,
                          "image_size": size}}
    if custom:
        cfg["custom_text"] = True
    return cfg


CONFIGS = {
    "tt-RN": {"embed_dim": 16, "text_cfg": dict(TEXT),
              "vision_cfg": {"image_size": 64, "layers": [1, 2, 1, 1], "width": 8,
                             "head_width": 32}},
    "tt-convnext": _timm("convnext_tt"),
    "tt-convnext-mlp": _timm("convnext_tt", proj="mlp"),
    "tt-EVA02": _timm("eva02_tt", pool="token", proj=None, custom=True),
    "tt-EVA01": _timm("eva01_tt", pool="token", proj=None, custom=True),
    "tt-EVA02-E": _timm("eva02_e_tt", pool="token", proj=None, custom=True),
    "tt-swin": _timm("swin_tt"),
    "tt-vit-gap": _timm("vit_gap_tt"),
    "tt-vit-relpos": _timm("vit_relpos_tt"),
    "tt-ViT-ls": {"embed_dim": 16, "text_cfg": dict(TEXT),
                  "vision_cfg": {"image_size": 32, "layers": 2, "width": 32, "patch_size": 8,
                                 "head_width": 16, "ls_init_value": 1e-4}},
}


@pytest.fixture(scope="module", autouse=True)
def tiny_tables():
    """The tiny variants and configs in both packages' tables, for this
    module only."""
    for jt, tt, fam in TABLES:
        for k, v in VARIANTS[fam].items():
            jt[k] = tt[k] = v
    for k, v in CONFIGS.items():
        jclip._MODEL_CONFIGS[k] = tclip._MODEL_CONFIGS[k] = v
    yield
    for jt, tt, fam in TABLES:
        for k in VARIANTS[fam]:
            del jt[k], tt[k]
    for k in CONFIGS:
        del jclip._MODEL_CONFIGS[k], tclip._MODEL_CONFIGS[k]


def seeded(tree, seed=0):
    """A parameter tree of the same structure filled from a numpy seed:
    fan-in scaled weights, gains near 1, variances above 0."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "'var'" in name:
            a = 1.0 + 0.2 * np.abs(rng.randn(*shape))
        elif len(shape) >= 2:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif any(s in name for s in ("'scale'", "gamma", "ls_")):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(tree))


def _is_custom(name):
    return bool(CONFIGS[name].get("custom_text"))


def _pair(name, seed=0):
    """daclip_tpu's model and seeded parameters, and the port's model with
    them loaded strictly."""
    jmodel, p0 = jfactory.create_model(name)
    jparams = seeded(p0, seed)
    tmodel = tfactory.create_model(name).eval()
    tmodel.load_state_dict(clip_state_dict_from_jax(jparams, custom_text=_is_custom(name)),
                           strict=True)
    return jmodel, jparams, tmodel


def _images(name, B=2, seed=1):
    size = CONFIGS[name]["vision_cfg"]["image_size"]
    return np.random.RandomState(seed).randn(B, size, size, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tower_features_equal_jax(name):
    jmodel, jparams, tmodel = _pair(name)
    x = _images(name)
    want = np.asarray(jmodel.apply({"params": jparams}, x, method=jmodel.encode_image))
    with torch.no_grad():
        got = tmodel.encode_image(_nchw(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(want).max() > 1e-2  # the comparison sees a real signal


@pytest.mark.parametrize("name", ["tt-EVA02", "tt-convnext"])
def test_text_tower_in_either_layout_equals_jax(name):
    """A custom_text config keeps the text tower under `text.`, a plain one
    inlines it; both encode what daclip_tpu's does."""
    jmodel, jparams, tmodel = _pair(name, seed=2)
    assert tmodel.custom_text == _is_custom(name)
    assert any(k.startswith("text.") for k in tmodel.state_dict()) == _is_custom(name)
    toks = np.random.RandomState(3).randint(1, 60, (3, TEXT["context_length"])).astype(np.int32)
    toks[:, -1] = 63
    want = np.asarray(jmodel.apply({"params": jparams}, toks, method=jmodel.encode_text))
    with torch.no_grad():
        got = tmodel.encode_text(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def _without_layer_scale(tree):
    return {k: (_without_layer_scale(v) if isinstance(v, dict) else v)
            for k, v in tree.items() if k not in ("ls_1", "ls_2")}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_round_trips_through_torch_convert(name):
    """The port's state dict, read by daclip_tpu's `convert_clip`, is the
    JAX tree it came from, bit for bit. daclip_tpu's converter does not
    read open_clip's LayerScale (`ls_1.gamma`): for the layer-scale ViT the
    tree is compared without it, and the gammas are checked on the port's
    side."""
    _, jparams, tmodel = _pair(name)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = convert_clip(sd)
    want = jax.tree.map(np.asarray, jparams)
    if "ls_init_value" in CONFIGS[name]["vision_cfg"]:
        blocks = want["visual"]["transformer"]["resblocks"]
        for i in range(CONFIGS[name]["vision_cfg"]["layers"]):
            for j in (1, 2):
                np.testing.assert_array_equal(
                    sd[f"visual.transformer.resblocks.{i}.ls_{j}.gamma"], blocks[f"ls_{j}"][i])
        want = _without_layer_scale(want)
    _assert_tree_equal(back, want)


def test_swin_classic_patch_merging_layout_loads():
    """A Swin state dict with the merges at the end of the previous stage
    (Microsoft / timm < 0.9), which `convert_swin_visual` also reads, loads
    strictly and encodes the same."""
    jmodel, jparams, tmodel = _pair("tt-swin")
    sd = tmodel.state_dict()
    classic = {k.replace("trunk.layers.1.downsample", "trunk.layers.0.downsample"): v
               for k, v in sd.items()}
    assert "visual.trunk.layers.0.downsample.norm.weight" in classic
    again = tfactory.create_model("tt-swin").eval()
    again.load_state_dict(dict(classic), strict=True)
    x = _nchw(_images("tt-swin"))
    with torch.no_grad():
        torch.testing.assert_close(again.encode_image(x), tmodel.encode_image(x), rtol=0, atol=0)
    _assert_tree_equal(convert_clip({k: v.numpy() for k, v in classic.items()}),
                       jax.tree.map(np.asarray, jparams))


# -- the factory over every vendored config ------------------------------------------------
def _jax_outcome(name):
    """daclip_tpu's parameter count for a config (its init traced, not
    run), or the error it raises."""
    from daclip_tpu.models.coca import CoCa, CoCaCfg

    try:
        d = jclip.get_model_config(name)
        if "coca" in name:
            cfg = CoCaCfg.from_dict(d)
            model, n_text = CoCa(cfg), cfg.text.context_length + 1
        else:
            cfg = jclip.CLIPCfg.from_dict(d)
            custom = (cfg.custom_text or cfg.text.hf_model_name) and "daclip" not in name
            model = (jclip.DaCLIP(cfg) if "daclip" in name
                     else jclip.CustomTextCLIP(cfg) if custom else jclip.CLIP(cfg))
            n_text = cfg.text.context_length * (2 if "daclip" in name else 1)
        img = jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3))
        txt = jnp.zeros((1, n_text), jnp.int32)
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), img, txt))
        return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    except (ImportError, ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e).replace("daclip_tpu", "daclip_torch")


def _torch_outcome(name):
    try:
        with torch.device("meta"):
            model = tfactory.create_model(name)
        return sum(p.numel() for p in model.parameters())
    except (ImportError, ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)


VENDORED = sorted(tclip._asset_configs())


@pytest.mark.parametrize("name", VENDORED)
def test_factory_builds_each_vendored_config_as_daclip_tpu(name):
    """Every vendored config builds with daclip_tpu's parameter count, or
    is refused with daclip_tpu's error."""
    got, want = _torch_outcome(name), _jax_outcome(name)
    assert got == want
    family = ("RN", "convnext_", "EVA", "swin", "vit_", "ViT-M-16-alt", "coca_")
    if name.startswith(family):
        assert isinstance(got, int), got


def test_factory_errors_no_longer_name_the_queue():
    for name in VENDORED:
        out = _torch_outcome(name)
        assert isinstance(out, int) or "queue 1 item 6" not in out[1]


# -- locking -----------------------------------------------------------------------------
def _unlocked_count_jax(jparams, **kw):
    mask = jlock.build_update_mask(jparams, lock_image=True, **kw)
    return sum(int(np.asarray(np.broadcast_to(m, np.shape(p))).sum())
               for m, p in zip(jax.tree.leaves(mask["visual"]),
                               jax.tree.leaves(jparams["visual"])))


def _unlocked_count_torch(tmodel, **kw):
    named = dict(tmodel.named_parameters())
    mask = tlock.build_update_mask(list(named), lock_image=True, **kw)
    return sum(named[n].numel() for n, v in mask.items() if n.startswith("visual.") and v)


@pytest.mark.parametrize("name,unlocked", [("tt-RN", 0), ("tt-convnext", 16 * 32),
                                           ("tt-convnext-mlp", 32 * 32 + 32 + 32 * 16),
                                           ("tt-EVA02", 0), ("tt-swin", 32 * 16),
                                           ("tt-vit-relpos", 32 * 16)])
def test_lock_image_trains_what_daclip_tpu_trains(name, unlocked):
    """--lock-image: ModifiedResNet and EVA lock whole, the other timm
    towers keep their adapter head trainable, as daclip_tpu's masks."""
    _, jparams, tmodel = _pair(name)
    assert _unlocked_count_torch(tmodel) == _unlocked_count_jax(jparams) == unlocked
    names = dict(tmodel.named_parameters())
    mask = tlock.build_update_mask(list(names), lock_image=True)
    assert all(v == 1.0 for n, v in mask.items() if not n.startswith("visual."))


@pytest.mark.parametrize("name", ["tt-RN", "tt-convnext", "tt-EVA02"])
def test_non_vit_towers_refuse_unlocked_groups(name):
    _, jparams, tmodel = _pair(name)
    with pytest.raises(ValueError, match="only supported for the open_clip ViT") as je:
        jlock.build_update_mask(jparams, lock_image=True, lock_image_unlocked_groups=1)
    with pytest.raises(ValueError, match="only supported for the open_clip ViT") as te:
        tlock.build_update_mask([n for n, _ in tmodel.named_parameters()], lock_image=True,
                                lock_image_unlocked_groups=1)
    assert str(te.value) == str(je.value)


def test_towers_refuse_the_controller():
    for name in ("tt-RN", "tt-convnext", "tt-EVA02", "tt-swin", "tt-vit-gap"):
        model = tfactory.create_model(name)
        with pytest.raises(NotImplementedError, match="controller"):
            model.visual(_nchw(_images(name)), output_hiddens=True)


def test_timm_refusals_are_daclip_tpu_s():
    for args in [("convnext_tt", 8, "abs_attn"), ("eva02_tt", 8, "avg"),
                 ("swin_tt", 8, "token"), ("vit_gap_tt", 8, "token"), ("resnet50", 8, "")]:
        with pytest.raises((ValueError, ImportError)) as je:
            jconvnext.build_timm_tower(*args)
        with pytest.raises(type(je.value)) as te:
            tconvnext.build_timm_tower(*args)
        assert str(te.value).replace("contribute a backbone", "contribute a flax backbone") \
            == str(je.value)


# -- training ------------------------------------------------------------------------------
@pytest.mark.parametrize("name,lock", [("tt-RN", False), ("tt-RN", True), ("tt-convnext", True),
                                       ("tt-EVA02", False), ("tt-swin", True),
                                       ("tt-vit-relpos", False), ("tt-ViT-ls", False)])
def test_two_clip_steps_equal_optax(name, lock):
    """Plain CLIP training of each tower (with --lock-image where `lock`)
    against daclip_tpu's step: the loss, grad norm and logit scale per
    step, then every parameter (its weight decay follows daclip_tpu's
    stacked layout), the locked ones bit for bit."""
    from daclip_torch.train import clip_train as tct
    from daclip_tpu.train import clip_train as jct

    jmodel, jparams, tmodel = _pair(name)
    kw = dict(lr=1e-3, warmup=1, total_steps=4, wd=0.2, eps=1e-3, variant="clip")
    jcfg, tcfg = jct.ClipTrainConfig(**kw), tct.ClipTrainConfig(**kw)
    trainable = dict(jparams)
    jmask = jlock.build_update_mask(trainable, lock_image=lock)
    tmask = tlock.build_update_mask([n for n, _ in tmodel.named_parameters()], lock_image=lock)
    state = tct.init_state(tmodel, tcfg, tmask, device="cpu")
    tstep = tct.make_train_step(tmodel, tcfg, None, device="cpu")
    jstep = jax.jit(jct.make_train_step(jmodel.apply, {}, jcfg, None, update_mask=jmask))
    jstate = jct.init_state(trainable, jcfg)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    rng = np.random.RandomState(7)
    for i in range(2):
        toks = rng.randint(1, 60, (4, TEXT["context_length"])).astype(np.int32)
        toks[:, -1] = 63
        b = {"images": _images(name, B=4, seed=20 + i), "texts": toks}
        jstate, want = jstep(jstate, b, {})
        state, got = tstep(state, {"images": _nchw(b["images"]), "texts": torch.from_numpy(toks)})
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} at step {i}")
    want_sd = clip_state_dict_from_jax(jstate.params, custom_text=_is_custom(name))
    got_sd = tmodel.state_dict()
    moved = 0
    for k, w in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=k)
        locked = lock and k.startswith("visual.") and tmask.get(k, 1.0) == 0.0
        if locked:
            assert torch.equal(got_sd[k], before[k]), k
        moved += int(not torch.equal(got_sd[k], before[k]))
    assert moved > 0


def test_cli_lock_image_trains_the_head_and_the_text_only(tmp_path):
    """`cli.train_daclip --model <a convnext config> --lock-image` on the
    CPU over the synthetic set: the trunk ends bit for bit where it started,
    the adapter head and the text tower move (daclip_tpu's mask)."""
    from daclip_torch.cli import train_daclip as tcli
    from daclip_torch.utils.checkpoint import load_clip_state_dict

    name = "tt-convnext-cli"
    cfg = dict(CONFIGS["tt-convnext"], text_cfg=dict(TEXT, vocab_size=49408))
    tclip._MODEL_CONFIGS[name] = cfg
    try:
        before = tfactory.create_model(name).state_dict()
        res = tcli.main(["--model", name, "--lock-image", "--dataset-type", "synthetic",
                         "--train-num-samples", "8", "--batch-size", "4", "--epochs", "1",
                         "--workers", "0", "--lr", "1e-3", "--logs", str(tmp_path),
                         "--name", "lock", "--device", "cpu"])
    finally:
        del tclip._MODEL_CONFIGS[name]
    after = load_clip_state_dict(str(tmp_path / "lock" / "checkpoints"))
    assert np.isfinite(res["best_loss"]) and set(after) == set(before)
    moved = {k for k in before if not torch.equal(after[k], before[k].float())}
    assert not any(k.startswith("visual.trunk.") for k in moved), sorted(moved)[:5]
    assert "visual.head.proj.weight" in moved
    assert any(k.startswith("transformer.") for k in moved)
