"""The last public names of daclip_tpu, each held against daclip_tpu on the
CPU: the top-level and `models` exports, `create_model_from_pretrained`,
`transforms.resize_max_size` and `image_transform(scale=, seed=)`,
`utils.logging.setup_logger` and `ThroughputMeter`,
`models.layers.ScaledCosineAttention`, `CLIP.encode_image(output_hiddens=)`,
the IR-SDE's schedule lookups and `data.loader.device_prefetch`."""
import logging
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daclip_torch
import daclip_tpu
from daclip_torch import models as tmodels
from daclip_torch import transforms as ttf
from daclip_torch.convert import clip_state_dict_from_jax
from daclip_torch.data import loader as tloader
from daclip_torch.models.clip import CLIP as TorchCLIP
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.layers import ScaledCosineAttention
from daclip_torch.sde import IRSDE as TorchIRSDE
from daclip_torch.utils import logging as tlog
from daclip_tpu import models as jmodels
from daclip_tpu import transforms as jtf
from daclip_tpu.models.clip import CLIP as JaxCLIP
from daclip_tpu.models.clip import CLIPCfg as JaxCfg
from daclip_tpu.models.layers import ScaledCosineAttention as JaxScaledCosineAttention
from daclip_tpu.sde.irsde import IRSDE as JaxIRSDE
from daclip_tpu.utils import logging as jlog

torch.set_num_threads(1)
NAME = "daclip_test-tiny"
TOP_LEVEL = ["create_loss", "create_model", "create_model_and_transforms",
             "create_model_from_pretrained", "get_tokenizer", "list_pretrained",
             "list_pretrained_tags_by_model"]


def test_top_level_exports_equal_jax():
    for name in TOP_LEVEL + ["IRSDE"]:
        assert callable(getattr(daclip_torch, name)), name
        assert callable(getattr(daclip_tpu, name)), name
    assert set(TOP_LEVEL) <= set(daclip_torch.__all__)
    assert daclip_torch.list_pretrained() == daclip_tpu.list_pretrained()
    assert daclip_torch.list_pretrained(as_str=True) == daclip_tpu.list_pretrained(as_str=True)
    for model in ("ViT-B-32", "ViT-L-14", "RN50", "convnext_base"):
        assert (daclip_torch.list_pretrained_tags_by_model(model)
                == daclip_tpu.list_pretrained_tags_by_model(model))
    text = ["a photo of a hazy street", "noisy", ""]
    np.testing.assert_array_equal(np.asarray(daclip_torch.get_tokenizer(NAME)(text)),
                                  np.asarray(daclip_tpu.get_tokenizer(NAME)(text)))
    for flags in (dict(distill=True), dict(model="coca_ViT-B-32"), dict(da=True),
                  dict(model=NAME), dict(model="ViT-B-32")):
        args = types.SimpleNamespace(**flags)
        ours, want = daclip_torch.create_loss(args), daclip_tpu.create_loss(args)
        name = lambda f: getattr(getattr(f, "func", f), "__name__", "")
        assert name(ours) == name(want), flags
        assert getattr(ours, "keywords", None) == getattr(want, "keywords", None)


def test_models_exports_equal_jax_and_add_model_config(tmp_path):
    assert set(jmodels.__all__) - set(tmodels.__all__) == {"CustomTextCLIP"}
    for name in tmodels.__all__:
        assert getattr(tmodels, name) is not None
    cfg = jmodels.get_model_config("test-tiny")
    cfg["embed_dim"] = 48
    (tmp_path / "test-extra.json").write_text(__import__("json").dumps(cfg))
    (tmp_path / "not-a-model.json").write_text('{"embed_dim": 1}')
    try:
        for mod in (tmodels, jmodels):
            mod.add_model_config(tmp_path)
        assert tmodels.get_model_config("test-extra") == jmodels.get_model_config("test-extra")
        assert tmodels.get_model_config("test-extra")["embed_dim"] == 48
        assert "test-extra" in tmodels.list_models() and "not-a-model" not in tmodels.list_models()
    finally:
        from daclip_torch.models import clip as tclip
        from daclip_tpu.models import clip as jclip
        tclip._MODEL_CONFIGS.pop("test-extra", None)
        jclip._MODEL_CONFIGS.pop("test-extra", None)


def test_create_model_from_pretrained_equals_jax(tmp_path):
    """A seeded DA-CLIP `.npz` of daclip_tpu's, loaded by both factories:
    the weights, and the val transform's output on one image."""
    from daclip_torch.convert import daclip_state_dict_from_jax
    from daclip_tpu.utils.native_checkpoint import save_params_npz
    from tests.test_torch_text import jax_daclip_params

    params = jax_daclip_params(seed=31, use_predictor=False)
    path = save_params_npz(str(tmp_path / "d.npz"), params)
    model, pp = daclip_torch.create_model_from_pretrained(NAME, path)
    _, jparams, jpp = daclip_tpu.create_model_from_pretrained(NAME, path)
    want = daclip_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    img = (np.random.RandomState(0).rand(45, 61, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(pp(img), jpp(img), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,max_size,fill", [((45, 61, 3), 32, 0), ((70, 20, 3), 64, 127),
                                                 ((16, 16, 3), 16, (10, 20, 30)),
                                                 ((33, 90, 1), 40, 255)])
def test_resize_max_size_equals_jax_byte_for_byte(shape, max_size, fill):
    rng = np.random.RandomState(sum(shape) + max_size)
    for img in ((rng.rand(*shape) * 255).astype(np.uint8), rng.rand(*shape).astype(np.float32)):
        got = ttf.resize_max_size(img, max_size, fill_color=fill)
        want = jtf.resize_max_size(img, max_size, fill_color=fill)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (max_size, max_size, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [(0.9, 1.0), (0.3, 0.6)])
@pytest.mark.parametrize("backend", ["pil", "cv2"])
def test_image_transform_scale_and_seed_equal_jax(scale, backend):
    img = (np.random.RandomState(7).rand(57, 83, 3) * 255).astype(np.uint8)
    ours = ttf.image_transform(32, is_train=True, scale=scale, seed=11, backend=backend)
    want = jtf.image_transform(32, is_train=True, scale=scale, seed=11, backend=backend)
    for _ in range(4):  # the seeded stream goes on across calls
        np.testing.assert_allclose(ours(img), want(img), atol=1e-6, rtol=0)
    again = ttf.image_transform(32, is_train=True, scale=scale, rng=random.Random(11),
                                backend=backend)
    np.testing.assert_array_equal(again(img), ttf.image_transform(
        32, is_train=True, scale=scale, seed=11, backend=backend)(img))
    with pytest.raises(ValueError, match="seed or an rng"):
        ttf.image_transform(32, is_train=True, seed=1, rng=random.Random(1))


def test_setup_logger_and_throughput_meter_as_jax(tmp_path, monkeypatch):
    records = {}
    for pkg, mod in (("jax", jlog), ("torch", tlog)):
        name = f"public-names-{pkg}"
        logger = mod.setup_logger(name, str(tmp_path / pkg), level=logging.DEBUG)
        assert mod.setup_logger(name, str(tmp_path / pkg)) is logger   # set up once
        logger.info("step %d", 3)
        for h in logger.handlers:
            h.flush()
        records[pkg] = ([type(h).__name__ for h in logger.handlers],
                        [h.formatter._fmt for h in logger.handlers],
                        (tmp_path / pkg / f"{name}.log").read_text().split(" - ", 1)[1])
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
    assert records["torch"] == records["jax"]
    clock = iter([10.0, 12.0])
    for mod in (jlog, tlog):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        meter = mod.ThroughputMeter(num_devices=4)
        meter.update(6)
        meter.update(10)
        assert meter.rates() == {"samples_per_second": 8.0,
                                 "samples_per_second_per_device": 2.0}
        clock = iter([10.0, 12.0])


@pytest.mark.parametrize("scaled_cosine,scale_heads,masked", [
    (True, False, False), (True, True, True), (False, False, True), (False, True, False)])
def test_scaled_cosine_attention_equals_jax(scaled_cosine, scale_heads, masked):
    B, N, D, H = 2, 7, 32, 4
    rng = np.random.RandomState(3)
    x = rng.randn(B, N, D).astype(np.float32)
    mask = np.triu(np.full((N, N), -np.inf, np.float32), 1) if masked else None
    jm = JaxScaledCosineAttention(D, H, scaled_cosine=scaled_cosine, scale_heads=scale_heads)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
                          params)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    None if mask is None else jnp.asarray(mask))
    m = ScaledCosineAttention(D, H, scaled_cosine=scaled_cosine, scale_heads=scale_heads)
    sd = {"in_proj_weight": params["in_proj"]["kernel"].T,
          "in_proj_bias": params["in_proj"]["bias"],
          "out_proj.weight": params["out_proj"]["kernel"].T,
          "out_proj.bias": params["out_proj"]["bias"]}
    if scaled_cosine:
        sd["logit_scale"] = params["logit_scale"]
    if scale_heads:
        sd["head_scale"] = params["head_scale"]
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                      strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_clip_encode_image_output_hiddens_equals_jax():
    from tests.test_torch_text import _fill

    cfg = JaxCfg.from_dict(jmodels.get_model_config("test-tiny"))
    jm = JaxCLIP(cfg)
    res, L = cfg.vision.image_size, cfg.text.context_length
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            image=jnp.zeros((1, res, res, 3)),
                                            text=jnp.zeros((1, L), jnp.int32)))["params"]
    params = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(2)), shapes)
    img = np.random.RandomState(4).rand(2, res, res, 3).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(img), normalize=True, output_hiddens=True,
                    method=jm.encode_image)
    model = TorchCLIP(TorchCfg.from_dict(tmodels.get_model_config("test-tiny")))
    model.load_state_dict(clip_state_dict_from_jax(jax.tree.map(np.asarray, params)),
                          strict=True)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                 normalize=True, output_hiddens=True)
        plain = model.encode_image(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                   normalize=True)
    assert isinstance(got, tuple) and len(got) == len(want) == 2
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    assert torch.equal(got[0], plain)
    # each block's output, as the (L, B, N, D) stack daclip_tpu returns
    np.testing.assert_allclose(torch.stack(got[1]).numpy(), np.asarray(want[1]), atol=1e-4)


def test_irsde_schedule_lookups_equal_jax():
    for kw in (dict(max_sigma=50, T=100), dict(max_sigma=10, T=20, schedule="linear"),
               dict(max_sigma=50, T=100, sample_T=25)):
        ours, want = TorchIRSDE(**kw), JaxIRSDE(**kw)
        t = np.asarray([[1, 5], [ours.sample_T, 0]])
        for name in ("thetas", "sigmas", "thetas_cumsum", "sigma_bar", "weights"):
            got = getattr(ours, name)(torch.from_numpy(t))
            assert got.dtype == torch.float32 and got.shape == t.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(want, name)(t)))
            assert getattr(ours, name)(3) == float(getattr(want, name)(3)), name


@pytest.mark.parametrize("size", [1, 2, 3])
def test_device_prefetch_keeps_size_batches_ahead(size):
    rng = np.random.RandomState(size)
    batches = [{"GT": rng.rand(2, 8, 8, 3).astype(np.float32), "t": np.arange(2),
                "paths": [f"{i}a", f"{i}b"]} for i in range(5)]
    pulled = []

    def source():
        for i, b in enumerate(batches):
            pulled.append(i)
            yield b

    out = []
    for i, b in enumerate(tloader.device_prefetch(source(), "cpu", size=size)):
        # when batch i is handed over, the next `size` are already copied,
        # as daclip_tpu's device_prefetch does
        assert len(pulled) == min(len(batches), i + size + 1)
        out.append(b)
    assert len(out) == len(batches)
    for b, want in zip(out, batches):
        ref = tloader.to_device(want, "cpu")
        assert b["paths"] == want["paths"]
        assert set(b) == set(ref) | {"paths"}
        assert all(torch.equal(b[k], ref[k]) for k in ref)
        assert b["GT"].shape == (2, 3, 8, 8)
