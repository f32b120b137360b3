"""Patch dropout (`--force-patch-dropout`) in daclip_torch against daclip_tpu
on the CPU, float32: the ViT's output, DaCLIP's forward (both towers and
the GT tower each drawing a subset) and the CLIP / DaCLIP trainers' losses
and updates, with both packages fed JAX's own noise (the normals daclip_tpu
draws from `fold_in(PRNGKey(0), step)`, recorded and replayed through the
port's `patch_dropout_noise`), held within 1e-5 relative; the kept-token
counts; eval mode unchanged; the port's own draws: one generator seeded
from the step, the same subsets in both passes of an accumulation step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch import factory as tfactory
from daclip_torch.convert import clip_state_dict_from_jax, daclip_state_dict_from_jax
from daclip_torch.data.csv_dataset import build_banks
from daclip_torch.models.clip import CLIP as TorchCLIP
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.models.transformer import VisionTransformer as TorchViT
from daclip_torch.tokenizer import tokenize
from daclip_torch.train import clip_train as tct
from daclip_tpu.models import CLIPCfg as JaxCfg
from daclip_tpu.models import DaCLIP as JaxDaCLIP
from daclip_tpu.models import get_model_config
from daclip_tpu.models.clip import CLIP as JaxCLIP
from daclip_tpu.train import clip_train as jct
from tests.test_torch_text import NAME, _fill

torch.set_num_threads(1)
RTOL = 1e-5
L = 16


def _config(p, res):
    d = get_model_config(NAME)
    d["vision_cfg"] = dict(d["vision_cfg"], image_size=res, patch_dropout=p)
    return d


def _params(model, cfg, seed, daclip):
    res, L_ = cfg.vision.image_size, cfg.text.context_length
    kw = dict(image=jnp.zeros((1, res, res, 3)), text=jnp.zeros((1, 2 * L_ if daclip else L_),
                                                                 jnp.int32))
    if daclip:
        kw.update(all_d_type_tokens=jnp.zeros((28, L_), jnp.int32),
                  bin_center_bank=jnp.zeros((4, 7)))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), **kw))["params"]
    return jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(seed)), shapes)


def _models(p, res, daclip, use_predictor=True, seed=0):
    d = _config(p, res)
    jcfg = JaxCfg.from_dict(d)
    if daclip:
        jm = JaxDaCLIP(jcfg, use_predictor=use_predictor)
        tm = TorchDaCLIP(TorchCfg.from_dict(d), use_predictor=use_predictor)
        params = _params(jm, jcfg, seed, True)
        if not use_predictor:
            params.pop("predictor", None)
        tm.load_state_dict(daclip_state_dict_from_jax(params), strict=True)
    else:
        jm, tm = JaxCLIP(jcfg), TorchCLIP(TorchCfg.from_dict(d))
        params = _params(jm, jcfg, seed, False)
        tm.load_state_dict(clip_state_dict_from_jax(params), strict=True)
    return jm, tm.eval(), params


@pytest.fixture
def noise(monkeypatch):
    """Records every normal daclip_tpu draws (its patch noise) and replays
    them, in order, as the port's patch noise."""
    recorded, replay = [], []
    real = jax.random.normal

    def record(key, shape=(), dtype=jnp.float32):
        out = real(key, shape, dtype)
        # at run time, in program order, also inside a jitted step
        jax.debug.callback(lambda a: recorded.append(np.array(a)), out, ordered=True)
        return out

    def play(self, shape, device, generator=None):
        a = replay.pop(0)
        assert a.shape == tuple(shape)
        return torch.from_numpy(np.array(a)).to(device)

    monkeypatch.setattr(jax.random, "normal", record)
    monkeypatch.setattr(TorchViT, "patch_dropout_noise", play)

    def arm():
        replay[:] = recorded
        n = len(recorded)
        recorded.clear()
        return n
    return arm


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    tol = RTOL * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _tokens_seen(module, fn):
    seen = []
    h = module.ln_pre.register_forward_hook(lambda m, i, o: seen.append(o.shape[1]))
    try:
        fn()
    finally:
        h.remove()
    return seen


@pytest.mark.parametrize("p,res", [(0.5, 64), (0.3, 64), (0.9, 32), (0.75, 48)])
def test_vit_patch_dropout_equals_jax(noise, p, res):
    """CLIP.encode_image(train=True): the features within 1e-5, the tokens
    `ln_pre` sees (1 + max(1, int(n·(1 − p)))), and without `train` every
    patch, as daclip_tpu's eval forward."""
    jm, tm, params = _models(p, res, daclip=False)
    x = np.random.RandomState(1).randn(3, res, res, 3).astype(np.float32)
    want = jm.apply({"params": params}, x, normalize=True, train=True,
                    rngs={"patch_dropout": jax.random.PRNGKey(4)}, method=jm.encode_image)
    assert noise() == 1
    got = []
    with torch.no_grad():
        seen = _tokens_seen(tm.visual, lambda: got.append(
            tm.encode_image(_nchw(x), normalize=True, train=True)))
    n = (res // 16) ** 2
    assert seen == [1 + max(1, int(n * (1 - p)))]
    _close(got[0], want, "image features")
    with torch.no_grad():
        seen = _tokens_seen(tm.visual, lambda: got.append(
            tm.encode_image(_nchw(x), normalize=True)))
    assert seen == [1 + n]
    _close(got[1], jm.apply({"params": params}, x, normalize=True, method=jm.encode_image),
           "eval mode")
    assert float((got[1] - got[0]).abs().max()) > 1e-3  # the dropout changed them


def test_eval_mode_draws_nothing_and_matches_a_model_without_dropout():
    _, with_p, _ = _models(0.5, 64, daclip=True)
    _, without, _ = _models(0.0, 64, daclip=True)
    calls = []
    real = TorchViT.patch_dropout_noise
    TorchViT.patch_dropout_noise = lambda self, *a, **k: calls.append(1) or real(self, *a, **k)
    try:
        x = _nchw(np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32))
        with torch.no_grad():
            a = with_p.encode_image(x, control=True, normalize=True)
            b = without.encode_image(x, control=True, normalize=True)
            c = without.encode_image(x, control=True, normalize=True, train=True)
    finally:
        TorchViT.patch_dropout_noise = real
    assert not calls
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v) and torch.equal(v, w)


def _batch(seed, n=3, res=64, da=True):
    rng = np.random.RandomState(seed)
    toks = lambda k: tokenize([f"a photo {rng.randint(100)} of {k}" for _ in range(n)],
                              context_length=L)
    deg_type = (rng.rand(n, 4) > 0.5).astype(np.float32)
    deg_type[0] = 1.0
    return {"images": rng.randn(n, res, res, 3).astype(np.float32),
            "gt_images": rng.randn(n, res, res, 3).astype(np.float32),
            "texts": (np.concatenate([toks("cats"), toks("noise")], 1) if da
                      else toks("dogs")).astype(np.int32),
            "deg_type": deg_type,
            "gt_val": (deg_type * rng.rand(n, 4) * 30).astype(np.float32)}


def _torch_batch(b):
    return {k: _nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in b.items()}


BANKS = build_banks(lambda t: tokenize(t, context_length=L))


def test_daclip_forward_with_patch_dropout_equals_jax(noise):
    """The controller, the frozen tower and the GT tower each draw their own
    subset (in that order), and the predictor reads the dropped features."""
    jm, tm, params = _models(0.5, 64, daclip=True)
    b = _batch(5)
    kw = dict(deg_type=b["deg_type"], gt_val=b["gt_val"], bin_center_bank=BANKS[0],
              all_d_type_tokens=BANKS[1])
    want = jm.apply({"params": params}, image=b["images"], text=b["texts"],
                    gt_images=b["gt_images"], train=True,
                    rngs={"patch_dropout": jax.random.PRNGKey(2)}, **kw)
    assert noise() == 3
    tb, got = _torch_batch(b), {}
    with torch.no_grad():
        seen = _tokens_seen(tm.visual_control, lambda: _tokens_seen(tm.visual, lambda: got.update(
            tm(image=tb["images"], text=tb["texts"], gt_images=tb["gt_images"], train=True,
               deg_type=tb["deg_type"], gt_val=tb["gt_val"],
               bin_center_bank=torch.from_numpy(BANKS[0]).float(),
               all_d_type_tokens=torch.from_numpy(BANKS[1]).long()))))
    for k in ("image_features", "image_degra_features", "text_features",
              "text_degra_features", "gt_image_features", "pred"):
        _close(got[k], want[k], k)
    assert seen == [9]


@pytest.mark.parametrize("variant", ["fork", "clip"])
def test_train_steps_with_patch_dropout_equal_jax(noise, variant):
    """Two optimizer steps of each trainer with patch dropout: the loss
    terms, grad_norm and logit_scale within 1e-5 relative, the parameters
    within 1e-5 of optax's (eps 1e-3, as tests/test_torch_clip_train.py)."""
    daclip = variant == "fork"
    jm, tm, params = _models(0.5, 64, daclip=daclip, seed=7)
    kw = dict(lr=1e-3, warmup=1, total_steps=4, wd=0.2, eps=1e-3, variant=variant,
              patch_dropout=True)
    jcfg, tcfg = jct.ClipTrainConfig(**kw), tct.ClipTrainConfig(**kw)
    banks = BANKS if daclip else None
    trainable, frozen = jct.partition_daclip_params(params) if daclip else (dict(params), {})
    jstep = jax.jit(jct.make_train_step(jm.apply, frozen, jcfg, banks))
    jstate = jct.init_state(trainable, jcfg)
    state = tct.init_state(tm, tcfg, device="cpu")
    tstep = tct.make_train_step(tm, tcfg, banks, device="cpu")
    for i in range(2):
        b = _batch(20 + i, da=daclip)
        jstate, want = jax.block_until_ready(jstep(jstate, b, frozen))
        jax.effects_barrier()
        assert noise() == (3 if daclip else 1)
        state, out = tstep(state, _torch_batch(b))
        assert set(out) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(float(out[k]), float(w), rtol=RTOL, atol=1e-6,
                                       err_msg=f"{k} at step {i}")
    to_sd = daclip_state_dict_from_jax if daclip else clip_state_dict_from_jax
    want = to_sd(jct.merge_params(jstate.params, frozen))
    for k, w in tm.state_dict().items():
        np.testing.assert_allclose(w.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_the_port_draws_from_a_generator_seeded_by_the_step():
    """Without replayed noise: two trainers from the same weights take the
    same step; the noise differs between steps and between micro-batches,
    and the two passes of an accumulation step draw the same subsets."""
    cfg = tct.ClipTrainConfig(patch_dropout=True, accum_freq=2)
    g = lambda step, j=0: tct.dropout_generator(cfg, "cpu", step, j)
    draw = lambda gen: torch.randn(8, generator=gen)
    assert torch.equal(draw(g(3)), draw(g(3)))
    assert not torch.equal(draw(g(3)), draw(g(4)))
    assert not torch.equal(draw(g(3, 0)), draw(g(3, 1)))
    assert tct.dropout_generator(dataclasses.replace(cfg, patch_dropout=False), "cpu", 3) is None

    _, tm, _ = _models(0.5, 64, daclip=True, seed=3)
    tcfg = tct.ClipTrainConfig(lr=1e-3, warmup=1, total_steps=4, eps=1e-3, accum_freq=2,
                               patch_dropout=True)
    tct.init_state(tm, tcfg, device="cpu")
    step = tct.make_accum_train_step(tm, tcfg, BANKS, device="cpu")
    drawn = []
    real = TorchViT.patch_dropout_noise
    TorchViT.patch_dropout_noise = lambda self, *a, **k: drawn.append(real(self, *a, **k)) \
        or drawn[-1]
    try:
        step.loss_and_grads([_torch_batch(_batch(30)), _torch_batch(_batch(31))], 5)
    finally:
        TorchViT.patch_dropout_noise = real
    # pass 1: 3 draws a micro-batch (controller, frozen, GT); pass 2: 2 (no GT)
    assert len(drawn) == 10
    pass1, pass2 = drawn[:6], drawn[6:]
    for j in (0, 1):
        assert torch.equal(pass1[3 * j], pass2[2 * j])
        assert torch.equal(pass1[3 * j + 1], pass2[2 * j + 1])
    assert not torch.equal(pass1[0], pass1[3])


def test_factory_force_patch_dropout_equals_jax():
    """The override edits the config's vision_cfg, as daclip_tpu/factory.py:
    96-97 does."""
    ours = tfactory.create_model(NAME, force_patch_dropout=0.4)
    ref = JaxCfg.from_dict(_config(0.4, 32))
    assert ours.cfg.vision == TorchCfg.from_dict(_config(0.4, 32)).vision
    assert ours.cfg.vision.patch_dropout == ref.vision.patch_dropout == 0.4
    assert ours.visual.patch_dropout == ours.visual_control.patch_dropout == 0.4
    assert tfactory.create_model(NAME).visual.patch_dropout == 0.0
