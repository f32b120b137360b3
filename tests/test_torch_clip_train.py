"""daclip_torch's DA-CLIP / CLIP trainer against daclip_tpu's on the CPU, in
float32 on `daclip_test-tiny`: the three CLIP schedules, the LiT lock masks,
three optimizer steps of each variant (fork, uir, clip, clip with
distillation, clip with locking and a global-norm clip) and the two-pass
accumulation, from one seeded parameter tree and the same numpy batches.
Per step the loss terms, `grad_norm` and `logit_scale` are held within rel
1e-5; after the steps every parameter within abs 1e-5 of optax's, and the
frozen ones bit for bit unchanged."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.convert import clip_state_dict_from_jax, daclip_state_dict_from_jax
from daclip_torch.data.csv_dataset import build_banks
from daclip_torch.losses import daclip_loss_fork
from daclip_torch.models.clip import CLIP as TorchCLIP
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.tokenizer import tokenize
from daclip_torch.train import clip_train as tct
from daclip_torch.train import locking as tlock
from daclip_torch.train import schedules as tsched
from daclip_tpu.models import CLIPCfg as JaxCfg
from daclip_tpu.models import DaCLIP as JaxDaCLIP
from daclip_tpu.models import get_model_config
from daclip_tpu.models.clip import CLIP as JaxCLIP
from daclip_tpu.train import clip_train as jct
from daclip_tpu.train import locking as jlock
from daclip_tpu.train import schedules as jsched
from tests.test_torch_text import NAME, jax_daclip_params

torch.set_num_threads(1)
B, RES, L = 4, 32, 16
RTOL, PARAM_ATOL = 1e-5, 1e-5


# -- schedules ----------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("clip_cosine_lr", (5e-4, 10, 100)), ("clip_cosine_lr", (1e-3, 0, 50)),
    ("clip_const_lr", (5e-4, 10)),
    ("clip_const_lr_cooldown", (5e-4, 10, 100, 30, 1.0, 0.0)),
    ("clip_const_lr_cooldown", (2e-4, 5, 80, 20, 2.0, 1e-5))])
def test_clip_schedules_equal_jax(name, args):
    ours, ref = getattr(tsched, name)(*args), getattr(jsched, name)(*args)
    over = tsched.warmup_override(ours, 4, 3e-4)
    ref_over = jsched.warmup_override(ref, 4, 3e-4)
    for step in range(0, 130, 3):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=0, atol=1e-7)
        np.testing.assert_allclose(over(step), float(ref_over(step)), rtol=0, atol=1e-7)


# -- lock masks -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jparams():
    return jax_daclip_params(seed=0)


def _mask_by_torch_name(jmask, jtree):
    """A JAX mask tree over a CLIP tree, broadcast to its parameters and
    renamed to the port's names."""
    full = jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m, np.float32), p.shape),
                        jmask, jtree)
    return {k: v.numpy() for k, v in clip_state_dict_from_jax(full).items()}


@pytest.mark.parametrize("image,text", [((True, 0), (False, 0, True)),
                                        ((True, 1), (True, 0, True)),
                                        ((True, 2), (True, 1, True)),
                                        ((False, 0), (True, 2, False)),
                                        ((True, 3), (True, 1, False))])
def test_lock_masks_equal_jax(jparams, image, text):
    clip = jparams["clip"]
    kw = dict(lock_image=image[0], lock_image_unlocked_groups=image[1], lock_text=text[0],
              lock_text_unlocked_layers=text[1], lock_text_freeze_layer_norm=text[2])
    want = _mask_by_torch_name(jlock.build_update_mask(clip, **kw), clip)
    names = list(TorchCLIP(TorchCfg.from_dict(get_model_config(NAME))).state_dict())
    got = tlock.build_update_mask(names, **kw)
    assert set(got) == set(want)
    for name, m in want.items():
        assert np.all(m == got[name]), name
    assert {v for v in got.values()} <= {0.0, 1.0}


def test_lock_masks_none_when_nothing_locks():
    assert tlock.build_update_mask(["visual.proj"]) is None


# -- train steps ------------------------------------------------------------------------
def _batch(seed, da=True, n=B):
    rng = np.random.RandomState(seed)
    toks = lambda k: tokenize([f"a photo {rng.randint(100)} of {k}" for _ in range(n)],
                              context_length=L)
    deg_type = (rng.rand(n, 4) > 0.5).astype(np.float32)
    deg_type[0] = 1.0
    lows, highs = np.array([0.5, 5, 0.5, 10]), np.array([4, 40, 4, 80])
    return {"images": rng.randn(n, RES, RES, 3).astype(np.float32),
            "gt_images": rng.randn(n, RES, RES, 3).astype(np.float32),
            "texts": (np.concatenate([toks("cats"), toks("noise")], 1) if da
                      else toks("dogs")).astype(np.int32),
            "deg_type": deg_type,
            "gt_val": (deg_type * (lows + rng.rand(n, 4) * (highs - lows))).astype(np.float32)}


def _torch_batch(b):
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


BANKS = build_banks(lambda t: tokenize(t, context_length=L))
# eps 1e-3, not 1e-6: the key projection's bias has a zero gradient up to
# rounding (the softmax ignores a shift of every logit), ~1e-7 here in each
# package with another sign, and Adam's first step turns any gradient well
# above eps into ±lr; at 1e-3 that noise moves a parameter by lr·1e-4
CFG = dict(lr=1e-3, warmup=2, total_steps=6, wd=0.2, eps=1e-3)


def _setup(variant, jparams, lock=False, clip_norm=None, distill=False, accum_freq=1):
    """(torch model, its trainer state and step, JAX step and state, frozen
    JAX params, teacher params, to_sd) for one variant."""
    cfg_dict = get_model_config(NAME)
    kw = dict(CFG, variant=variant, grad_clip_norm=clip_norm, distill=distill,
              accum_freq=accum_freq)
    jcfg, tcfg = jct.ClipTrainConfig(**kw), tct.ClipTrainConfig(**kw)
    banks = BANKS if variant == "fork" else None
    teacher = t_params = None
    if variant == "clip":
        params = jparams["clip"]
        jmodel = JaxCLIP(JaxCfg.from_dict(cfg_dict), dtype=jnp.float32)
        trainable, frozen = dict(params), {}
        model = TorchCLIP(TorchCfg.from_dict(cfg_dict))
        to_sd = clip_state_dict_from_jax
        if distill:
            t_params = jax_daclip_params(seed=5)["clip"]
            teacher = TorchCLIP(TorchCfg.from_dict(cfg_dict))
            teacher.load_state_dict(clip_state_dict_from_jax(t_params), strict=True)
    else:
        params = dict(jparams)
        if variant == "uir":
            params.pop("predictor")
        jmodel = JaxDaCLIP(JaxCfg.from_dict(cfg_dict), use_predictor=variant == "fork",
                           dtype=jnp.float32)
        trainable, frozen = jct.partition_daclip_params(params)
        model = TorchDaCLIP(TorchCfg.from_dict(cfg_dict), use_predictor=variant == "fork")
        to_sd = daclip_state_dict_from_jax
    model.load_state_dict(to_sd(params), strict=True)
    lock_kw = dict(lock_image=True, lock_image_unlocked_groups=1, lock_text=True,
                   lock_text_unlocked_layers=1) if lock else {}
    jmask = jlock.build_update_mask(trainable, **lock_kw)
    tmask = tlock.build_update_mask([n for n, _ in tct.partition_daclip_params(model)[0]],
                                    **lock_kw)
    state = tct.init_state(model, tcfg, tmask, device="cpu")
    if accum_freq > 1:
        tstep = tct.make_accum_train_step(model, tcfg, banks, device="cpu")
        jstep = jct.make_accum_train_step(jmodel.apply, frozen, jcfg, banks, update_mask=jmask)
        jstate = jct.init_state(trainable, dataclasses.replace(jcfg, accum_freq=1))
    else:
        tstep = tct.make_train_step(model, tcfg, banks, distill_model=teacher, device="cpu")
        distill_apply = None
        if distill:
            distill_apply = JaxCLIP(JaxCfg.from_dict(cfg_dict), dtype=jnp.float32).apply
        jstep = jct.make_train_step(jmodel.apply, frozen, jcfg, banks, update_mask=jmask,
                                    distill_apply=distill_apply)
        jstate = jct.init_state(trainable, jcfg)
    return model, state, tstep, jax.jit(jstep), jstate, frozen, t_params, to_sd


def _check_metrics(got, want, step):
    assert set(got) == set(want), (set(got), set(want))
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=RTOL, atol=1e-6,
                                   err_msg=f"{k} at step {step}")


def _check_params(model, jstate, frozen, to_sd, frozen_before):
    want = to_sd(jct.merge_params(jstate.params, frozen))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    for k, v in frozen_before.items():
        assert torch.equal(got[k], v), f"frozen {k} changed"


@pytest.mark.parametrize("variant,lock,clip_norm,distill", [
    ("fork", False, None, False), ("uir", False, None, False), ("clip", False, None, False),
    ("clip", False, None, True), ("clip", True, 0.05, False)])
def test_three_train_steps_equal_optax(jparams, variant, lock, clip_norm, distill):
    model, state, tstep, jstep, jstate, frozen, t_params, to_sd = _setup(
        variant, jparams, lock, clip_norm, distill)
    # the frozen CLIP of a DaCLIP, or the parameters the lock masks out
    locked = {n for g in state.optimizer.param_groups if g["update_mask"] == 0.0
              for n, p in state.params if any(p is q for q in g["params"])}
    assert bool(locked) == lock
    frozen_before = {k: v.clone() for k, v in model.state_dict().items()
                     if k in locked or (variant != "clip" and k.startswith(("clip.", "visual.")))}
    for i in range(3):
        b = _batch(10 + i, da=variant != "clip")
        args = (frozen, t_params) if distill else (frozen,)
        jstate, want = jstep(jstate, b, *args)
        state, got = tstep(state, _torch_batch(b))
        _check_metrics(got, want, i)
        if clip_norm:
            assert float(want["grad_norm"]) > clip_norm  # the clip is active
    assert state.step == 3
    _check_params(model, jstate, frozen, to_sd, frozen_before)
    for p in model.clip.parameters() if variant != "clip" else ():
        assert not p.requires_grad and p.grad is None


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def test_accum_step_equals_jax_and_its_gradient_the_full_batch(jparams):
    model, state, tstep, jstep, jstate, frozen, _, to_sd = _setup("fork", jparams,
                                                                  accum_freq=2)
    frozen_before = {k: v.clone() for k, v in model.state_dict().items()
                     if k.startswith(("clip.", "visual."))}
    for i in range(2):
        micro = [_batch(20 + 2 * i), _batch(21 + 2 * i)]
        jstate, want = jstep(jstate, _stack(micro), frozen)
        state, got = tstep(state, [_torch_batch(b) for b in micro])
        _check_metrics(got, want, i)
    _check_params(model, jstate, frozen, to_sd, frozen_before)

    # the accumulated gradient against the whole batch's: equal, but for
    # logit_scale, which gets accum_freq× its gradient
    micro = [_torch_batch(_batch(30)), _torch_batch(_batch(31))]
    total, _ = tstep.loss_and_grads(micro)
    accum = {n: p.grad.clone() for n, p in state.params}
    full = {k: torch.cat([m[k] for m in micro]) for k in micro[0]}
    banks = tct._bank_tensors(BANKS, torch.device("cpu"))
    model.zero_grad(set_to_none=True)
    out = model(image=full["images"], text=full["texts"], gt_images=full["gt_images"],
                deg_type=full["deg_type"], gt_val=full["gt_val"], bin_center_bank=banks[0],
                all_d_type_tokens=banks[1])
    loss = sum(daclip_loss_fork(out).values())
    loss.backward()
    np.testing.assert_allclose(float(total), 2 * float(loss.detach()), rtol=RTOL)
    for name, p in state.params:
        want = p.grad * (2 if name == "logit_scale" else 1)
        tol = 1e-6 + RTOL * float(want.abs().max())
        np.testing.assert_allclose(accum[name].numpy(), want.numpy(), rtol=0, atol=tol,
                                   err_msg=name)


def test_accum_step_refuses_distillation_and_single_batches():
    model = TorchDaCLIP(TorchCfg.from_dict(get_model_config(NAME)))
    with pytest.raises(ValueError, match="accum_freq > 1"):
        tct.make_accum_train_step(model, tct.ClipTrainConfig(accum_freq=1), device="cpu")
    with pytest.raises(ValueError, match="distillation"):
        tct.make_accum_train_step(model, tct.ClipTrainConfig(accum_freq=2, distill=True),
                                  device="cpu")


def test_partition_freezes_the_clip_and_counts_its_gradient_out(jparams):
    model = TorchDaCLIP(TorchCfg.from_dict(get_model_config(NAME)), use_predictor=True)
    trainable, frozen = tct.partition_daclip_params(model)
    jtrain, jfrozen = jct.partition_daclip_params(jparams)
    assert {n.split(".")[0] for n, _ in trainable} == set(jtrain) == {
        "visual_control", "logit_scale", "predictor"}
    assert {n.split(".")[0] for n, _ in frozen} == set(jfrozen) == {"clip"}
    assert all(not p.requires_grad for _, p in frozen)
    opt = tct.make_optimizer(trainable, tct.ClipTrainConfig())
    assert sum(len(g["params"]) for g in opt.param_groups) == len(trainable)
    decay = {id(p) for g in opt.param_groups if g["weight_decay"] for p in g["params"]}
    assert decay == {id(p) for n, p in trainable if tct.decays(n, p)}
    # optax's mask is ndim ≥ 2 on the JAX tree, whose blocks, zero modules
    # and regressors are stacked: the same parameters, by the port's names
    want = daclip_state_dict_from_jax(jax.tree.map(
        lambda p: np.full(np.shape(p), float(np.ndim(p) >= 2), np.float32), jparams))
    for n, p in trainable:
        assert np.all(want[n].numpy() == float(tct.decays(n, p))), n
    assert tct.decays("visual_control.transformer.transformer.resblocks.0.ln_1.bias",
                      torch.zeros(3)) and not tct.decays("visual_control.ln_post.bias",
                                                         torch.zeros(3))


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TorchDaCLIP(TorchCfg.from_dict(get_model_config(NAME)))
    for fn in (functools.partial(tct.init_state, model, tct.ClipTrainConfig()),
               functools.partial(tct.make_train_step, model, tct.ClipTrainConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
