"""daclip_torch restoration training against daclip_tpu's, on the CPU.

The same numpy inputs, weights and gradients go through both packages: the
IR-SDE's tensor-t step functions and training states, the matching loss and
every UNet parameter gradient (JAX `value_and_grad` of the trainer's loss
formula vs the port's `loss_fn`), the optimizers with their schedules and
clip against optax, the EMA, and the checkpoint round trip into
`DACLIPRestorer`. On the CPU the port's kernel wrappers take their plain
versions through the same autograd Functions as on the card."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from daclip_torch.convert import load_torch_state_dict, unet_state_dict_from_jax
from daclip_torch.losses import matching_loss
from daclip_torch.models.unet import ConditionalUNet as TorchUNet
from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig
from daclip_torch.sde import IRSDE as TorchSDE
from daclip_torch.train import restoration as trest
from daclip_torch.train import schedules as tsched
from daclip_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from daclip_torch.utils.ema import EMA
from daclip_tpu.losses.matching import matching_loss as jax_matching_loss
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
from daclip_tpu.sde import IRSDE as JaxSDE
from daclip_tpu.train import restoration as jrest
from daclip_tpu.train import schedules as jsched
from daclip_tpu.utils import ema as ema_lib
from tests.test_torch_unet import _seeded_params

torch.set_num_threads(1)
FIXTURE = pathlib.Path(__file__).parent / "parity" / "fixtures" / "e2e"

# a wrap at level 0, SpatialTransformers at level 1 and in the middle
KW = dict(nf=32, ch_mult=(1, 2), context_dim=32, use_degra_context=True,
          use_image_context=True, spatial_attn_min_level=1)
# parameters the reference never reads with a one-token image context: the
# cross-attention reduces to to_out(to_v(context)) (softmax over one key is 1)
UNUSED = ("attn2.to_q.", "attn2.to_k.", ".norm2.")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _batch(B=2, H=16, W=16, seed=1):
    rng = np.random.RandomState(seed)
    gt = rng.rand(B, H, W, 3).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.randn(B, H, W, 3), 0, 1).astype(np.float32)
    ctx = [rng.randn(B, 32).astype(np.float32) for _ in range(2)]
    t = np.asarray([17, 83, 1, 100][:B], np.int64).reshape(B, 1, 1, 1)
    noise = rng.randn(B, H, W, 3).astype(np.float32)
    return gt, lq, ctx[0], ctx[1], t, noise


# -- IR-SDE: tensor t (fault 3) and training states -----------------------------
def test_step_functions_take_a_tensor_t_like_jax():
    """Every step function with an int64 (B,1,1,1) t against JAX's jnp.take
    path; the int path stays the sampler's."""
    jsde, tsde = JaxSDE(max_sigma=50, T=100), TorchSDE(max_sigma=50, T=100)
    gt, lq, _, _, t, noise = _batch(B=4)
    x, z = noise, np.random.RandomState(5).randn(*noise.shape).astype(np.float32)
    jt, tt = jnp.asarray(t, jnp.int32), torch.from_numpy(t)
    jx, jmu, jx0, jz = map(jnp.asarray, (x, lq, gt, z))
    tx, tmu, tx0, tz = map(_nchw, (x, lq, gt, z))
    cases = {
        "mu_bar": (jsde.mu_bar(jmu, jx0, jt), tsde.mu_bar(tmu, tx0, tt)),
        "get_real_noise": (jsde.get_real_noise(jx, jx0, jmu, jt),
                           tsde.get_real_noise(tx, tx0, tmu, tt)),
        "get_score_from_noise": (jsde.get_score_from_noise(jz, jt),
                                 tsde.get_score_from_noise(tz, tt)),
        "get_init_state_from_noise": (jsde.get_init_state_from_noise(jx, jz, jmu, jt),
                                      tsde.get_init_state_from_noise(tx, tz, tmu, tt)),
        "reverse_sde_step_mean": (jsde.reverse_sde_step_mean(jx, jz, jmu, jt),
                                  tsde.reverse_sde_step_mean(tx, tz, tmu, tt)),
        "reverse_optimum_step": (jsde.reverse_optimum_step(jx, jx0, jmu, jt),
                                 tsde.reverse_optimum_step(tx, tx0, tmu, tt)),
        "reverse_optimum_std": (jsde.reverse_optimum_std(jt),
                                tsde.reverse_optimum_std(tt).expand(4, 1, 1, 1)),
        "reverse_posterior_step": (jsde.reverse_posterior_step(jx, jz, jmu, jt, jx0),
                                   tsde.reverse_posterior_step(tx, tz, tmu, tt, tx0)),
    }
    for name, (want, got) in cases.items():
        assert got.dtype == torch.float32, name
        want = np.asarray(want)
        got = got.numpy() if want.shape[-1] != 3 else got.numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6, err_msg=name)
    # one sample's tensor t gives what its int t gives
    one = tsde.reverse_sde_step_mean(tx[:1], tz[:1], tmu[:1], tt[:1])
    assert torch.allclose(one, tsde.reverse_sde_step_mean(tx[:1], tz[:1], tmu[:1], 17),
                          rtol=1e-6, atol=1e-7)
    with pytest.raises(TypeError):
        tsde.mu_bar(tmu, tx0, tt.int())


def test_generate_random_states_range_and_formula():
    tsde = TorchSDE(max_sigma=50, T=100)
    gt = torch.rand(1000, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    lq = gt + 0.1
    t, xt = tsde.generate_random_states(gt, lq, torch.Generator().manual_seed(1))
    assert t.shape == (1000, 1, 1, 1) and t.dtype == torch.int64 and xt.dtype == torch.float32
    assert int(t.min()) == 1 and int(t.max()) == 100
    t2, _ = tsde.generate_random_states(gt, lq, torch.Generator().manual_seed(1), T_start=5,
                                        T_end=9)
    assert int(t2.min()) == 5 and int(t2.max()) == 9
    # x_t = ε·σ̄_t + μ̄_t, with ε the generator's draw after t
    g = torch.Generator().manual_seed(2)
    t3, xt3 = tsde.generate_random_states(gt[:4], lq[:4], g, timesteps=t[:4])
    eps = torch.randn(gt[:4].shape, generator=torch.Generator().manual_seed(2))
    sb = torch.tensor([tsde._s["sigma_bars"][i] for i in t[:4].flatten()]).reshape(4, 1, 1, 1)
    assert torch.equal(t3, t[:4])
    torch.testing.assert_close(xt3, eps * sb + tsde.mu_bar(lq[:4], gt[:4], t[:4]),
                               rtol=0, atol=1e-7)
    # the same draws in JAX's formula
    jsde = JaxSDE(max_sigma=50, T=100)
    nhwc = lambda a: jnp.asarray(a.numpy().transpose(0, 2, 3, 1))
    want = (nhwc(eps) * jsde.sigma_bar(jnp.asarray(t[:4].numpy(), jnp.int32))
            + jsde.mu_bar(nhwc(lq[:4]), nhwc(gt[:4]), jnp.asarray(t[:4].numpy(), jnp.int32)))
    np.testing.assert_allclose(xt3.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-6)


def test_forward_simulation_matches_jax_with_the_same_draws():
    jsde, tsde = JaxSDE(max_sigma=50, T=20), TorchSDE(max_sigma=50, T=20)
    gt, lq, *_ = _batch(B=1, H=4, W=4)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsde.forward(key, jnp.asarray(gt), jnp.asarray(lq)))
    draws = iter([_nchw(jax.random.normal(jax.random.fold_in(key, t), gt.shape))
                  for t in range(1, 21)])
    tsde._randn = lambda x, generator: next(draws)
    got = tsde.forward(_nchw(gt), _nchw(lq))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


# -- loss and gradients ----------------------------------------------------------
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_matching_loss_matches_jax(loss_type):
    rng = np.random.RandomState(0)
    a, b = rng.randn(3, 4, 5, 2).astype(np.float32), rng.randn(3, 4, 5, 2).astype(np.float32)
    w = rng.rand(3).astype(np.float32)
    for weights in (None, w):
        want = jax_matching_loss(jnp.asarray(a), jnp.asarray(b), loss_type,
                                 None if weights is None else jnp.asarray(weights))
        got = matching_loss(*map(torch.from_numpy, (a, b)), loss_type,
                            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_and_every_gradient_match_jax_value_and_grad():
    """The trainer's loss formula (daclip_tpu/train/restoration.py:113-118)
    through the JAX UNet under jax.value_and_grad, and the port's loss_fn
    through the port's UNet under autograd, on the same weights, x_t, t and
    contexts in f32 (JAX at `highest` precision): the loss and every
    parameter's gradient, mapped back to reference names by the same
    converter, within 1e-4 of each gradient's max."""
    gt, lq, tctx, ictx, t, noise = _batch()
    jsde, tsde = JaxSDE(max_sigma=50, T=100), TorchSDE(max_sigma=50, T=100)
    jt = jnp.asarray(t, jnp.int32)
    xt = np.asarray(noise * jsde.sigma_bar(jt) + jsde.mu_bar(jnp.asarray(lq), jnp.asarray(gt), jt))
    jnet = JaxUNet(dtype=jnp.float32, **KW)
    t_model = t.reshape(-1).astype(np.float32)
    jparams = _seeded_params(jnet, (xt, lq, t_model, tctx, ictx))
    cfg = jrest.RestorationTrainConfig()

    def jloss(params):
        pred = jnet.apply({"params": params}, xt, lq, jnp.asarray(t_model), tctx, ictx)
        score = jsde.get_score_from_noise(pred, jt)
        a = jsde.reverse_sde_step_mean(xt, score, lq, jt)
        b = jsde.reverse_optimum_step(xt, gt, lq, jt)
        return cfg.weight * jax_matching_loss(a, b, cfg.loss_type)

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    want = unet_state_dict_from_jax(jax.tree.map(np.asarray, jgrads), depth=2)

    tnet = TorchUNet(**KW)
    tnet.load_state_dict(unet_state_dict_from_jax(jparams, depth=2), strict=True)
    loss = trest.loss_fn(tnet, tsde, trest.RestorationTrainConfig(), _nchw(xt), _nchw(lq),
                         _nchw(gt), torch.from_numpy(t), torch.from_numpy(tctx),
                         torch.from_numpy(ictx))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = dict(tnet.named_parameters())
    assert set(grads) == set(want)
    for name, p in grads.items():
        w = want[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = float(w.abs().max())
        if scale == 0:
            assert any(u in name for u in UNUSED), name
            assert float(g.abs().max()) == 0, name
            continue
        err = float((g - w).abs().max()) / scale
        assert err <= 1e-4, f"{name}: {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_parameter_gets_a_gradient_through_the_kernel_wrappers(dtype):
    """One backward through a tiny UNet gives every parameter a finite,
    non-None gradient, the five wrap parameters of each LinearAttention site
    included (their kernel-layout copies are made under autograd while
    training), in f32 and in bf16 compute; only the parameters that a
    one-token context never reads get none."""
    gt, lq, tctx, ictx, t, noise = map(torch.from_numpy, _batch())
    gt, lq, noise = (a.permute(0, 3, 1, 2).contiguous() for a in (gt, lq, noise))
    torch.manual_seed(0)
    net = TorchUNet(dtype=dtype, **KW)
    loss = trest.loss_fn(net, TorchSDE(max_sigma=50, T=100), trest.RestorationTrainConfig(),
                         noise * 0.1 + lq, lq, gt, t, tctx, ictx)
    loss.backward()
    named = dict(net.named_parameters())
    sites = [k[:-len(".fn.fn.to_qkv.weight")] for k in named
             if k.endswith(".fn.fn.to_qkv.weight")]
    assert sorted(sites) == ["downs.0.2", "ups.1.2"]
    for site in sites:
        for leaf in ("fn.norm.g", "fn.fn.to_qkv.weight", "fn.fn.to_out.0.weight",
                     "fn.fn.to_out.0.bias", "fn.fn.to_out.1.g"):
            p = named[f"{site}.{leaf}"]
            assert p.grad is not None and bool(p.grad.abs().max() > 0), f"{site}.{leaf}"
    for name, p in net.named_parameters():
        if any(u in name for u in UNUSED):
            continue
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name


def test_remat_gives_the_same_gradients():
    gt, lq, tctx, ictx, t, noise = map(torch.from_numpy, _batch())
    gt, lq, noise = (a.permute(0, 3, 1, 2).contiguous() for a in (gt, lq, noise))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = TorchUNet(remat=remat, **KW)
        trest.loss_fn(net, TorchSDE(max_sigma=50, T=100), trest.RestorationTrainConfig(),
                      noise * 0.1 + lq, lq, gt, t, tctx, ictx).backward()
        grads.append({k: p.grad for k, p in net.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5, atol=1e-7)


# -- optimizers, schedules, EMA ----------------------------------------------------
OPT_CASES = {
    "adamw-cosine-warmup": dict(optimizer="AdamW", lr_G=1e-2, lr_scheme="TrueCosineAnnealingLR",
                                niter=10, eta_min=1e-4, warmup_iter=3, weight_decay_G=0.05,
                                grad_clip=2.0),
    "adam-multistep-restarts": dict(optimizer="Adam", lr_G=1e-2, lr_scheme="MultiStepLR",
                                    lr_steps=(2, 4, 8, 10), lr_gamma=0.5, restarts=(6,),
                                    restart_weights=(0.5,), warmup_iter=2, grad_clip=2.0),
    "lion-cosine": dict(optimizer="Lion", lr_G=1e-3, lr_scheme="TrueCosineAnnealingLR",
                        niter=12, eta_min=1e-5, weight_decay_G=0.1, grad_clip=2.0),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_schedule_and_clip_match_optax(case):
    """12 updates on the same numpy params and gradients; the gradients'
    global norm crosses the clip both ways."""
    kw = OPT_CASES[case]
    rng = np.random.RandomState(7)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * (0.2 if i % 3 == 0 else 1.0)).astype(np.float32)
              for k, v in params.items()} for i in range(12)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values())) for gs in grads]
    assert min(norms) < 2.0 < max(norms)

    jcfg = jrest.RestorationTrainConfig(**kw)
    tx = jrest.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    tcfg = trest.RestorationTrainConfig(**kw)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    state = trest.init_state(module, tcfg, device="cpu")
    schedule = trest.make_schedule(tcfg)
    jschedule = jrest.make_schedule(jcfg)
    for step, g in enumerate(grads):
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        norm, lr = trest.apply_gradients(state, module, tcfg, schedule)
        np.testing.assert_allclose(float(norm), norms[step], rtol=1e-6)
        np.testing.assert_allclose(lr, float(jschedule(step)), rtol=1e-6)
    assert state.step == 12
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("make", ["cosine", "multistep", "warmup"])
def test_schedules_match_jax(make):
    if make == "cosine":
        pair = (tsched.cosine_annealing(2e-4, 50, 1e-6), jsched.cosine_annealing(2e-4, 50, 1e-6))
    elif make == "multistep":
        args = (1.0, [10, 20, 40], 0.5, [15, 30], [0.8, 0.4])
        pair = (tsched.multistep_restart(*args), jsched.multistep_restart(*args))
    else:
        base = tsched.cosine_annealing(1e-3, 60)
        pair = (tsched.warmup_override(base, 7, 1e-3),
                jsched.warmup_override(jsched.cosine_annealing(1e-3, 60), 7, 1e-3))
    for step in range(0, 70):
        np.testing.assert_allclose(pair[0](step), float(pair[1](step)), rtol=1e-6,
                                   err_msg=str(step))


def test_ema_matches_jax_over_130_updates():
    rng = np.random.RandomState(8)
    p0 = {"w": rng.randn(3, 2).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    seq = [{k: (v + 0.1 * i + rng.randn(*v.shape)).astype(np.float32) for k, v in p0.items()}
           for i in range(130)]
    jst = ema_lib.init(jax.tree.map(jnp.asarray, p0))
    ema = EMA([(k, torch.from_numpy(v)) for k, v in p0.items()], beta=0.995, update_every=10)
    for i, p in enumerate(seq):
        jst = ema_lib.update(jst, jax.tree.map(jnp.asarray, p), beta=0.995, update_every=10)
        ema.update([(k, torch.from_numpy(v)) for k, v in p.items()])
        if i % 10 == 9 or i == 129:
            for k in p0:
                np.testing.assert_allclose(ema.params[k].numpy(), np.asarray(jst.params[k]),
                                           rtol=1e-6, atol=1e-6, err_msg=f"{k} @ {i}")
    assert ema.step == int(jst.step) == 130
    assert ema.decay(130) > 0 and ema.decay(101) == 0.0


# -- the step, checkpoints, sampler ------------------------------------------------
def _tiny_train(steps=3, seed=0):
    torch.manual_seed(seed)
    net = TorchUNet(**KW)
    cfg = trest.RestorationTrainConfig(niter=20, lr_G=1e-3, warmup_iter=2)
    state = trest.init_state(net, cfg, device="cpu")
    step = trest.make_train_step(net, TorchSDE(max_sigma=50, T=100), cfg, device="cpu")
    gt, lq, tctx, ictx, *_ = map(torch.from_numpy, _batch())
    batch = dict(LQ=lq.permute(0, 3, 1, 2).contiguous(), GT=gt.permute(0, 3, 1, 2).contiguous(),
                 text_context=tctx, image_context=ictx)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, torch.Generator().manual_seed(4))
        metrics.append(m)
    return net, cfg, state, metrics


def test_train_step_metrics_and_state():
    net, cfg, state, metrics = _tiny_train()
    sched = trest.make_schedule(cfg)
    assert state.step == 3 and state.ema.step == 3
    for i, m in enumerate(metrics):
        assert m["lr"] == sched(i)
        assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
    # the parameters the optimizer moved are the UNet's own
    assert state.optimizer.param_groups[0]["params"][0] is next(net.parameters())


def test_checkpoint_round_trip_and_ema_restore(tmp_path):
    net, cfg, state, _ = _tiny_train()
    path = save_checkpoint(str(tmp_path), net, state)
    assert latest_step(str(tmp_path)) == 3 and path.endswith("3.pt")
    torch.manual_seed(9)
    net2 = TorchUNet(**KW)
    state2 = trest.init_state(net2, cfg, device="cpu")
    restore_checkpoint(str(tmp_path), net2, state2)
    assert state2.step == 3 and state2.ema.step == 3
    for (k, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        assert torch.equal(a, b), k
    for k in state.ema.params:
        assert torch.equal(state.ema.params[k], state2.ema.params[k]), k
    s1, s2 = state.optimizer.state_dict()["state"], state2.optimizer.state_dict()["state"]
    assert set(s1) == set(s2) and all(torch.equal(s1[i]["exp_avg"], s2[i]["exp_avg"]) for i in s1)
    # the file loads its EMA weights by default, strictly, into the restorer
    sd = load_torch_state_dict(path)
    assert all(torch.equal(sd[k], state.ema.params[k]) for k in sd)
    rcfg = dataclasses.replace(RestorerConfig(), model_name="daclip_test-tiny",
                               dtype="float32", sample_T=2)
    restorer = DACLIPRestorer.load(path, str(FIXTURE / "daclip.pt"), cfg=rcfg, device="cpu")
    for k, v in restorer.unet.state_dict().items():
        assert torch.equal(v, state.ema.params[k]), k
    out = restorer.restore(np.random.RandomState(0).rand(20, 24, 3).astype(np.float32),
                           return_uint8=False)
    assert out.shape == (20, 24, 3) and np.isfinite(out).all()


@pytest.mark.parametrize("mode", ["posterior", "sde", "ode"])
def test_sampler_modes(mode):
    torch.manual_seed(0)
    net = TorchUNet(**KW).eval()
    sample = trest.make_sampler(net, TorchSDE(max_sigma=50, T=3), mode, device="cpu")
    lq = torch.full((1, 3, 16, 16), 0.5)
    out = sample(lq, torch.Generator().manual_seed(0), torch.zeros(1, 32), torch.zeros(1, 32))
    assert out.shape == lq.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("entry", ["init_state", "make_train_step", "make_sampler"])
def test_trainer_entry_points_default_to_cuda_and_never_fall_back(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net, sde, cfg = TorchUNet(**KW), TorchSDE(max_sigma=50, T=3), trest.RestorationTrainConfig()
    args = {"init_state": (net, cfg), "make_train_step": (net, sde, cfg),
            "make_sampler": (net, sde)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(trest, entry)(*args)
    getattr(trest, entry)(*args, device="cpu")
    assert all(p.device.type == "cpu" for p in net.parameters())


def test_train_step_and_sampler_refuse_tensors_on_another_device():
    torch.manual_seed(0)
    net = TorchUNet(**KW)
    sde, cfg = TorchSDE(max_sigma=50, T=3), trest.RestorationTrainConfig()
    state = trest.init_state(net, cfg, device="cpu")
    step = trest.make_train_step(net, sde, cfg, device="cpu")
    x = torch.rand(1, 3, 16, 16)
    with pytest.raises(ValueError, match="batch\\['GT'\\] is on meta"):
        step(state, dict(LQ=x, GT=x.to("meta")))
    sample = trest.make_sampler(net, sde, device="cpu")
    with pytest.raises(ValueError, match="text_context is on meta"):
        sample(x, None, torch.zeros(1, 32, device="meta"))
    assert state.step == 0
