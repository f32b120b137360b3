"""The ConditionalUNet's other kernel wirings in daclip_torch against
daclip_tpu, on the CPU: the v4 and v3 linear attention, the attention core
and the dual 1×1 res_conv.

The same seeded numpy inputs go through both packages. The port's entry
points take their plain versions on CPU tensors; the JAX side runs its Pallas
kernels in interpret mode (`dual_conv1x1` has no `interpret` argument, so the
test hands its module a `pallas_call` with interpret on and traces afresh) or
its compositions. Every linear-attention check also runs on balanced inputs,
where the attention is as large as the out-projection bias (see
tests/test_torch_ops.py:_balanced). Tolerances:
- against the compositions in f32: 1e-5 (the same math in another order);
- against the TPU kernels: bf16's, in f32 as well, because those kernels
  round p, v, q_soft and W (and the v3 kernel xn) to bf16 whatever the
  input type;
- gradients and the small UNet: 1e-4 of each tensor's max.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from daclip_torch.convert import unet_state_dict_from_jax
from daclip_torch.models import unet as unet_mod
from daclip_torch.models.unet import ConditionalUNet as TorchUNet
from daclip_torch.ops import linear_attention as tla
from daclip_torch.ops import pointwise as tpw
from daclip_torch.sde import IRSDE as TorchSDE
from daclip_torch.train import restoration as trest
from daclip_tpu.losses.matching import matching_loss as jax_matching_loss
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
from daclip_tpu.ops import pointwise as jpw
from daclip_tpu.ops.linear_attention import (_attn_wrap_composition_reference,
                                             _fused_composition_reference,
                                             linear_attention_fused_pallas,
                                             linear_attention_fused_v4, linear_attention_pallas)
from daclip_tpu.ops.linear_attention import \
    linear_attention_reference as jax_linear_attention_reference
from daclip_tpu.sde import IRSDE as JaxSDE
from daclip_tpu.train import restoration as jrest
from tests.test_torch_ops import (_assert_attention_shows, _assert_rel, _balanced, _channel_ln,
                                  _dout, _wrap_inputs)
from tests.test_torch_train import UNUSED, _batch, _nchw
from tests.test_torch_unet import _seeded_params

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]

FUSED_GRADS = ("dxn", "dw_qkv", "dw_out", "db_out", "dg_out")
WRAP_GRADS = ("dx", "dg_pre", "dw_qkv", "dw_out", "db_out", "dg_out")


def _fused_inputs(B, n, C, seed, balanced):
    """(xn, w_qkv, w_out, b_out, g_out): the wrap inputs with x prenormalised."""
    args = _wrap_inputs(B, n, C, seed)
    if balanced:
        args = _balanced(args)
    x, g_pre, *rest = args
    return [_channel_ln(x.astype(np.float64), g_pre).astype(np.float32), *rest]


def _assert_fused_attention_shows(args, out):
    """Without the residual: out minus the output with the attention left out
    is of order 1 on balanced inputs."""
    _, _, _, b_out, g_out = (np.asarray(a, np.float64) for a in args)
    assert np.abs(np.asarray(out, np.float64) - _channel_ln(b_out, g_out)).mean() > 0.3


def _both(args, dtype):
    """The numpy args as JAX arrays and torch tensors of `dtype`, equal values."""
    jargs = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in args]
    targs = [torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
             for a in jargs]
    return jargs, targs


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else t, np.float32)


def _assert_close_to_kernel(got, want, balanced):
    """Within the JAX suite's bound for these kernels (tests/test_ops.py, atol
    0.1), plus two bf16 steps of the value (rtol 2^-6), and 1e-2 on the mean,
    which a wrong attention (errors of order 1 on balanced inputs) cannot
    meet."""
    np.testing.assert_allclose(got, want, atol=0.1, rtol=2 ** -6 if balanced else 0)
    assert np.abs(got - want).mean() < 1e-2


# -- #5: linear_attention_fused (v4) ---------------------------------------------
@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_linear_attention_fused_matches_pallas_v4(C, dtype, balanced):
    args = _fused_inputs(2, 2048, C, 1, balanced)
    jargs, targs = _both(args, dtype)
    want = _np(linear_attention_fused_v4(*jargs, interpret=True))
    got = tla.linear_attention_fused(*targs)
    assert got.dtype == targs[0].dtype
    got = _np(got)
    if balanced:
        _assert_fused_attention_shows(args, want)
    _assert_close_to_kernel(got, want, balanced)
    if dtype == "float32":
        comp = np.asarray(_fused_composition_reference(*jargs))
        np.testing.assert_allclose(got, comp, atol=1e-5)


# -- #6: attn_wrap_fused (v3), both modes ----------------------------------------
@pytest.mark.parametrize("prenorm_residual", [True, False])
@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_attn_wrap_fused_matches_pallas_v3(C, dtype, balanced, prenorm_residual):
    if prenorm_residual:
        args = _wrap_inputs(2, 2048, C, 2)
        args = _balanced(args) if balanced else args
        jargs, targs = _both(args, dtype)
        x, g_pre, *w = jargs
        want = linear_attention_fused_pallas(x, *w, g_pre=g_pre, prenorm_residual=True,
                                             interpret=True)
        got = tla.attn_wrap_fused(*targs, prenorm_residual=True)
        comp = _attn_wrap_composition_reference
    else:
        args = _fused_inputs(2, 2048, C, 2, balanced)
        jargs, targs = _both(args, dtype)
        want = linear_attention_fused_pallas(*jargs, interpret=True)
        got = tla.attn_wrap_fused(targs[0], None, *targs[1:], prenorm_residual=False)
        comp = _fused_composition_reference
    assert got.dtype == targs[0].dtype
    got, want = _np(got), _np(want)
    if balanced:
        (_assert_attention_shows if prenorm_residual else _assert_fused_attention_shows)(
            args, want)
    _assert_close_to_kernel(got, want, balanced)
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(comp(*jargs)), atol=1e-5)


# -- #7: linear_attention (the core) ---------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,n", [(2, 2048), (1, 3072)])
def test_linear_attention_core_matches_pallas(B, n, dtype):
    """Against the v1 kernel (n = 2048 takes its 2048-row chunks, 3072 its
    1024-row ones), relative to the output's own size: the output is the
    attention alone, so production-like inputs show it. In f32 also against
    daclip_tpu's composition at 1e-5."""
    rng = np.random.RandomState(4)
    qkv = (rng.randn(B, n, 384) * np.repeat([2.0, 2.0, 1.0], 128)).astype(np.float32)
    (jq,), (tq,) = _both([qkv], dtype)
    want = _np(linear_attention_pallas(jq, interpret=True))
    got = tla.linear_attention(tq)
    assert got.dtype == tq.dtype and got.shape == (B, n, 128)
    got = _np(got)
    scale = np.abs(want).max()
    # the kernel rounds q_soft, p and W to bf16: two roundings of a product
    np.testing.assert_allclose(got, want, atol=2e-2 * scale)
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(jax_linear_attention_reference(jq)),
                                   atol=1e-5 * scale)


# -- #8: dual_conv1x1 ----------------------------------------------------------------
@pytest.fixture
def jax_pointwise_interpret(monkeypatch):
    """daclip_tpu.ops.pointwise with its pallas_call in interpret mode, traced
    afresh (and its trace dropped again afterwards)."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jpw, "pl", ns)
    jpw._dual_conv1x1_fwd_impl.clear_cache()
    yield jpw
    jpw._dual_conv1x1_fwd_impl.clear_cache()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["dual", "single"])
def test_dual_conv1x1_forward_and_backward_match_jax(form, dtype, jax_pointwise_interpret):
    """The forward against the Pallas kernel (interpret mode), on (B, H, W, C)
    activations seen as (B·H·W, C) rows; the gradients of the port's autograd
    Function against jax.vjp (JAX's `_dc_bwd`). f32 at 1e-5 of each output's
    max; bf16 at 1e-2 (one rounding of the output, products in bf16 in the
    backward)."""
    rng = np.random.RandomState(5)
    B, H, W, Cx, Cs, O = 2, 8, 16, 48, 80, 40
    x = rng.randn(B, H, W, Cx).astype(np.float32)
    skip = rng.randn(B, H, W, Cs).astype(np.float32) if form == "dual" else None
    w = (rng.randn(Cx + (Cs if skip is not None else 0), O) / 8).astype(np.float32)
    g = rng.randn(B, H, W, O).astype(np.float32)
    arrays = [a for a in (x, skip, w, g) if a is not None]
    jarrs, tarrs = _both(arrays, dtype)
    if skip is None:
        (jx, jw, jg), (tx, tw, tg) = jarrs, tarrs
        js = ts = None
    else:
        (jx, js, jw, jg), (tx, ts, tw, tg) = jarrs, tarrs
    want, vjp = jax.vjp(lambda a, s, b: jax_pointwise_interpret.dual_conv1x1(a, s, b), jx, js, jw)
    jgrads = [gr for gr in vjp(jg) if gr is not None]

    rows = lambda t: t.reshape(B * H * W, t.shape[-1])
    leaves = [t.requires_grad_() for t in (rows(tx), None if ts is None else rows(ts), tw)
              if t is not None]
    got = tpw.dual_conv1x1(leaves[0], leaves[1] if ts is not None else None, leaves[-1])
    assert type(got.grad_fn).__name__ == "_DualConv1x1FnBackward"
    assert got.dtype == tx.dtype
    tgrads = torch.autograd.grad(got, leaves, rows(tg))
    tol = 1e-5 if dtype == "float32" else 1e-2
    want = _np(want).reshape(B * H * W, O)
    np.testing.assert_allclose(_np(got.detach()), want, atol=tol * np.abs(want).max())
    for name, a, b in zip(("dx", "dskip", "dw") if ts is not None else ("dx", "dw"),
                          tgrads, jgrads):
        b = _np(b).reshape(a.shape)
        np.testing.assert_allclose(_np(a), b, atol=tol * np.abs(b).max(), err_msg=name)


def test_dual_conv1x1_plain_version_is_the_single_rounding_composition():
    """The plain version accumulates both products in f32 and rounds once,
    as the TPU kernel does (the jnp path of Conv1x1Pair rounds each): in bf16
    within half a bf16 step of the exact sum (plus the f32 sum's error)."""
    rng = np.random.RandomState(6)
    x, s = (torch.from_numpy(rng.randn(300, c).astype(np.float32)) for c in (64, 32))
    w = torch.from_numpy(rng.randn(96, 24).astype(np.float32))
    want = x.double() @ w[:64].double() + s.double() @ w[64:].double()
    torch.testing.assert_close(tpw.dual_conv1x1(x, s, w).double(), want, rtol=1e-5, atol=1e-5)
    xb, sb, wb = x.bfloat16(), s.bfloat16(), w.bfloat16()
    got = tpw.dual_conv1x1(xb, sb, wb)
    assert got.dtype == torch.bfloat16
    exact = xb.double() @ wb[:64].double() + sb.double() @ wb[64:].double()
    torch.testing.assert_close(got.double(), exact, rtol=2 ** -8 + 1e-6, atol=1e-5)


# -- gradients of v4 and v3 ----------------------------------------------------------
@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("C,n", [(64, 512), (96, 301)])
@pytest.mark.parametrize("route", ["v4", "v3", "v3_no_prenorm"])
def test_recompute_backward_matches_jax_vjp_of_the_composition(route, C, n, balanced):
    """The autograd Function of each entry point (plain forward on the CPU,
    backward by recomputing the plain composition) against jax.vjp of the
    composition its JAX custom_vjp differentiates, at 1e-4 of each
    gradient's max (dW_qkv per q, k, v block)."""
    if route == "v3":
        args = _wrap_inputs(2, n, C, 7)
        args = _balanced(args) if balanced else args
        comp, names = _attn_wrap_composition_reference, WRAP_GRADS
        fn = lambda *a: tla.attn_wrap_fused(*a)
    else:
        args = _fused_inputs(2, n, C, 7, balanced)
        comp, names = _fused_composition_reference, FUSED_GRADS
        fn = (tla.linear_attention_fused if route == "v4" else
              lambda xn, *w: tla.attn_wrap_fused(xn, None, *w, prenorm_residual=False))
    g = _dout((2, n, C))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*leaves)
    assert type(out.grad_fn).__name__ == "_RecomputeFnBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(comp, *map(jnp.asarray, args))
    _assert_rel([t.numpy() for t in got], vjp(jnp.asarray(g)), 1e-4, names)


# -- the small UNet in each wiring ---------------------------------------------------
UNET_KW = dict(nf=32, ch_mult=(1, 2), context_dim=32, use_degra_context=True,
               use_image_context=True, spatial_attn_min_level=2)
CONFIGS = {"v4+pointwise": dict(linear_attention="v4", pointwise=True),
           "v3+pointwise": dict(linear_attention="v3", pointwise=True),
           "v5+pointwise64": dict(linear_attention="v5", pointwise=True, pointwise_max_out=64)}


@pytest.fixture(scope="module")
def jax_unet_reference():
    """Forward, loss and every gradient of the JAX UNet (f32, `highest`) on
    one 2 × 64² batch: on the CPU it takes its jnp compositions whatever its
    kernel flags, so one reference serves every wiring."""
    gt, lq, tctx, ictx, t, noise = _batch(B=2, H=64, W=64)
    jsde = JaxSDE(max_sigma=50, T=100)
    jt = jnp.asarray(t, jnp.int32)
    xt = np.asarray(noise * jsde.sigma_bar(jt) + jsde.mu_bar(jnp.asarray(lq), jnp.asarray(gt),
                                                             jt))
    jnet = JaxUNet(dtype=jnp.float32, **UNET_KW)
    t_model = t.reshape(-1).astype(np.float32)
    jparams = _seeded_params(jnet, (xt, lq, t_model, tctx, ictx))
    cfg = jrest.RestorationTrainConfig()

    def jloss(params):
        pred = jnet.apply({"params": params}, xt, lq, jnp.asarray(t_model), tctx, ictx)
        score = jsde.get_score_from_noise(pred, jt)
        a = jsde.reverse_sde_step_mean(xt, score, lq, jt)
        b = jsde.reverse_optimum_step(xt, gt, lq, jt)
        return cfg.weight * jax_matching_loss(a, b, cfg.loss_type), pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    return dict(sd=unet_state_dict_from_jax(jparams, depth=2), loss=float(loss),
                pred=np.asarray(pred), grads=unet_state_dict_from_jax(
                    jax.tree.map(np.asarray, grads), depth=2),
                batch=(xt, lq, gt, t, tctx, ictx))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_small_unet_forward_loss_and_every_gradient_match_jax(config, jax_unet_reference):
    """nf 32, ch_mult (1, 2), 64², f32: LinearAttention at levels 0 and 1
    (four sites), a SpatialTransformer in the middle, five res_convs. The
    JAX state dict loads strictly; the forward, the trainer's loss and every
    parameter's gradient match at 1e-4 of each tensor's max; every parameter
    a one-token context reads gets a gradient."""
    ref = jax_unet_reference
    xt, lq, gt, t, tctx, ictx = ref["batch"]
    tnet = TorchUNet(**UNET_KW, **CONFIGS[config])
    tnet.load_state_dict(ref["sd"], strict=True)
    with torch.no_grad():
        pred = tnet(_nchw(xt), _nchw(lq), torch.from_numpy(t.reshape(-1).astype(np.float32)),
                    torch.from_numpy(tctx), torch.from_numpy(ictx))
    want = ref["pred"]
    np.testing.assert_allclose(pred.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-4 * np.abs(want).max())
    loss = trest.loss_fn(tnet, TorchSDE(max_sigma=50, T=100), trest.RestorationTrainConfig(),
                         _nchw(xt), _nchw(lq), _nchw(gt), torch.from_numpy(t),
                         torch.from_numpy(tctx), torch.from_numpy(ictx))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-4)
    grads = dict(tnet.named_parameters())
    assert set(grads) == set(ref["grads"])
    for name, p in grads.items():
        w = ref["grads"][name]
        if any(u in name for u in UNUSED):
            assert p.grad is None or float(p.grad.abs().max()) == 0, name
            continue
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        scale = float(w.abs().max())
        assert scale > 0, name
        err = float((p.grad - w).abs().max()) / scale
        assert err <= 1e-4, f"{name}: {err:.3g}"


@pytest.mark.parametrize("config,max_out,want", [
    ("v4", None, dict(linear_attention_fused=4, attn_wrap_fused=0, attn_wrap=0, dual=5)),
    ("v3", None, dict(linear_attention_fused=0, attn_wrap_fused=4, attn_wrap=0, dual=5)),
    ("v5", 64, dict(linear_attention_fused=0, attn_wrap_fused=0, attn_wrap=4, dual=5)),
    ("v5", 32, dict(linear_attention_fused=0, attn_wrap_fused=0, attn_wrap=4, dual=3))])
def test_unet_routes_each_site_through_its_entry_point(config, max_out, want, monkeypatch):
    """One forward calls each wiring's entry point once per LinearAttention
    site and the dual 1×1 once per res_conv with at most `max_out` out
    channels (the up-level-1 res_convs have 64, the others 32)."""
    calls = dict.fromkeys(want, 0)

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    for key, name in (("linear_attention_fused", "linear_attention_fused"),
                      ("attn_wrap_fused", "attn_wrap_fused"), ("attn_wrap", "attn_wrap"),
                      ("dual", "dual_conv1x1")):
        monkeypatch.setattr(unet_mod, name, counting(key, getattr(unet_mod, name)))
    torch.manual_seed(0)
    net = TorchUNet(**UNET_KW, linear_attention=config, pointwise=True,
                    pointwise_max_out=max_out).eval()
    x = torch.rand(1, 3, 16, 16)
    with torch.no_grad():
        out = net(x, x, torch.tensor([5.0]), torch.zeros(1, 32), torch.zeros(1, 32))
    assert out.shape == x.shape
    assert calls == want


def test_unet_refuses_an_unknown_linear_attention_route():
    with pytest.raises(ValueError, match="linear_attention"):
        TorchUNet(**UNET_KW, linear_attention="v2")


# -- the environment sets RestorerConfig's defaults ----------------------------------
@pytest.mark.parametrize("env,want", [
    ({}, ["v5", False, None]),
    ({"DACLIP_TPU_V5_WRAP": "0"}, ["v4", False, None]),
    ({"DACLIP_TPU_V5_WRAP": "0", "DACLIP_TPU_V3_WRAP": "1"}, ["v3", False, None]),
    ({"DACLIP_TPU_V3_WRAP": "1"}, ["v5", False, None]),
    ({"DACLIP_TPU_POINTWISE": "1", "DACLIP_TPU_POINTWISE_MAXO": "64"}, ["v5", True, 64])])
def test_environment_sets_restorer_config_defaults(env, want):
    """As in the JAX package, the variables are read once at import; the
    restorer hands the fields to its UNet (here on the CPU)."""
    code = (
        "import json, torch\n"
        "from daclip_torch.models.unet import ConditionalUNet, ResBlock\n"
        "from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig\n"
        "cfg = RestorerConfig(nf=32, ch_mult=(1, 2), context_dim=32, dtype='float32')\n"
        "sd = ConditionalUNet(nf=32, ch_mult=(1, 2), context_dim=32,\n"
        "                     use_image_context=True).state_dict()\n"
        "unet = DACLIPRestorer(cfg, sd, None, device='cpu').unet\n"
        "print(json.dumps([cfg.linear_attention, cfg.pointwise, cfg.pointwise_max_out,\n"
        "                  unet.ups[0][2].linear_attention,\n"
        "                  [m.pointwise for m in unet.modules() if isinstance(m, ResBlock)]]))\n")
    base = {k: v for k, v in os.environ.items() if not k.startswith("DACLIP_TPU_")}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**base, **env})
    assert res.returncode == 0, res.stderr
    la, pw, max_out, route, sites = json.loads(res.stdout.strip().splitlines()[-1])
    assert [la, pw, max_out] == want
    assert route == la
    # res_convs: up level 1 (96 → 64, twice), up level 0 (64 → 32, twice), final (64 → 32)
    outs = [64, 64, 32, 32, 32]
    assert sum(sites) == (sum(max_out is None or o <= max_out for o in outs) if pw else 0)


# -- dispatch and guards -------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    counters = (tla.linear_attention_fused, tla.attn_wrap_fused, tla.linear_attention,
                tpw.dual_conv1x1)
    for c in counters:
        c.launches = 0
    args = list(map(torch.from_numpy, _wrap_inputs(1, 100, 64)))
    x, g_pre, *w = args
    assert torch.equal(tla.linear_attention_fused(x, *w), tla.fused_composition_reference(x, *w))
    assert torch.equal(tla.attn_wrap_fused(*args), tla.attn_wrap_reference(*args))
    assert torch.equal(tla.attn_wrap_fused(x, None, *w, prenorm_residual=False),
                       tla.fused_composition_reference(x, *w))
    qkv = torch.randn(1, 100, 384)
    assert torch.equal(tla.linear_attention(qkv), tla.linear_attention_reference(qkv))
    s = torch.randn(100, 32)
    wd = torch.randn(96, 16)
    assert torch.equal(tpw.dual_conv1x1(x[0], s, wd), tpw.dual_conv1x1_reference(x[0], s, wd))
    assert all(c.launches == 0 for c in counters)


def test_new_entry_points_guard_the_card():
    meta = lambda *s: torch.empty(*s, device="meta")
    w = [meta(64, 384), meta(128, 64), meta(64), meta(64)]
    with pytest.raises(ValueError):
        tla.linear_attention_fused(meta(1, 64, 64), *w)
    with pytest.raises(ValueError):
        tla.attn_wrap_fused(meta(1, 64, 64), meta(64), *w)
    with pytest.raises(ValueError):
        tla.linear_attention(meta(1, 64, 384))
    with pytest.raises(ValueError):
        tpw.dual_conv1x1(meta(64, 32), None, meta(32, 16))
    # the kernels' own checks, on CPU tensors
    fused = [torch.zeros(1, 64, 64), None, torch.zeros(64, 384), torch.zeros(128, 64),
             torch.zeros(64), torch.zeros(64)]
    tla._check(*fused, name="linear_attention_fused")  # g_pre unread: None passes
    bad = list(fused)
    bad[3] = torch.zeros(128, 32)
    with pytest.raises(ValueError, match="linear_attention_fused: w_out"):
        tla._check(*bad, name="linear_attention_fused")
    x = torch.zeros(64, 32)
    tpw._check(x, torch.zeros(64, 16), torch.zeros(48, 8))
    for args in ((x, torch.zeros(63, 16), torch.zeros(48, 8)),  # rows differ
                 (x, None, torch.zeros(48, 8)),                  # w too deep
                 (x, None, torch.zeros(32, 8, dtype=torch.bfloat16)),  # dtype
                 (torch.zeros(64, 64)[:, ::2], None, torch.zeros(32, 8)),  # strided
                 (torch.zeros(2, 64, 32), None, torch.zeros(32, 8))):  # not rows
        with pytest.raises(ValueError):
            tpw._check(*args)
    with pytest.raises(TypeError):
        tpw._check(x.half(), None, torch.zeros(32, 8).half())
