"""daclip_torch's CLIP / DA-CLIP losses against daclip_tpu's on the CPU:
each loss's value and its gradient with respect to every input (torch
autograd against `jax.value_and_grad`) on the same seeded numpy inputs, in
float32. A value is held within rel 1e-5 and abs 1e-6; each gradient
within 1e-6 plus 1e-5 of its array's max magnitude."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.data import csv_dataset as tdata

# each package's losses/__init__ re-exports the clip_loss function under the
# module's name
tl = importlib.import_module("daclip_torch.losses.clip_loss")
jl = importlib.import_module("daclip_tpu.losses.clip_loss")

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
B, D = 6, 16


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _check(torch_fn, jax_fn, inputs):
    """Value and gradients of a scalar loss of `inputs` (a dict of float32
    arrays) through both packages."""
    names = list(inputs)
    want, jgrads = jax.value_and_grad(
        lambda args: jax_fn(**args), argnums=0)({k: jnp.asarray(v) for k, v in inputs.items()})
    targs = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    got = torch_fn(**targs)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    for k in names:
        g = targs[k].grad
        g = np.zeros_like(inputs[k]) if g is None else g.numpy()
        w = np.asarray(jgrads[k])
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL + RTOL * np.abs(w).max(), err_msg=k)
    return got.item()


def _features(seed, n=B):
    rng = np.random.RandomState(seed)
    return _unit(rng.randn(n, D)), _unit(rng.randn(n, D))


def test_constants_equal_jax():
    assert tl.TYPE_RANGES == jl.TYPE_RANGES
    assert (tl.NUM_TYPES, tl.NUM_BINS) == (jl.NUM_TYPES, jl.NUM_BINS)


def test_clip_loss_equals_jax():
    img, txt = _features(0)
    _check(lambda i, t, s: tl.clip_loss(i, t, s), lambda i, t, s: jl.clip_loss(i, t, s),
           dict(i=img, t=txt, s=np.float32(14.3)))


def test_clip_loss_takes_bf16_features_with_f32_logits():
    img, txt = _features(1)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    got = tl.clip_loss(bf(img), bf(txt), torch.tensor(20.0))
    want = jl.clip_loss(jnp.asarray(img, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16), 20.0)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)


def test_daclip_loss_uir_equals_jax():
    img, txt = _features(2)
    deg_i, deg_t = _features(3)
    keys = ("image_features", "text_features", "image_degra_features",
            "text_degra_features", "logit_scale")
    inputs = dict(zip(keys, (img, txt, deg_i, deg_t, np.float32(10.0))))
    for part in (0, 1):
        _check(lambda **a: tl.daclip_loss_uir(a, output_dict=False)[part],
               lambda **a: jl.daclip_loss_uir(a, output_dict=False)[part], inputs)


def test_distill_clip_loss_equals_jax():
    img, txt = _features(4)
    dimg, dtxt = _features(5)
    inputs = dict(a=img, b=txt, s=np.float32(12.0), c=dimg, d=dtxt, t=np.float32(30.0))
    for part in (0, 1):
        _check(lambda a, b, s, c, d, t: tl.distill_clip_loss(a, b, s, c, d, t, False)[part],
               lambda a, b, s, c, d, t: jl.distill_clip_loss(a, b, s, c, d, t, False)[part],
               inputs)


def _fcrc_inputs(seed, presence, bank_rank=2, exact_bins=False):
    rng = np.random.RandomState(seed)
    deg_type = {"all": np.ones((B, 4)), "some": (rng.rand(B, 4) > 0.5),
                "none": np.zeros((B, 4))}[presence].astype(np.float32)
    if presence == "some":
        deg_type[0] = [1, 0, 1, 0]                      # at least one present
    lows = np.array([r[0] for r in jl.TYPE_RANGES])
    highs = np.array([r[1] for r in jl.TYPE_RANGES])
    gt_val = (deg_type * (lows + rng.rand(B, 4) * (highs - lows))).astype(np.float32)
    gt_val[1, 1] = 15.0  # a value between two integer bins' centers
    tok_shape = (28, D) if bank_rank == 2 else (B, 28, D)
    centers = tdata.build_banks(exact_bins=exact_bins)[0]
    return dict(f=rng.randn(B, D).astype(np.float32),
                tok=rng.randn(*tok_shape).astype(np.float32),
                gt_val=gt_val, centers=centers, deg_type=deg_type)


@pytest.mark.parametrize("presence,bank_rank,exact_bins", [
    ("all", 2, False), ("some", 2, False), ("none", 2, False), ("some", 3, False),
    ("all", 2, True), ("some", 3, True)])
def test_fcrc_loss_equals_jax(presence, bank_rank, exact_bins):
    inputs = _fcrc_inputs(7, presence, bank_rank, exact_bins)
    consts = {k: inputs.pop(k) for k in ("gt_val", "centers", "deg_type")}
    value = _check(lambda f, tok: tl.fcrc_loss(f, tok, consts["gt_val"],
                                               torch.from_numpy(consts["centers"]),
                                               torch.from_numpy(consts["deg_type"])),
                   lambda f, tok: jl.fcrc_loss(f, tok, consts["gt_val"], consts["centers"],
                                               consts["deg_type"]), inputs)
    if presence == "none":
        assert value == 0.0
    else:
        assert value > 0.0


def _fork_out(seed, with_gt=True, with_pred=True):
    rng = np.random.RandomState(seed + 100)
    img, txt = _features(seed)
    f = _fcrc_inputs(seed + 1, "some")
    out = dict(image_features=img, text_features=txt, logit_scale=np.float32(14.0))
    if with_gt:
        out["gt_image_features"] = _unit(img + 0.3 * rng.randn(B, D))
    if with_pred:
        out.update(image_degra_features=f["f"], all_d_type_tokens_features=f["tok"],
                   pred=(rng.rand(B, 4) * 30).astype(np.float32), gt_val=f["gt_val"],
                   bin_center_features=f["centers"], deg_type=f["deg_type"])
    return out


@pytest.mark.parametrize("with_gt,with_pred", [(True, True), (False, True), (True, False)])
def test_daclip_loss_fork_equals_jax(with_gt, with_pred):
    out = _fork_out(11, with_gt, with_pred)
    consts = {k: out.pop(k) for k in ("gt_val", "bin_center_features", "deg_type")
              if k in out}
    for part in range(4):
        def torch_fn(**a):
            t = dict(a, **{k: torch.from_numpy(v) for k, v in consts.items()})
            v = tl.daclip_loss_fork(t, output_dict=False)[part]
            return v + 0.0 * a["image_features"].sum()

        def jax_fn(**a):
            return jnp.asarray(jl.daclip_loss_fork(dict(a, **consts), output_dict=False)[part])

        value = _check(torch_fn, jax_fn, out)
        if (part == 1 and not with_gt) or (part >= 2 and not with_pred):
            assert value == 0.0
    names = tl.daclip_loss_fork(
        {k: torch.from_numpy(np.asarray(v)) for k, v in dict(out, **consts).items()})
    assert list(names) == ["contrastive_loss", "gt_l1_loss", "reg_ls_loss", "fcrc_loss"]
