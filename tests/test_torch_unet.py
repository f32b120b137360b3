"""daclip_torch ConditionalUNet against daclip_tpu's, on the CPU.

The same seeded weights go through both packages (the JAX UNet's parameter
tree filled from a numpy seed → `unet_state_dict_from_jax`, or the committed
reference checkpoint → `convert_unet`), the same numpy inputs through both
forwards, in float32.
On the CPU the JAX UNet takes its plain paths and the port's kernel wrappers
take their plain versions."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.convert import (infer_unet_arch, load_torch_state_dict,
                                  unet_state_dict_from_jax)
from daclip_torch.models.unet import ConditionalUNet as TorchUNet
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
from daclip_tpu.utils.torch_convert import convert_unet

torch.set_num_threads(1)
FIXTURE = pathlib.Path(__file__).parent / "parity" / "fixtures" / "e2e"


def _seeded_params(jnet, args, seed=0):
    """The JAX UNet's own parameter tree (its structure from `init`, traced
    only), filled from a numpy seed: fan-in scaled weights, gains near 1 and
    no zero tensor, so every branch reaches the output (JAX's init zero-fills
    SpatialTransformer.proj_out)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)["params"]

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name or "'g'" in name:
            a = 1.0 + 0.1 * rng.randn(*s.shape)
        else:
            a = 0.05 * rng.randn(*s.shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(B, H, W, cdim, seed=1):
    rng = np.random.RandomState(seed)
    xt = rng.randn(B, H, W, 3).astype(np.float32)
    cond = rng.rand(B, H, W, 3).astype(np.float32)
    t = np.asarray([37.0, 81.0][:B], np.float32)
    tctx = rng.randn(B, cdim).astype(np.float32)
    ictx = rng.randn(B, cdim).astype(np.float32)
    return xt, cond, t, tctx, ictx


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _run_both(jnet, jparams, tnet, xt, cond, t, tctx, ictx):
    want = np.asarray(jax.jit(jnet.apply)({"params": jparams}, xt, cond, t, tctx, ictx))
    with torch.no_grad():
        got = tnet(_nchw(xt), _nchw(cond), torch.from_numpy(t),
                   torch.from_numpy(tctx), torch.from_numpy(ictx))
    assert got.dtype == torch.float32
    return got.numpy().transpose(0, 2, 3, 1), want


@pytest.mark.parametrize("case", ["daclip-sde", "wild-ir-odd"])
def test_unet_matches_jax_on_jax_param_tree(case):
    if case == "daclip-sde":
        # nf=32, 4 levels at 32×32: SpatialTransformer at level 3 and mid
        kw = dict(nf=32, ch_mult=(1, 2, 4, 8), context_dim=32,
                  use_degra_context=True, use_image_context=True)
        B, H, W = 2, 32, 32
    else:
        # wild-ir scale=0.5 at an odd size: the reflect pad to 2^depth
        kw = dict(nf=32, ch_mult=(1, 2, 4), context_dim=32, use_degra_context=True,
                  use_image_context=True, scale=0.5, spatial_attn_min_level=2)
        B, H, W = 1, 60, 52
    xt, cond, t, tctx, ictx = _inputs(B, H, W, 32)
    jnet = JaxUNet(dtype=jnp.float32, **kw)
    jparams = _seeded_params(jnet, (xt, cond, t, tctx, ictx))
    tnet = TorchUNet(**kw).eval()
    tnet.load_state_dict(unet_state_dict_from_jax(jparams, depth=len(kw["ch_mult"])),
                         strict=True)
    got, want = _run_both(jnet, jparams, tnet, xt, cond, t, tctx, ictx)
    assert got.shape == want.shape == (B, H, W, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fixture_checkpoint_loads_strict_and_matches_jax():
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    arch = infer_unet_arch(sd)
    kw = dict(nf=arch["nf"], ch_mult=arch["ch_mult"], context_dim=arch["context_dim"],
              use_degra_context=arch["use_degra_context"],
              use_image_context=arch["use_image_context"], scale=arch["scale"],
              spatial_attn_min_level=arch["spatial_attn_min_level"])
    tnet = TorchUNet(**kw).eval()
    tnet.load_state_dict(sd, strict=True)
    jnet = JaxUNet(dtype=jnp.float32, **kw)
    jparams = convert_unet({k: v.numpy() for k, v in sd.items()},
                           depth=len(arch["ch_mult"]))
    xt, cond, t, tctx, ictx = _inputs(1, 32, 32, arch["context_dim"], seed=2)
    got, want = _run_both(jnet, jparams, tnet, xt, cond, t, tctx, ictx)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_wrap_weights_made_once_follow_a_new_load():
    """AttnWrap keeps its kernel-layout weights between forwards; a load of
    new values must reach the next forward."""
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    arch = infer_unet_arch(sd)
    kw = {k: v for k, v in arch.items() if k not in ("in_nc", "out_nc")}
    xt, cond, t, tctx, ictx = _inputs(1, 32, 32, arch["context_dim"], seed=3)
    args = (_nchw(xt), _nchw(cond), torch.from_numpy(t), torch.from_numpy(tctx),
            torch.from_numpy(ictx))
    torch.manual_seed(0)
    used, fresh = TorchUNet(**kw).eval(), TorchUNet(**kw).eval()
    with torch.no_grad():
        before = used(*args)
        used.load_state_dict(sd, strict=True)
        fresh.load_state_dict(sd, strict=True)
        after, want = used(*args), fresh(*args)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


def test_state_dict_round_trip_through_convert_unet_is_exact():
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    depth = len(infer_unet_arch(sd)["ch_mult"])
    back = unet_state_dict_from_jax(convert_unet({k: v.numpy() for k, v in sd.items()},
                                                 depth=depth), depth=depth)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].shape == sd[k].shape, k
        assert torch.equal(back[k], sd[k]), k
