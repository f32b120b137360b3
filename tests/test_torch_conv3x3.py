"""The port's 3×3 convolution (daclip_torch.ops.conv3x3) against daclip_tpu,
on the CPU.

The same seeded numpy inputs go to both packages. On CPU tensors `conv3x3`
takes its plain version, which is held against:
- the JAX kernel body `conv3x3._kernel` run through `pl.pallas_call(...,
  interpret=True)` with the spatial padding `conv3x3_pallas` applies (as
  tests/test_ops.py runs it), in f32 at 1e-4 and in bf16 at 1e-2 of the
  output's max (one rounding of the output; the sums run in another order);
- `lax.conv_general_dilated` at HIGHEST precision on ragged shapes the TPU
  kernel does not take (odd H and W, C of 3 or 6, O of 3), at 1e-4;
- `torch.nn.Conv2d` on NCHW through `conv3x3_weight`, at 1e-5.
The kernel itself runs only on the card (chip_smoke.py, phase kernels_conv).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from daclip_torch.ops.conv3x3 import (TILE_OUT, _check, conv3x3, conv3x3_reference,
                                      conv3x3_weight)
from daclip_tpu.ops import conv3x3 as jconv

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, H, W, C, O, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, O) / np.sqrt(9 * C)).astype(np.float32)
    return x, w


def _pallas_interpret(x, w, tile_h):
    """conv3x3_pallas's padding and grid around its kernel body, interpreted."""
    B, H, W, C = x.shape
    O = w.shape[-1]
    Wp = -(-(W + 2) // 8) * 8
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1 + Wp - (W + 2)), (0, 0)))
    return pl.pallas_call(
        functools.partial(jconv._kernel, TH=tile_h, W=W, C=C, O=O),
        grid=(B, H // tile_h),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec((3, 3, C, O), lambda b, h: (0, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, tile_h, W, O), lambda b, h: (b, h, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, H, W, O), x.dtype),
        scratch_shapes=[pltpu.VMEM((tile_h + 2, Wp, C), x.dtype),
                        pltpu.SemaphoreType.DMA((1,))],
        interpret=True,
    )(xp, w.astype(x.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 8, 16, 64, 64), (2, 16, 8, 32, 48)])
def test_plain_matches_pallas_kernel_interpret(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w = _inputs(*shape, seed=0)
    want = np.asarray(_pallas_interpret(jnp.asarray(x, jdt), jnp.asarray(w, jdt), tile_h=8),
                      np.float32)
    got = conv3x3_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# the last three at the card's bf16 tile edges: W of 33 and 65 (a 64-pixel
# tile column mostly empty, or a second one), odd H, O = 200 (a ragged last
# 64-output tile), C = 96 and 40 (a ragged last 32-channel slice)
@pytest.mark.parametrize("shape", [(2, 7, 9, 3, 3), (2, 11, 5, 6, 3), (2, 9, 13, 6, 8),
                                   (1, 7, 33, 96, 200), (1, 5, 65, 96, 200),
                                   (2, 3, 65, 40, 72)])
def test_plain_matches_lax_conv_on_ragged_shapes(shape):
    x, w = _inputs(*shape, seed=1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST)
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_the_plain_version(dtype):
    x, w = (torch.from_numpy(a).to(dtype) for a in _inputs(2, 6, 10, 16, 24, seed=2))
    got = conv3x3(x, w)
    assert got.dtype == dtype
    assert torch.equal(got, conv3x3_reference(x, w))


@pytest.mark.parametrize("shape", [(2, 10, 12, 8, 16), (1, 5, 7, 3, 3)])
def test_weight_layout_matches_torch_conv2d(shape):
    B, H, W, C, O = shape
    gen = torch.Generator().manual_seed(3)
    conv = torch.nn.Conv2d(C, O, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        x = torch.randn(B, C, H, W, generator=gen)
        want = conv(x)
        got = conv3x3(x.permute(0, 2, 3, 1).contiguous(), conv3x3_weight(conv.weight))
    assert conv3x3_weight(conv.weight).shape == (3, 3, C, O)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, atol=1e-5, rtol=1e-5)


def _refused(kind):
    x, w = (torch.from_numpy(a) for a in _inputs(1, 4, 5, 6, 7, seed=4))
    return {"dtype": lambda: (x.half(), w.half()),
            "rank": lambda: (x[0], w),
            "channels": lambda: (x, torch.zeros(3, 3, 5, 7)),
            "contiguity": lambda: (x.transpose(1, 2), w),
            "grad_x": lambda: (x.requires_grad_(), w),
            "grad_w": lambda: (x, w.requires_grad_())}[kind]()


@pytest.mark.parametrize("kind, error, match", [
    ("dtype", TypeError, "bfloat16 or float32"),
    ("rank", ValueError, r"\(B, H, W, C\)"),
    ("channels", ValueError, r"expected \(3, 3, 6, O\)"),
    ("contiguity", ValueError, "contiguous"),
    ("grad_x", RuntimeError, "no backward"),
    ("grad_w", RuntimeError, "no backward"),
])
def test_wrapper_refuses(kind, error, match):
    with pytest.raises(error, match=match):
        conv3x3(*_refused(kind))


@pytest.mark.parametrize("O, refused", [(TILE_OUT * 65535, False), (TILE_OUT * 65535 + 1, True)])
def test_guard_follows_the_output_tile(O, refused):
    """The grid's y extent (O / TILE_OUT tiles) is at most 65535."""
    x = torch.empty(1, 2, 2, 1, device="meta")
    w = torch.empty(3, 3, 1, O, device="meta")
    if refused:
        with pytest.raises(ValueError, match=f"O <= {TILE_OUT * 65535}"):
            _check(x, w)
    else:
        _check(x, w)


def test_operands_requiring_grad_run_under_no_grad():
    x, w = _refused("grad_x")
    with torch.no_grad():
        got = conv3x3(x, w)
    assert torch.equal(got, conv3x3_reference(x.detach(), w))
