"""daclip_torch kernel wrappers on the CPU: their plain versions against the
JAX package's references and Pallas kernels (interpret mode), the CPU
dispatch, and the checks that guard the CUDA launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.ops import flash_attention as tfa
from daclip_torch.ops import linear_attention as tla
from daclip_tpu.ops.flash_attention import _reference as jax_flash_reference
from daclip_tpu.ops.flash_attention import flash_self_attention_pallas
from daclip_tpu.ops.linear_attention import (_attn_wrap_composition_reference,
                                             attn_wrap_v5)
from daclip_tpu.ops.linear_attention import \
    linear_attention_reference as jax_linear_attention_reference

torch.set_num_threads(1)


def _wrap_inputs(B, n, C, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, n, C).astype(np.float32),
            rng.randn(C).astype(np.float32),
            (rng.randn(C, 384) * 0.1).astype(np.float32),
            (rng.randn(128, C) * 0.1).astype(np.float32),
            rng.randn(C).astype(np.float32),
            rng.randn(C).astype(np.float32)]


def _np_linear_attention(qkv, heads=4, dim_head=32):
    """The reference's LinearAttention core in f64 numpy (module_util.py:
    157-185): softmax(q over each head's channels)·scale times
    softmax(k over n)ᵀ·(v/n), per head."""
    B, n, _ = qkv.shape
    q, k, v = (t.astype(np.float64).reshape(B, n, heads, dim_head)
               for t in np.split(qkv, 3, axis=-1))
    q = np.exp(q - q.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    k = np.exp(k - k.max(1, keepdims=True))
    k /= k.sum(1, keepdims=True)
    ctx = np.einsum("bnhd,bnhe->bhde", k, v / n)
    return np.einsum("bnhd,bhde->bnhe", q * dim_head ** -0.5, ctx).reshape(B, n, -1)


def _channel_ln(x, g):
    xc = x - x.mean(-1, keepdims=True)
    return xc / np.sqrt((xc ** 2).mean(-1, keepdims=True) + 1e-5) * g


def _balanced(args):
    """The same wrap inputs with v scaled so that attn·W_out is as large as
    the out-projection bias. The reference divides the attention by s·n, so
    at the usual scales the out-LN sees little but the bias and a wrong
    attention hides under any tolerance; here a wrong softmax, mask or
    scale, or a skipped attention, moves the output by order 1."""
    x, g_pre, w_qkv, w_out, b_out, g_out = (a.astype(np.float64) for a in args)
    attn = _np_linear_attention(_channel_ln(x, g_pre) @ w_qkv) @ w_out
    w_qkv[:, 256:] *= b_out.std() / attn.std()
    return [a.astype(np.float32) for a in (x, g_pre, w_qkv, w_out, b_out, g_out)]


def _assert_attention_shows(args, out):
    """The attention's share of `out` (out minus the output with the
    attention left out) is of order 1."""
    x, _, _, _, b_out, g_out = (np.asarray(a, np.float64) for a in args)
    assert np.abs(out - x - _channel_ln(b_out, g_out)).mean() > 0.3


@pytest.mark.parametrize("B,n", [(2, 2048), (1, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_linear_attention_core_matches_jax(B, n, dtype):
    """The attention core alone, where nothing else can mask it: the port's
    plain version against daclip_tpu's and against f64 numpy, relative to
    the output's own size."""
    rng = np.random.RandomState(3)
    qkv = (rng.randn(B, n, 384) * np.repeat([2.0, 2.0, 1.0], 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq = jnp.asarray(qkv).astype(jdt)
    want = np.asarray(jax_linear_attention_reference(jq).astype(jnp.float32))
    got = tla.linear_attention_reference(
        torch.from_numpy(np.array(jq.astype(jnp.float32))).to(tdt)).float().numpy()
    scale = np.abs(want).max()
    rtol = 1e-5 if dtype == "float32" else 1e-2  # bf16: one rounding of W or q_soft
    np.testing.assert_allclose(got, want, atol=rtol * scale)
    exact = _np_linear_attention(np.asarray(jq.astype(jnp.float32)))
    np.testing.assert_allclose(got, exact, atol=(1e-5 if dtype == "float32" else 2e-2) * scale)


@pytest.mark.parametrize("C,n", [(64, 2048), (128, 2048), (256, 2048), (64, 1000)])
def test_plain_wrap_matches_jax_composition_f32(C, n):
    args = _wrap_inputs(2, n, C)
    want = np.asarray(_attn_wrap_composition_reference(*map(jnp.asarray, args)))
    got = tla.attn_wrap(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("C,n", [(64, 2048), (128, 2048), (256, 2048), (64, 1000)])
def test_plain_wrap_matches_jax_composition_balanced_f32(C, n):
    args = _balanced(_wrap_inputs(2, n, C))
    want = np.asarray(_attn_wrap_composition_reference(*map(jnp.asarray, args)))
    _assert_attention_shows(args, want)
    got = tla.attn_wrap(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _pallas_bf16(args):
    args = [a.astype(jnp.bfloat16) for a in map(jnp.asarray, args)]
    want = np.asarray(attn_wrap_v5(*args, interpret=True), np.float32)
    targs = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in args]
    got = tla.attn_wrap(*targs)
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), want, [t.float().numpy() for t in targs]


@pytest.mark.parametrize("C", [64, 128, 256])
def test_plain_wrap_matches_pallas_kernel_bf16(C):
    """In bf16 against the TPU kernel itself, within the JAX suite's own
    bound for that kernel (tests/test_ops.py, atol 0.1)."""
    got, want, _ = _pallas_bf16(_wrap_inputs(1, 2048, C, 1))
    np.testing.assert_allclose(got, want, atol=0.1)


@pytest.mark.parametrize("C", [64, 128, 256])
def test_plain_wrap_matches_pallas_kernel_balanced_bf16(C):
    """Here outputs reach ±9, where one bf16 step is 1/16, and the plain
    version rounds q, k and y to bf16 where the kernel keeps f32: the bound
    is 0.1 plus two bf16 steps of the value (rtol 2^-6), and 1e-2 on the
    mean, which a wrong attention (errors of order 1) cannot meet."""
    got, want, args = _pallas_bf16(_balanced(_wrap_inputs(1, 2048, C, 1)))
    _assert_attention_shows(args, want)
    np.testing.assert_allclose(got, want, atol=0.1, rtol=2 ** -6)
    assert np.abs(got - want).mean() < 1e-2


def _qkv(B, N, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, H * D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,N,H,D", [(2, 64, 4, 32), (1, 100, 2, 64)])
def test_plain_flash_matches_jax_reference_and_pallas(B, N, H, D):
    q, k, v = _qkv(B, N, H, D)
    got = tfa.flash_self_attention(*map(torch.from_numpy, (q, k, v)), H, D).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jax_flash_reference(jq, jk, jv, H, D)),
                               atol=1e-5)
    if N % 8 == 0:  # the Pallas kernel's own block constraint
        want = flash_self_attention_pallas(jq, jk, jv, H, D, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    tla.attn_wrap.launches = 0
    tfa.flash_self_attention.launches = 0
    args = list(map(torch.from_numpy, _wrap_inputs(1, 100, 64)))
    assert torch.equal(tla.attn_wrap(*args), tla.attn_wrap_reference(*args))
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 2, 32))
    assert torch.equal(tfa.flash_self_attention(q, k, v, 2, 32),
                       tfa.attention_reference(q, k, v, 2, 32))
    assert tla.attn_wrap.launches == 0 and tfa.flash_self_attention.launches == 0


def test_unsupported_devices_shapes_and_dtypes_raise():
    meta = torch.empty((1, 64, 64), device="meta")
    with pytest.raises(ValueError):
        tla.attn_wrap(meta, *[torch.empty(s, device="meta")
                              for s in [(64,), (64, 384), (128, 64), (64,), (64,)]])
    with pytest.raises(ValueError):
        tfa.flash_self_attention(meta, meta, meta, 2, 32)

    def wrap_args(C, n=128, dtype=torch.float32):
        return [torch.zeros(s, dtype=dtype) for s in
                [(1, n, C), (C,), (C, 384), (128, C), (C,), (C,)]]
    for C in (48, 544):  # not a multiple of 32, above 512
        with pytest.raises(ValueError):
            tla._check(*wrap_args(C))
    with pytest.raises(TypeError):
        tla._check(*wrap_args(64, dtype=torch.float16))
    bad = wrap_args(64)
    bad[2] = bad[2][:, :383]  # wrong w_qkv width
    with pytest.raises(ValueError):
        tla._check(*bad)
    mixed = wrap_args(64)
    mixed[3] = mixed[3].to(torch.bfloat16)
    with pytest.raises(ValueError):
        tla._check(*mixed)
    strided = wrap_args(64)
    strided[0] = torch.zeros(1, 64, 128)[:, :, ::2]
    with pytest.raises(ValueError):
        tla._check(*strided)

    q = torch.zeros(1, 64, 64)
    with pytest.raises(ValueError):
        tfa._check(q, q, q, 4, 16)  # dim_head 16
    with pytest.raises(ValueError):
        tfa._check(q, q, q, 3, 32)  # heads·dim_head != width
    with pytest.raises(TypeError):
        h = q.half()
        tfa._check(h, h, h, 2, 32)
    with pytest.raises(ValueError):
        tfa._check(q, torch.zeros(1, 32, 64), q, 2, 32)
    with pytest.raises(ValueError):
        s = torch.zeros(1, 64, 128)[:, :, ::2]
        tfa._check(s, s, s, 2, 32)
