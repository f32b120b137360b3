"""daclip_torch IR-SDE against daclip_tpu's, on the CPU: the schedule tables,
the three reverse samplers with fixed noise, and the oracle rollout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.sde import IRSDE as TorchSDE
from daclip_torch.sde import make_schedule as torch_schedule
from daclip_tpu.sde import IRSDE as JaxSDE
from daclip_tpu.sde.irsde import make_schedule as jax_schedule

torch.set_num_threads(1)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_tables_equal_jax(schedule):
    a = jax_schedule(50 / 255.0, 100, schedule)
    b = torch_schedule(50 / 255.0, 100, schedule)
    assert a.dt == b.dt and a.max_sigma == b.max_sigma
    for name, x in a._asdict().items():
        if not isinstance(x, np.ndarray):
            continue
        y = getattr(b, name)
        assert x.dtype == y.dtype, name
        if x.dtype == np.float64:
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-7, err_msg=name)


def _toy_noise_fn(lib, sde):
    """A fixed smooth 'network', the same function in both frameworks: the
    true noise towards a guessed x0, plus a perturbation."""
    def fn(x, mu, tb, text_context=None, image_context=None):
        t = tb[0] / sde.sample_scale
        t = (int(round(float(t))) if lib is torch
             else jnp.round(t).astype(jnp.int32))  # traced inside lax.scan
        x0 = 0.5 + 0.1 * lib.sin(3.0 * mu)
        return sde.get_real_noise(x, x0, mu, t) + 0.05 * lib.sin(5.0 * x)
    return fn


def _data(shape=(2, 8, 8, 3), seed=0):
    rng = np.random.RandomState(seed)
    lq = rng.rand(*shape).astype(np.float32)
    x_T = (lq + rng.randn(*shape) * (50 / 255.0)).astype(np.float32)
    return lq, x_T


def _t(a):  # NHWC numpy → NCHW torch
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("sample_T", [-1, 50])
def test_reverse_samplers_match_jax(sample_T):
    jsde = JaxSDE(max_sigma=50, T=100, sample_T=sample_T)
    tsde = TorchSDE(max_sigma=50, T=100, sample_T=sample_T)
    lq, x_T = _data()
    steps = tsde.sample_T
    noises = np.random.RandomState(1).randn(steps, *lq.shape).astype(np.float32)
    jfn, tfn = _toy_noise_fn(jnp, jsde), _toy_noise_fn(torch, tsde)

    want = np.asarray(jsde.reverse_posterior(jfn, jnp.asarray(x_T), jnp.asarray(lq),
                                             jax.random.PRNGKey(0),
                                             noises=jnp.asarray(noises)))
    got = tsde.reverse_posterior(tfn, _t(x_T), _t(lq),
                                 noises=torch.from_numpy(noises.transpose(0, 1, 4, 2, 3)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)

    want = np.asarray(jsde.reverse_ode(jfn, jnp.asarray(x_T), jnp.asarray(lq)))
    got = tsde.reverse_ode(tfn, _t(x_T), _t(lq))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)

    # reverse_sde draws z_t = normal(fold_in(key, t)) inside the JAX scan;
    # hand the port the same draws in the same step order
    key = jax.random.PRNGKey(5)
    want = np.asarray(jsde.reverse_sde(jfn, jnp.asarray(x_T), jnp.asarray(lq), key))
    draws = iter([torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(key, t), x_T.shape, jnp.float32)).transpose(0, 3, 1, 2).copy())
        for t in range(steps, 0, -1)])
    tsde._randn = lambda x, generator: next(draws)
    got = tsde.reverse_sde(tfn, _t(x_T), _t(lq))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


def test_reverse_sde_runs_with_generator_and_is_seeded():
    tsde = TorchSDE(max_sigma=50, T=20)
    lq, x_T = _data((1, 4, 4, 3))
    fn = _toy_noise_fn(torch, tsde)
    run = lambda: tsde.reverse_sde(fn, _t(x_T), _t(lq), torch.Generator().manual_seed(3))
    a, b = run(), run()
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_oracle_posterior_rollout_reconstructs_gt():
    tsde = TorchSDE(max_sigma=50, T=100)
    rng = np.random.RandomState(2)
    gt = torch.from_numpy(rng.rand(1, 3, 8, 8).astype(np.float32))
    mu = torch.from_numpy(rng.rand(1, 3, 8, 8).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    oracle = lambda xt, mu_, tb, **kw: tsde.get_real_noise(xt, gt, mu_, int(tb[0]))
    rec = tsde.reverse_posterior(oracle, tsde.noise_state(mu, g), mu, g)
    assert float((rec - gt).abs().max()) < 1e-6
    rec = tsde.optimal_reverse(tsde.noise_state(mu, g), gt, mu)
    assert float((rec - gt).abs().max()) < 1e-6
