"""daclip_torch over several CPU ranks against daclip_tpu over its virtual
CPU mesh (tests/conftest.py's 8 devices).

The port runs in 2-4 spawned gloo processes (tests/torch_parallel_workers.py,
which imports no jax), each on its rows of a global batch made from a
numpy seed; daclip_tpu runs here on the same global batch over
`make_mesh(data=4)` or `data=2, fsdp=2` (its numbers do not depend on the
mesh: tests/test_train.py:262). Held, with the tolerances of the
single-card tests (tests/test_torch_clip_loss.py, test_torch_clip_train.py,
test_torch_train.py):

  1. the global losses (clip, the fork's with FCRC and masked regression,
     uir, distillation) and each rank's feature gradient, on a batch whose
     ranks hold different counts of present types;
  2. DA-CLIP steps of `daclip_test-tiny` with the predictor under DDP (4),
     HSDP (2 × 2) and in one process;
  3. the two-pass accumulation over 2 ranks;
  4. a restoration step of a tiny UNet under DDP and FSDP, fed the same
     global draws;
  5. the elastic resume: saved under 2 × 2, resumed under 1 × 2 and on one
     process, the uninterrupted trajectory continued;
  6. tensor parallelism on 2,1,2: the forward against the replicated one,
     the steps against DDP's and daclip_tpu's, rank 0's checkpoint state,
     and each layout's DTensor placement;
and the mesh and process-group refusals. The CLIs under two ranks are in
tests/test_torch_parallel_cli.py."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from daclip_torch import parallel
from daclip_torch.convert import unet_state_dict_from_jax
from daclip_torch.models.unet import ConditionalUNet as TorchUNet
from daclip_torch.parallel import mesh as tmesh
from daclip_torch.train import restoration as trest
from daclip_torch.utils.checkpoint import restore_checkpoint
from daclip_tpu.losses import (clip_loss, daclip_loss_fork, daclip_loss_uir,
                               distill_clip_loss)
from daclip_tpu.losses.matching import matching_loss
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
from daclip_tpu.parallel import fsdp_param_shardings, make_mesh
from daclip_tpu.sde import IRSDE as JaxSDE
from daclip_tpu.train import clip_train as jct
from daclip_tpu.train import restoration as jrest
from tests import torch_parallel_workers as w
from tests.test_torch_clip_train import BANKS, _batch, _setup
from tests.test_torch_text import jax_daclip_params
from tests.test_torch_train import KW
from tests.test_torch_unet import _seeded_params

torch.set_num_threads(1)
RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-5


def _mesh(data, fsdp=1):
    return make_mesh(data=data, fsdp=fsdp, devices=jax.devices()[:data * fsdp])


def _put(tree, mesh, spec):
    return jax.device_put(tree, NamedSharding(mesh, spec))


# -- 1. losses ----------------------------------------------------------------------------
def _loss_data(B=8, D=16, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    deg = (rng.rand(B, 4) > 0.5).astype(np.float32)
    deg[:2], deg[6:] = 1.0, 0.0  # rank 0 holds all 4 types twice, rank 3 none
    lows, highs = np.array([0.5, 5, 0.5, 10]), np.array([4, 40, 4, 80])
    centers = np.stack([np.linspace(lo, hi, 7) for lo, hi in zip(lows, highs)])
    return dict(image_features=f(B, D), text_features=f(B, D), image_degra_features=f(B, D),
                text_degra_features=f(B, D), gt_image_features=f(B, D), pred=f(B, 4) * 10,
                deg_type=deg, gt_val=(deg * (lows + rng.rand(B, 4) * (highs - lows))).astype(
                    np.float32),
                logit_scale=np.float32(14.0), tokens=f(28, D),
                centers=centers.astype(np.float32), t_image=f(B, D), t_text=f(B, D))


def test_global_losses_and_feature_gradients_equal_jax_on_its_mesh(tmp_path):
    data = _loss_data()
    keys = ("image_features", "text_features", "image_degra_features",
            "text_degra_features", "gt_image_features", "pred")
    assert len({data["deg_type"][2 * r:2 * r + 2].sum() for r in range(4)}) > 1
    mesh = _mesh(4)
    sharded = {k: _put(jnp.asarray(v), mesh, P("data"))
               for k, v in data.items() if k in keys or k in ("deg_type", "gt_val")}

    def terms(feats, rest):
        out = dict(feats, **rest, logit_scale=data["logit_scale"],
                   all_d_type_tokens_features=data["tokens"],
                   bin_center_features=data["centers"])
        return dict(clip=clip_loss(out["image_features"], out["text_features"],
                                   out["logit_scale"]),
                    **{f"fork_{k}": v for k, v in daclip_loss_fork(out).items()},
                    **{f"uir_{k}": v for k, v in daclip_loss_uir(out).items()},
                    **{f"distill_{k}": v for k, v in distill_clip_loss(
                        out["image_features"], out["text_features"], out["logit_scale"],
                        data["t_image"], data["t_text"], 20.0).items()})

    feats = {k: sharded[k] for k in keys}
    rest = {k: sharded[k] for k in ("deg_type", "gt_val")}
    want = jax.jit(terms)(feats, rest)
    jgrads = jax.jit(jax.grad(lambda f, r: sum(terms(f, r).values())))(feats, rest)
    out = w.spawn(w.losses, 4, tmp_path, data)
    assert float(want["fork_fcrc_loss"]) > 0 and float(want["fork_reg_ls_loss"]) > 0
    for r, o in enumerate(out):
        for k, v in want.items():
            np.testing.assert_allclose(o["losses"][k], float(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} on rank {r}")
        for k in keys:
            # all_gather's backward sums the 4 ranks' (equal) gradients of
            # the rows; DDP's average divides by 4
            g, jg = o["grads"][k] / 4, np.asarray(jgrads[k])[2 * r:2 * r + 2]
            np.testing.assert_allclose(g, jg, rtol=0, atol=ATOL + RTOL * np.abs(jg).max(),
                                       err_msg=f"d/d{k} on rank {r}")


# -- 2, 3, 6. DA-CLIP steps ------------------------------------------------------------
@pytest.fixture(scope="module")
def jparams():
    return jax_daclip_params(seed=0)


@pytest.fixture(scope="module")
def clip_setup(jparams):
    """The torch model's state dict, the JAX step, state and frozen tree."""
    model, _, _, jstep, jstate, frozen, _, to_sd = _setup("fork", jparams)
    return model.state_dict(), jstep, jstate, frozen, to_sd


BATCHES = [_batch(40 + i, n=8) for i in range(2)]
# (layout, shape) of the tensor-parallel split cases
SPLITS = [(("heads",), (12, 5)), (("heads",), (12,)), (("rows",), (8, 3)), (("cols",), (3, 8))]


def _jax_clip_steps(clip_setup, mesh, fsdp=False):
    _, jstep, jstate, frozen, to_sd = clip_setup
    jstate = _put(jstate, mesh, P())
    if fsdp:
        jstate = jstate._replace(params=jax.device_put(
            jstate.params, fsdp_param_shardings(jstate.params, mesh, min_size=1024)))
    frozen = _put(frozen, mesh, P())
    metrics = []
    for b in BATCHES:
        jstate, m = jstep(jstate, _put(b, mesh, P("data")), frozen)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, to_sd(jct.merge_params(jax.device_get(jstate.params),
                                           jax.device_get(frozen)))


def _clip_run(sd, mesh, batches=BATCHES, **kw):
    return dict(name="daclip_test-tiny", sd=sd, mesh=mesh, banks=BANKS, batches=batches,
                cfg=dict(lr=1e-3, warmup=2, total_steps=6, wd=0.2, eps=1e-3,
                         variant="fork"), min_size=1024, **kw)


def _check_run(got, want_metrics, want_params, what):
    for i, (g, wm) in enumerate(zip(got["metrics"], want_metrics)):
        assert set(g) == set(wm)
        for k, v in wm.items():
            np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {k} at step {i}")
    assert set(got["params"]) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def clip_ranks(clip_setup, tmp_path_factory):
    """DDP (4, its static graph, which --ddp-static-graph turns on), HSDP
    (2 × 2) and TP (2,1,2) in one group of 4 ranks."""
    sd = clip_setup[0]
    fwd = _batch(50, n=4)
    runs = [_clip_run(sd, "4", static_graph=True), _clip_run(sd, "2,2"),
            _clip_run(sd, "2,1,2", tp=True, forward=fwd, splits=SPLITS)]
    return w.spawn(w.clip_runs, 4, tmp_path_factory.mktemp("clip"), runs)


@pytest.mark.parametrize("case", ["ddp", "hsdp", "one_process"])
def test_daclip_steps_equal_jax_on_its_mesh(clip_setup, clip_ranks, case):
    if case == "one_process":  # the port without a group, the whole batch
        sd = clip_setup[0]
        got = w.clip_steps(0, 1, dict(_clip_run(sd, None)))
    else:
        got = clip_ranks[0][{"ddp": 0, "hsdp": 1}[case]]
    mesh = _mesh(2, 2) if case == "hsdp" else _mesh(4)
    want_m, want_p = _jax_clip_steps(clip_setup, mesh, fsdp=case == "hsdp")
    _check_run(got, want_m, want_p, case)
    assert got["static_graph"] is {"ddp": True, "hsdp": None, "one_process": None}[case]
    if case != "one_process":  # every rank ends with the same whole parameters
        idx = {"ddp": 0, "hsdp": 1}[case]
        for k, v in got["params"].items():
            assert torch.equal(clip_ranks[3][idx]["params"][k], v), k


def test_tensor_parallel_forward_and_steps(clip_setup, clip_ranks):
    tp, ddp = clip_ranks[0][2], clip_ranks[0][0]
    # every attention and MLP of the three towers splits its heads/width
    assert tp["tp_params"] == 2 * 3 * 2  # (attn, mlp) × 3 towers × 2 blocks
    for k, (got, want) in tp["forward"].items():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
    want_m, want_p = _jax_clip_steps(clip_setup, _mesh(4))
    _check_run(tp, want_m, want_p, "tp")
    # the checkpoint's state dict: whole tensors on rank 0 only
    assert tp["model_state"].keys() == tp["params"].keys()
    for k, v in tp["params"].items():
        assert torch.equal(tp["model_state"][k], v), k
    assert all(clip_ranks[r][2]["model_state"] == {} for r in range(1, 4))
    for k, v in ddp["params"].items():
        np.testing.assert_allclose(tp["params"][k].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_accumulation_over_two_ranks_equals_jax(jparams, tmp_path):
    model, _, _, jstep, jstate, frozen, _, to_sd = _setup("fork", jparams, accum_freq=2)
    micro = [[_batch(60 + 2 * i, n=8), _batch(61 + 2 * i, n=8)] for i in range(2)]
    mesh = _mesh(2)
    jstate, frozen = _put(jstate, mesh, P()), _put(frozen, mesh, P())
    want_m = []
    for mbs in micro:
        stacked = {k: np.stack([b[k] for b in mbs]) for k in mbs[0]}
        jstate, m = jstep(jstate, _put(stacked, mesh, P(None, "data")), frozen)
        want_m.append({k: float(v) for k, v in m.items()})
    want_p = to_sd(jct.merge_params(jax.device_get(jstate.params), jax.device_get(frozen)))
    run = _clip_run(model.state_dict(), "2", batches=micro)
    run["cfg"]["accum_freq"] = 2
    got = w.spawn(w.clip_steps, 2, tmp_path, run)
    _check_run(got[0], want_m, want_p, "accum")


# -- 4, 5. restoration ---------------------------------------------------------------------
B, H = 8, 16
RESTO_CFG = dict(niter=20, lr_G=1e-3)


def _resto_batch(seed=3):
    rng = np.random.RandomState(seed)
    gt = rng.rand(B, H, H, 3).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.randn(B, H, H, 3), 0, 1).astype(np.float32)
    return {"LQ": lq, "GT": gt, "text_context": rng.randn(B, 32).astype(np.float32),
            "image_context": rng.randn(B, 32).astype(np.float32)}


def _draws(n, seed=4):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 101, (B, 1, 1, 1)).astype(np.int64),
             rng.randn(B, H, H, 3).astype(np.float32)) for _ in range(n)]


@pytest.fixture(scope="module")
def resto(tmp_path_factory):
    """The JAX UNet's seeded parameters, the same as the port's state dict,
    and the 4-rank runs, each spawned in a group of its own: DDP and FSDP
    one step each, then 6 FSDP steps saved at 3. `ranks[r][i]` is rank r's
    result of run i."""
    jnet = JaxUNet(dtype=jnp.float32, **KW)
    b = _resto_batch()
    jparams = _seeded_params(jnet, (b["LQ"], b["LQ"], np.ones(B, np.float32),
                                    b["text_context"], b["image_context"]))
    sd = unet_state_dict_from_jax(jparams, depth=2)
    tmp = tmp_path_factory.mktemp("resto")
    base = dict(unet=KW, sd=sd, cfg=RESTO_CFG, batch=b, min_size=1024)
    runs = [dict(base, mesh="4", draws=_draws(1)), dict(base, mesh="2,2", draws=_draws(1)),
            dict(base, mesh="2,2", draws=_draws(6, seed=5), save=str(tmp / "ck"), save_at=3)]
    each = [w.spawn(w.resto_steps, 4, tmp / f"run{i}", run) for i, run in enumerate(runs)]
    return jnet, jparams, sd, tmp, [[got[r] for got in each] for r in range(4)]


@pytest.fixture(scope="module")
def jax_resto_step(resto):
    """daclip_tpu's loss and gradient of the first step's draw on the global
    batch over `make_mesh(data=2, fsdp=2)`, its parameters fsdp-sharded
    (min_size 1024, as the port's runs): (loss, global norm, gradients by
    the port's names)."""
    jnet, jparams, *_ = resto
    mesh = _mesh(2, 2)
    jsde, cfg = JaxSDE(max_sigma=50, T=100), jrest.RestorationTrainConfig(**RESTO_CFG)
    (t, noise), = _draws(1)
    b = {k: _put(jnp.asarray(v), mesh, P("data")) for k, v in _resto_batch().items()}
    jt = jnp.asarray(t, jnp.int32)

    def jloss(params):  # the step's loss on the given draw
        xt = noise * jsde.sigma_bar(jt) + jsde.mu_bar(b["LQ"], b["GT"], jt)
        pred = jnet.apply({"params": params}, xt, b["LQ"], jt.reshape(-1).astype(jnp.float32),
                          b["text_context"], b["image_context"])
        score = jsde.get_score_from_noise(pred, jt)
        return cfg.weight * matching_loss(jsde.reverse_sde_step_mean(xt, score, b["LQ"], jt),
                                          jsde.reverse_optimum_step(xt, b["GT"], b["LQ"], jt),
                                          cfg.loss_type)

    params = jax.device_put(jparams, fsdp_param_shardings(jparams, mesh, min_size=1024))
    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    return (float(loss), float(optax.global_norm(grads)),
            unet_state_dict_from_jax(jax.device_get(grads), depth=2))


@pytest.mark.parametrize("case", ["ddp", "fsdp"])
def test_restoration_step_equals_jax_on_its_mesh(resto, jax_resto_step, case):
    ranks = resto[-1]
    idx = 0 if case == "ddp" else 1
    got = ranks[0][idx]
    if case == "fsdp":
        assert got["sharded"] > 0  # some parameters really are FSDP shards
    loss, norm, want = jax_resto_step
    np.testing.assert_allclose(got["metrics"][0]["loss"], loss, rtol=RTOL)
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], norm, rtol=RTOL)
    assert set(got["grads"]) == set(want)
    for k, g in got["grads"].items():
        wk = want[k].numpy()
        assert np.abs(g.numpy() - wk).max() <= 1e-4 * max(np.abs(wk).max(), 1e-12), k
    # every rank ends with the same whole parameters and EMA
    for r in range(1, 4):
        for key in ("params", "ema"):
            for k, v in got[key].items():
                assert torch.equal(ranks[r][idx][key][k], v), (r, key, k)


def test_elastic_resume_under_another_mesh_and_one_process(resto, tmp_path):
    _, _, sd, tmp, ranks = resto
    uninterrupted = [m["loss"] for m in ranks[0][2]["metrics"][3:]]
    assert ranks[0][2]["files"] == ["3.pt"]
    draws = _draws(6, seed=5)[3:]
    run = dict(unet=KW, sd=sd, cfg=RESTO_CFG, batch=_resto_batch(), min_size=1024,
               mesh="1,2", draws=draws, resume=str(tmp / "ck"))
    got = w.spawn(w.resto_steps, 2, tmp_path, run)
    assert got[0]["step"] == 6
    np.testing.assert_allclose([m["loss"] for m in got[0]["metrics"]], uninterrupted,
                               rtol=RTOL)
    # one process, no group: the same file, the same continuation
    one = w.resto_steps(0, 1, dict(run, mesh=None))
    np.testing.assert_allclose([m["loss"] for m in one["metrics"]], uninterrupted, rtol=RTOL)
    for k, v in ranks[0][2]["params"].items():
        np.testing.assert_allclose(one["params"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_checkpoint_of_a_sharded_run_is_the_single_card_file(resto):
    _, _, _, tmp, ranks = resto
    ckpt = torch.load(tmp / "ck" / "3.pt", weights_only=False)
    net = TorchUNet(**KW)
    net.load_state_dict(ckpt["params"], strict=True)
    assert set(ckpt["params_ema"]) == {k for k, _ in trest.trainable(net)}
    state = trest.init_state(net, trest.RestorationTrainConfig(**RESTO_CFG), device="cpu")
    restore_checkpoint(str(tmp / "ck"), net, state)
    assert state.step == 3 and state.ema.step == 3
    exp_avg = state.optimizer.state_dict()["state"][0]["exp_avg"]
    assert exp_avg.shape == next(net.parameters()).shape


# -- the refusals and helpers --------------------------------------------------------------
@pytest.mark.parametrize("spec,world,match", [
    ("4", 1, "spans 4 processes, and this run has 1"),
    ("2,4", 1, "spans 8 processes, and this run has 1"),
    ("2,1,2", 2, "spans 4 processes, and this run has 2"),
    ("0", 1, "positive sizes")])
def test_a_mesh_that_is_not_the_world_is_refused(spec, world, match):
    with pytest.raises(ValueError, match=match):
        parallel.parse_mesh(spec, world)


def test_no_launcher_forms_no_group_and_a_batch_must_split(monkeypatch):
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "PMI_SIZE", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed(device="cpu") == (0, 1, 0, torch.device("cpu"))
    assert not parallel.is_distributed()
    assert parallel.mesh_from_spec(None, 1, "cpu") is None
    assert parallel.mesh_from_spec("1", 1, "cpu", batch_size=16) is None
    with pytest.raises(ValueError, match="batch of 6 does not split over the 4"):
        parallel.mesh_from_spec("2,2", 4, "cpu", batch_size=6)
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert not tmesh.launched_distributed()
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert tmesh.launched_distributed()


@pytest.mark.parametrize("layout,shape", SPLITS)
def test_tensor_parallel_split_and_join_round_trip(clip_ranks, layout, shape):
    """The placement `apply_tensor_parallel` gives each layout, on the TP
    run's `model` axis of 2: ranks 0 and 1 hold parts 0 and 1."""
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    for r in range(2):
        part, whole = clip_ranks[r][2]["splits"][SPLITS.index((layout, shape))]
        assert torch.equal(whole, full)
        if layout[0] == "heads":  # rank r holds head r of q, of k and of v
            q, k, v = full.reshape(3, 2, -1, *shape[1:])[:, r]
            assert torch.equal(part, torch.cat([q, k, v]))
        else:
            assert torch.equal(part, full.chunk(2, dim=0 if layout[0] == "rows" else 1)[r])


def test_the_wrappers_are_the_identity_without_a_group():
    net = TorchUNet(**KW)
    assert parallel.parallelize(net, None, "cpu") is net
    assert parallel.unwrap(net) is net and parallel.data_group(net) is None
    with parallel.no_sync(net):
        pass
    parallel.finish_grads(net)
    assert parallel.full_tensors({"x": torch.ones(2)})["x"].tolist() == [1.0, 1.0]
    sd = parallel.model_state(net)
    assert sd.keys() == net.state_dict().keys()
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in sd.items())
