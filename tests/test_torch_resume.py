"""Resuming daclip_tpu's training runs in the port: the state of its orbax
train dirs (`utils/native_checkpoint.load_restoration_train_state`,
`load_daclip_train_state`) against what daclip_tpu's own
`restore_checkpoint(target=…)` gives, bit for bit after the name map, on the
committed fixture's dirs and on dirs written here by daclip_tpu's
`init_state` + `save_checkpoint` in every optimizer layout its train CLIs
write; three updates after a resume against optax's; both train CLIs
resuming (and refusing) such dirs.

The port's side runs on the CPU; nothing here needs the card.
"""
import dataclasses
import logging
import os
import pathlib
import shutil
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from daclip_torch import parallel
from daclip_torch.cli import train_daclip as tcli_daclip
from daclip_torch.cli import train_restoration as tcli_resto
from daclip_torch.convert import (daclip_state_dict_from_jax,
                                  daclip_trainable_state_dict_from_jax,
                                  unet_state_dict_from_jax)
from daclip_torch.data import png
from daclip_torch.factory import create_model
from daclip_torch.models.unet import ConditionalUNet as TorchUNet
from daclip_torch.train import clip_train as tclip
from daclip_torch.train import restoration as trest
from daclip_torch.utils import checkpoint as tckpt
from daclip_torch.utils import native_checkpoint as nc
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
from daclip_tpu.train import clip_train as jclip
from daclip_tpu.train import restoration as jrest
from daclip_tpu.utils import checkpoint as jckpt
from daclip_tpu.utils import ema as jema
from tests.test_torch_unet import _seeded_params

torch.set_num_threads(1)
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "orbax"
MODEL = "daclip_test-tiny"
# the production UNet's layout at narrow width: every level, both contexts,
# the SpatialTransformers at level 3 and in the middle
KW = dict(nf=8, ch_mult=(1, 2, 4, 8), context_dim=32, use_degra_context=True,
          use_image_context=True)
STEP = 120  # past ema_pytorch's 100 copy steps, so that the EMA averages


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moments(opt_state):
    """(count, mu, nu | None) of an optax chain's scale_by_adam / lion state."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return int(found[0].count), found[0].mu, getattr(found[0], "nu", None)


def _no_grad(name):
    """A parameter the port's UNet never gives a gradient (a one-token
    cross-attention's to_q, to_k and norm2)."""
    return ".attn2.to_q." in name or ".attn2.to_k." in name or ".norm2." in name


def _assert_moments(payload_opt, index, count, mu, nu, names):
    """The payload's torch state equals the converted moments bit for bit;
    the parameters without a gradient hold none (and zeros in optax)."""
    state = payload_opt["state"]
    for name in names:
        if _no_grad(name):
            assert index[name] not in state
            assert not torch.count_nonzero(mu[name]), name
            continue
        st = state[index[name]]
        assert torch.equal(st["exp_avg"], mu[name]), name
        if nu is not None:
            assert torch.equal(st["exp_avg_sq"], nu[name]), name
            assert float(st["step"]) == count
        else:
            assert set(st) == {"exp_avg"}


def _assert_sd(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _resto_payload_equals_jax(directory, step, jcfg, tcfg):
    """The port's payload of a restoration dir against daclip_tpu's
    restore_checkpoint(target=init_state(…)); (payload, restored, unet)."""
    raw = jckpt.restore_checkpoint(str(directory), step)
    target = jrest.init_state(jax.tree.map(jnp.asarray, raw["params"]), jcfg)
    want = jckpt.restore_checkpoint(str(directory), step, target=target)
    params = nc._unwrap_flax(_np(want.params))
    arch = nc.infer_unet_arch_from_params(params)
    depth = len(arch["ch_mult"])
    unet = TorchUNet(**arch)
    got = nc.load_restoration_train_state(str(directory), step, cfg=tcfg, unet=unet)
    _assert_sd(got["params"], unet_state_dict_from_jax(params, depth))
    _assert_sd(got["params_ema"],
               unet_state_dict_from_jax(nc._unwrap_flax(_np(want.ema.params)), depth))
    assert got["ema_step"] == int(want.ema.step) and got["step"] == int(want.step) == step
    count, mu, nu = _moments(want.opt_state)
    assert count == step
    conv = lambda t: unet_state_dict_from_jax(nc._unwrap_flax(_np(t)), depth)
    index = {n: i for i, (n, _) in enumerate(trest.trainable(unet))}
    _assert_moments(got["opt_state"], index, count, conv(mu), None if nu is None else conv(nu),
                    index)
    # the SpatialTransformer blocks: down3, mid, up3 at four levels, the middle at two
    assert sum(map(_no_grad, index)) == 4 * (3 if depth == 4 else 1)
    return got, want, unet


@pytest.mark.parametrize("step", [2, 4])
def test_fixture_restoration_dirs_equal_jax_restore(step):
    cfg = dict(optimizer="AdamW", lr_G=1e-4, niter=4, eta_min=1e-6)
    got, _, unet = _resto_payload_equals_jax(FIXTURE / "restoration", step,
                                             jrest.RestorationTrainConfig(**cfg),
                                             trest.RestorationTrainConfig(**cfg))
    # the one SpatialTransformer block (the middle): its to_q, to_k, norm2
    assert len(got["opt_state"]["state"]) == len(trest.trainable(unet)) - 4
    # without a model or an optimizer: the UNet its params make, on the meta
    # device, and the optimizer the dir holds, in the same layout
    bare = nc.load_restoration_train_state(str(FIXTURE / "restoration"), step)
    _assert_sd(bare["params"], got["params"])
    assert ([g["params"] for g in bare["opt_state"]["param_groups"]]
            == [g["params"] for g in got["opt_state"]["param_groups"]])
    assert set(bare["opt_state"]["state"]) == set(got["opt_state"]["state"])


def _daclip_parts(directory=FIXTURE / "daclip"):
    raw = jckpt.restore_checkpoint(str(directory))
    return jax.tree.map(jnp.asarray, raw["params"]), jax.tree.map(jnp.asarray, raw["frozen"])


def _daclip_payload_equals_jax(directory, step, jcfg, tcfg, model=None):
    trainable, frozen = _daclip_parts(directory)
    state = jclip.init_state(trainable, jcfg)
    want = jckpt.restore_checkpoint(str(directory), step, target={
        "params": state.params, "opt_state": state.opt_state, "step": state.step,
        "frozen": frozen, "epoch": 0})
    model = model or create_model(MODEL, use_predictor=True)
    named = [(n, p) for n, p in model.named_parameters() if not n.startswith("clip.")]
    optimizer = tclip.make_optimizer(named, tcfg)
    got = nc.load_daclip_train_state(str(directory), model, step, cfg=tcfg, optimizer=optimizer)
    _assert_sd(got["state_dict"], daclip_state_dict_from_jax(
        {**_np(want["params"]), **_np(want["frozen"])}))
    assert (got["epoch"], got["step"]) == (int(want["epoch"]), int(want["step"]))
    count, mu, nu = _moments(want["opt_state"])
    assert count == got["step"]
    conv = lambda t: daclip_trainable_state_dict_from_jax(_np(t))
    index, groups = parallel.optimizer_layout(model, optimizer)
    assert got["optimizer"]["param_groups"] == groups
    assert set(index) == {n for n, _ in named}
    _assert_moments(got["optimizer"], index, count, conv(mu), conv(nu), index)
    assert len(got["optimizer"]["state"]) == len(index)
    return got


def test_fixture_daclip_dir_equals_jax_restore():
    got = _daclip_payload_equals_jax(FIXTURE / "daclip", 1, jclip.ClipTrainConfig(),
                                     tclip.ClipTrainConfig())
    assert got["epoch"] == 1


# -- dirs written here by daclip_tpu, in each optimizer layout ----------------------------------
@pytest.fixture(scope="module")
def jparams():
    """The narrow production-layout UNet's seeded tree, as the CLI's
    `unet.init` gives it ({'params': …})."""
    rng = np.random.RandomState(0)
    x = rng.rand(1, 16, 16, 3).astype(np.float32)
    ctx = rng.randn(1, 32).astype(np.float32)
    net = JaxUNet(dtype=jnp.float32, **KW)
    return {"params": _seeded_params(net, (x, x, np.ones((1,), np.float32), ctx, ctx), seed=3)}


def _grads(params, seed):
    """Seeded gradients in the params' tree; zeros where the model gives
    none (the one-token cross-attention's to_k and norm2)."""
    rng = np.random.RandomState(seed)

    def one(path, p):
        name = jax.tree_util.keystr(path)
        if "attn2" in name and "to_k" in name or "norm2" in name:
            return jnp.zeros_like(p)
        return jnp.asarray(np.asarray(rng.randn(*np.shape(p)), np.float32) * 0.1)
    return jax.tree_util.tree_map_with_path(one, params)


def _jax_update(jcfg):
    """daclip_tpu's update after its gradients, jitted: tx.update,
    apply_updates, the EMA."""
    tx = jrest.make_optimizer(jcfg)

    @jax.jit
    def update(g, opt_state, params, ema):
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return opt_state, params, jema.update(ema, params, beta=jcfg.ema_beta,
                                              update_every=jcfg.ema_update_every)
    return update


def _at_count(opt_state, n):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(n, x.dtype)
        if path and getattr(path[-1], "name", None) == "count" else x, opt_state)


RESTO = {"adam": dict(optimizer="Adam"),
         "adamw_clip": dict(optimizer="AdamW", grad_clip=1.0),
         "lion": dict(optimizer="Lion", lr_G=3e-5)}


def _write_resto_dir(path, jparams, jcfg, step=STEP, count=STEP):
    """daclip_tpu's TrainState after two updates, its counts set to `count`
    and its step to `step`, saved by its own save_checkpoint."""
    update = _jax_update(jcfg)
    state = jrest.init_state(jax.tree.map(jnp.asarray, jparams), jcfg)
    params, opt_state, ema = state.params, state.opt_state, state.ema
    for k in range(2):
        opt_state, params, ema = update(_grads(params, 10 + k), opt_state, params, ema)
    state = jrest.TrainState(params, _at_count(opt_state, count), ema._replace(
        step=jnp.asarray(step, jnp.int32)), jnp.asarray(step, jnp.int32))
    jckpt.save_checkpoint(str(path), step, state)
    return state


@pytest.mark.parametrize("layout", sorted(RESTO))
def test_written_restoration_layouts_equal_jax_and_update_alike(tmp_path, jparams, layout):
    kw = dict(RESTO[layout], niter=500, ema_update_every=1)
    jcfg, tcfg = jrest.RestorationTrainConfig(**kw), trest.RestorationTrainConfig(**kw)
    _write_resto_dir(tmp_path / "ts", jparams, jcfg)
    _, want, _ = _resto_payload_equals_jax(tmp_path / "ts", STEP, jcfg, tcfg)

    # the port resumes it through the CLI's path, then three updates from
    # seeded gradients against optax's (the parameters without a gradient
    # get none in the port, zeros in optax)
    unet = TorchUNet(**KW)
    state = trest.init_state(unet, tcfg, device="cpu")
    tckpt.restore_checkpoint(str(tmp_path / "ts"), unet, state, cfg=tcfg)
    assert state.step == STEP and state.ema.step == STEP
    update, jschedule = _jax_update(jcfg), jrest.make_schedule(jcfg)
    schedule = trest.make_schedule(tcfg)
    params, opt_state, ema = want.params, want.opt_state, want.ema
    conv = lambda t: unet_state_dict_from_jax(nc._unwrap_flax(_np(t)), 4)
    for k in range(3):
        g = _grads(params, 20 + k)
        tg = conv(g)
        for name, p in trest.trainable(unet):
            p.grad = None if _no_grad(name) else tg[name].clone()
        _, lr = trest.apply_gradients(state, unet, tcfg, schedule)
        np.testing.assert_allclose(lr, float(jschedule(STEP + k)), rtol=1e-6)
        opt_state, params, ema = update(g, opt_state, params, ema)
    assert state.step == STEP + 3
    for want_sd, got in ((conv(params), dict(unet.named_parameters())),
                         (conv(ema.params), state.ema.params)):
        for name, w in want_sd.items():
            np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


DACLIP = {"clip": dict(grad_clip_norm=1.0), "accum": dict(accum_freq=2)}


def _write_daclip_dir(path, jcfg, epoch=3, steps=2):
    """daclip_tpu's DA-CLIP train state after `steps` updates, saved as its
    CLI saves it (the accumulation's optimizer is the plain one)."""
    trainable, frozen = _daclip_parts()
    cfg = dataclasses.replace(jcfg, accum_freq=1) if jcfg.accum_freq > 1 else jcfg
    tx = jclip.make_optimizer(cfg, None)
    state = jclip.init_state(trainable, cfg)
    params, opt_state = state.params, state.opt_state
    for k in range(steps):
        rng = np.random.RandomState(30 + k)
        g = jax.tree.map(lambda p: jnp.asarray(np.asarray(rng.randn(*np.shape(p)), np.float32)),
                         params)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    jckpt.save_checkpoint(str(path), epoch, {
        "params": params, "opt_state": opt_state, "step": jnp.asarray(steps, jnp.int32),
        "frozen": frozen, "epoch": epoch})


@pytest.mark.parametrize("layout", sorted(DACLIP))
def test_written_daclip_layouts_equal_jax(tmp_path, layout):
    jcfg, tcfg = jclip.ClipTrainConfig(**DACLIP[layout]), tclip.ClipTrainConfig(**DACLIP[layout])
    _write_daclip_dir(tmp_path / "ckpts", jcfg)
    cfg = dataclasses.replace(jcfg, accum_freq=1)  # the CLI's optimizer under accumulation
    got = _daclip_payload_equals_jax(tmp_path / "ckpts", 3, cfg, tcfg)
    assert (got["epoch"], got["step"]) == (3, 2)


def test_a_daclip_dir_without_optimizer_state_restores_the_parameters_alone(tmp_path, caplog):
    """daclip_tpu's CLI then restores its params alone (`cli/train_daclip.py:
    318-333`): with the frozen CLIP or without it (the model keeps its
    own), the step left as it was, the epoch the dir's."""
    trainable, frozen = _daclip_parts()
    jckpt.save_checkpoint(str(tmp_path / "a"), 2, {
        "params": trainable, "frozen": frozen, "step": jnp.asarray(5, jnp.int32), "epoch": 2})
    jckpt.save_checkpoint(str(tmp_path / "b"), 3, {"params": trainable})
    want = daclip_trainable_state_dict_from_jax(_np(trainable))
    for sub, epoch in (("a", 2), ("b", 3)):
        model = create_model(MODEL, use_predictor=True)
        clip_before = {k: v.clone() for k, v in model.state_dict().items()
                       if k.startswith("clip.")}
        state = tclip.init_state(model, tclip.ClipTrainConfig(), device="cpu")
        with caplog.at_level(logging.INFO, logger="resume"):
            got = tckpt.restore_clip_checkpoint(str(tmp_path / sub), model, state,
                                                log=logging.getLogger("resume"))
        assert got == epoch and state.step == 0 and not state.optimizer.state
        assert "holds no optimizer state" in caplog.text
        sd = model.state_dict()
        for k, v in want.items():
            assert torch.equal(sd[k], v), k
        if sub == "b":
            for k, v in clip_before.items():
                assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="mapped for a DaCLIP or a CLIP; the model is a "
                                         "ConditionalUNet"):
        nc.load_daclip_train_state(str(tmp_path / "a"), TorchUNet(**KW))


# -- refusals, each by name ---------------------------------------------------------------------
def test_refuses_another_optimizer_and_another_clip():
    with pytest.raises(ValueError, match=r"holds the state of adam with weight decay.*'Lion'"):
        nc.load_restoration_train_state(str(FIXTURE / "restoration"),
                                        cfg=trest.RestorationTrainConfig(optimizer="Lion"))
    with pytest.raises(ValueError, match=r"options name.*grad_clip 1\.0"):
        nc.load_restoration_train_state(str(FIXTURE / "restoration"),
                                        cfg=trest.RestorationTrainConfig(grad_clip=1.0))
    with pytest.raises(ValueError, match="grad_clip_norm 1.0"):
        nc.load_daclip_train_state(str(FIXTURE / "daclip"), create_model(MODEL, use_predictor=True),
                                   cfg=tclip.ClipTrainConfig(grad_clip_norm=1.0))


def test_refuses_multisteps(tmp_path):
    trainable, frozen = _daclip_parts()
    state = jclip.init_state(trainable, jclip.ClipTrainConfig(accum_freq=2))
    jckpt.save_checkpoint(str(tmp_path / "c"), 1, {
        "params": state.params, "opt_state": state.opt_state, "step": state.step,
        "frozen": frozen, "epoch": 1})
    with pytest.raises(ValueError, match="MultiSteps"):
        nc.load_daclip_train_state(str(tmp_path / "c"), create_model(MODEL, use_predictor=True))


def test_refuses_counts_that_differ(tmp_path, jparams):
    jcfg = jrest.RestorationTrainConfig()
    _write_resto_dir(tmp_path / "ts", jparams, jcfg, step=7, count=5)
    with pytest.raises(ValueError, match=r"count 5, the step 7 and the schedule's count 5"):
        nc.load_restoration_train_state(str(tmp_path / "ts"))


def test_refuses_a_tree_that_is_not_the_models_and_a_dir_without_opt_state(tmp_path, jparams):
    with pytest.raises(ValueError, match="the params tree is not the model's"):
        nc.load_restoration_train_state(str(FIXTURE / "restoration"), unet=TorchUNet(**KW))
    with pytest.raises(ValueError, match="not a DA-CLIP's"):
        nc.load_daclip_train_state(str(FIXTURE / "restoration"),
                                   create_model(MODEL, use_predictor=True))
    jckpt.save_checkpoint(str(tmp_path / "p"), 3, {
        "params": jax.tree.map(jnp.asarray, jparams), "step": jnp.asarray(3, jnp.int32),
        "ema": {"params": jax.tree.map(jnp.asarray, jparams), "step": jnp.asarray(3)}})
    with pytest.raises(ValueError, match=r"\['opt_state'\] are missing"):
        nc.load_restoration_train_state(str(tmp_path / "p"))


def test_the_weight_map_moves_leaves_and_computes_only_the_missing_to_q(jparams):
    params = nc._unwrap_flax(_np(jparams))
    conv = lambda t: unet_state_dict_from_jax(t, 4)
    computed = nc._computed_leaves(params, conv)
    assert computed and all(k.endswith("attn2.to_q.weight") for k in computed)
    # a map that computes a parameter's value is refused by name
    with pytest.raises(ValueError, match="computes downs.0.0.mlp.1.bias"):
        nc._unet_no_grad({"downs.0.0.mlp.1.bias"}, {"downs.0.0.mlp.1.bias": 0}, "here")
    with pytest.raises(ValueError, match="does not move each leaf once"):
        nc._computed_leaves(params, lambda t: {"only": torch.from_numpy(
            np.array(t["init_conv"]["kernel"], np.float32))})


def test_resume_point_prefers_the_newer_and_the_pt_on_a_tie(tmp_path):
    d = tmp_path / "ts"
    shutil.copytree(FIXTURE / "restoration", d)
    assert tckpt.resume_point(str(d)) == ("orbax", 4)
    (d / "4.pt").write_bytes(b"")
    assert tckpt.resume_point(str(d)) == ("pt", 4)
    (d / "4.pt").unlink()
    (d / "3.pt").write_bytes(b"")
    assert tckpt.resume_point(str(d)) == ("orbax", 4)
    assert tckpt.pick_checkpoint(str(d / "2")) == ("orbax", None)
    with pytest.raises(FileNotFoundError):
        tckpt.pick_checkpoint(str(tmp_path / "none"))


# -- the CLIs ---------------------------------------------------------------------------------------
def _grab(name):
    logs = []

    class Grab(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    log = logging.getLogger(name)
    h = Grab()
    log.addHandler(h)
    log.setLevel(logging.INFO)
    return logs, lambda: log.removeHandler(h)


def test_restoration_cli_resumes_the_fixture_then_its_own_file(tmp_path):
    rng = np.random.RandomState(0)
    for sub in ("GT", "LQ"):
        (tmp_path / "md" / "noisy" / sub).mkdir(parents=True)
        for i in range(4):
            png.write(str(tmp_path / "md" / "noisy" / sub / f"{i}.png"),
                      (rng.rand(32, 32, 3) * 255).astype(np.uint8))
    ts = tmp_path / "out" / "experiments" / "resume" / "training_state"
    shutil.copytree(FIXTURE / "restoration", ts)
    yml = tmp_path / "train.yml"
    yml.write_text(textwrap.dedent(f"""
        name: resume
        model: denoising
        distortion: [noisy]
        gpu_ids: [0]
        sde: {{max_sigma: 50, T: 100, schedule: cosine, eps: 0.005}}
        datasets:
          train: {{name: T, mode: MD, dataroot: {tmp_path / 'md'}, batch_size: 2,
                   patch_size: 16, use_shuffle: true, n_workers: 0, use_flip: true,
                   use_rot: true, clip_size: 32}}
        network_G:
          which_model_G: ConditionalUNet
          setting: {{in_nc: 3, out_nc: 3, nf: 16, ch_mult: [1, 2], context_dim: 32,
                     use_degra_context: true, use_image_context: true}}
        path: {{pretrain_model_G: ~, root: {tmp_path / 'out'}, daclip: {FIXTURE / 'daclip'},
                daclip_model: {MODEL}}}
        train: {{optimizer: AdamW, lr_G: !!float 1e-4, lr_scheme: TrueCosineAnnealingLR,
                 beta1: 0.9, beta2: 0.99, niter: 4, warmup_iter: -1, eta_min: !!float 1e-6,
                 loss_type: l1, weight: 1.0, manual_seed: 0, val_freq: 1000}}
        logger: {{print_freq: 2, save_checkpoint_freq: 1000}}
    """))
    logs, done = _grab("train")
    try:
        first = tcli_resto.main(["-opt", str(yml), "--max-steps", "6", "--device", "cpu"])
        n_first = len(logs)
        second = tcli_resto.main(["-opt", str(yml), "--max-steps", "6", "--device", "cpu"])
    finally:
        done()
    assert "resumed from step 4" in logs[:n_first] and "resumed from step 6" in logs[n_first:]
    assert any(m.startswith("resumed from daclip_tpu's orbax step dir") and
               m.endswith(os.path.join("training_state", "4")) for m in logs[:n_first])
    assert any(m.startswith("resumed from the port's") and m.endswith("6.pt")
               for m in logs[n_first:])
    assert first["final_step"] == second["final_step"] == 6
    assert tckpt.steps(str(ts)) == [6]
    saved = torch.load(tckpt.checkpoint_path(str(ts), 6), weights_only=False)
    assert saved["step"] == 6 and saved["ema_step"] == 6
    assert all(float(st["step"]) == 6 for st in saved["opt_state"]["state"].values())


def test_daclip_cli_resume_latest_starts_at_the_fixtures_epoch(tmp_path):
    ckpts = tmp_path / "logs" / "run" / "checkpoints"
    shutil.copytree(FIXTURE / "daclip" / "1", ckpts / "1")
    argv = ["--dataset-type", "synthetic", "--train-num-samples", "8", "--batch-size", "4",
            "--epochs", "2", "--warmup", "1", "--model", MODEL, "--logs", str(tmp_path / "logs"),
            "--name", "run", "--precision", "fp32", "--seed", "0", "--workers", "0",
            "--device", "cpu", "--resume", "latest"]
    logs, done = _grab("daclip")
    try:
        out = tcli_daclip.main(argv)
    finally:
        done()
    assert any("epoch 1 (daclip_tpu's orbax step dir)" in m for m in logs), logs
    assert np.isfinite(out["best_loss"])
    assert tckpt.steps(str(ckpts), tckpt.EPOCH) == [2]
    saved = torch.load(tckpt.checkpoint_path(str(ckpts), 2, tckpt.EPOCH), weights_only=False)
    assert (saved["epoch"], saved["step"]) == (2, 4)  # the fixture's 2 steps, then 2 more
    # and a step dir given as --resume
    with pytest.raises(FileNotFoundError):
        tcli_daclip.main(argv[:-1] + [str(tmp_path / "nowhere")])
