"""The port's orbax train dirs restored by daclip_tpu: `utils/orbax_writer.py`
against daclip_tpu's own `save_checkpoint` on one tree, the port's training
states (every restoration optimizer layout, DaCLIP, plain CLIP) written by
`utils/checkpoint` and the two train CLIs and restored by daclip_tpu's
`restore_checkpoint` with the target its CLIs build, bit for bit against
the port's `.pt` of the same step through the weight maps; daclip_tpu's
restoration CLI resuming a port run and the port resuming it back; the
round trip daclip_tpu → port → daclip_tpu; the weight maps walked both ways;
async saves, `max_to_keep` over both packages' dirs, failed writes and
refusals.

Everything runs on the CPU; nothing here needs the card.
"""
import functools
import json
import logging
import os
import pathlib
import shutil
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from daclip_torch import parallel
from daclip_torch.cli import train_daclip as tcli_daclip
from daclip_torch.cli import train_restoration as tcli_resto
from daclip_torch.convert import (clip_state_dict_from_jax, clip_state_dict_to_jax,
                                  daclip_state_dict_from_jax, daclip_state_dict_to_jax,
                                  daclip_trainable_state_dict_from_jax,
                                  daclip_trainable_state_dict_to_jax,
                                  unet_state_dict_from_jax, unet_state_dict_to_jax)
from daclip_torch.data import png
from daclip_torch.factory import create_model
from daclip_torch.models.unet import ConditionalUNet as TorchUNet
from daclip_torch.train import clip_train as tclip
from daclip_torch.train import restoration as trest
from daclip_torch.utils import checkpoint as tckpt
from daclip_torch.utils import native_checkpoint as nc
from daclip_torch.utils import orbax_reader, orbax_writer
from daclip_tpu.cli import train_restoration as jcli_resto
from daclip_tpu.factory import create_model as jcreate_model
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
from daclip_tpu.train import clip_train as jclip
from daclip_tpu.train import restoration as jrest
from daclip_tpu.utils import checkpoint as jckpt
from tests.test_torch_unet import _seeded_params

torch.set_num_threads(1)
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "orbax"
# the production UNet's layout at narrow width: every level, both contexts,
# the SpatialTransformers at level 3 and in the middle
KW = dict(nf=8, ch_mult=(1, 2, 4, 8), context_dim=32, use_degra_context=True,
          use_image_context=True)
SMALL = dict(nf=16, ch_mult=(1, 2), context_dim=32, use_degra_context=True,
             use_image_context=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_args(kw):
    x = np.zeros((1, 16, 16, 3), np.float32)
    ctx = np.zeros((1, kw["context_dim"]), np.float32)
    return x, x, np.ones((1,), np.float32), ctx, ctx


def _assert_same(got, want, path="tree"):
    """Nested dicts / lists / arrays equal bit for bit, dtypes included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}.{i}")
    elif want is None or isinstance(want, (int, float)):
        assert got == want and type(got) is type(want), (path, got, want)
    elif torch.is_tensor(want):
        assert torch.is_tensor(got) and got.dtype == want.dtype and torch.equal(got, want), path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), path


def _moments(opt_state):
    """(count, mu, nu | None) of an optax chain's scale_by_adam / lion state."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return int(found[0].count), found[0].mu, getattr(found[0], "nu", None)


def _counts(opt_state):
    return [int(x) for p, x in jax.tree_util.tree_leaves_with_path(opt_state)
            if getattr(p[-1], "name", None) == "count"]


# -- the writer against daclip_tpu's save_checkpoint ---------------------------------------------
def test_one_tree_written_by_either_package_restores_alike(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"w": rng.randn(3, 4, 2, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32),
              "h": rng.randn(2, 3).astype(np.float32), "n": np.arange(6, dtype=np.int32)}

    def build(arr, count):
        return {"params": {"w": arr(arrays["w"]), "b": arr(arrays["b"]), "n": arr(arrays["n"]),
                           "half": arr(arrays["h"], bf16=True)},
                "opt_state": [None, {"count": count(5), "mu": {"w": arr(arrays["w"] * 2)}},
                              {"inner_state": None}],
                "frozen": {}, "seq": [], "epoch": 3, "lr": 0.25, "step": count(9)}

    jtree = build(lambda a, bf16=False: jnp.asarray(a, jnp.bfloat16 if bf16 else None),
                  lambda n: jnp.asarray(n, jnp.int32))
    ttree = build(lambda a, bf16=False: torch.from_numpy(a).to(torch.bfloat16 if bf16 else None),
                  lambda n: torch.tensor(n, dtype=torch.int32))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jtree)
    orbax_writer.save_checkpoint(str(tmp_path / "port"), 2, ttree)
    want = jckpt.restore_checkpoint(str(tmp_path / "jax"), 2)
    got = jckpt.restore_checkpoint(str(tmp_path / "port"), 2)
    _assert_same(_np(got), _np(want))
    # with a target: the optax EmptyState and tuples of the target's structure
    target = dict(jtree, opt_state=(optax.EmptyState(), jtree["opt_state"][1],
                                    jtree["opt_state"][2]))
    _assert_same(_np(jckpt.restore_checkpoint(str(tmp_path / "port"), 2, target=target)),
                 _np(jckpt.restore_checkpoint(str(tmp_path / "jax"), 2, target=target)))
    # the same metadata, leaf for leaf; the port's reader reads both alike
    meta = [json.load(open(tmp_path / d / "2" / "default" / "_METADATA")) for d in ("jax", "port")]
    assert meta[0]["tree_metadata"] == meta[1]["tree_metadata"]
    assert {k: v for k, v in meta[0].items() if k != "tree_metadata"} == \
        {k: v for k, v in meta[1].items() if k != "tree_metadata"}
    arrays_meta = [json.load(open(tmp_path / d / "2" / "default" / "array_metadatas" /
                                  "process_0"))["array_metadatas"] for d in ("jax", "port")]
    assert sorted(map(json.dumps, arrays_meta[0])) == sorted(map(json.dumps, arrays_meta[1]))
    a = orbax_reader.restore_checkpoint(str(tmp_path / "jax"))
    b = orbax_reader.restore_checkpoint(str(tmp_path / "port"))
    _assert_same({k: v for k, v in b.items()}, a)
    # one data file, one manifest, no per-process store
    names = sorted(os.listdir(tmp_path / "port" / "2" / "default"))
    assert names == ["_METADATA", "_sharding", "array_metadatas", "d", "manifest.ocdbt"]
    assert len(os.listdir(tmp_path / "port" / "2" / "default" / "d")) == 1


# -- the restoration state in each optimizer layout ---------------------------------------------
RESTO = {"adam": dict(optimizer="Adam"), "adamw": dict(optimizer="AdamW"),
         "lion": dict(optimizer="Lion", lr_G=3e-5),
         "adam_clip": dict(optimizer="Adam", grad_clip=1.0),
         "adamw_clip": dict(optimizer="AdamW", grad_clip=1.0, weight_decay_G=0.01),
         "lion_clip": dict(optimizer="Lion", lr_G=3e-5, grad_clip=0.5)}


def _no_grad(name):
    """A parameter the port's UNet never gives a gradient (a one-token
    cross-attention's to_q, to_k and norm2)."""
    return ".attn2.to_q." in name or ".attn2.to_k." in name or ".norm2." in name


def _port_resto_state(kw, tcfg, steps=2):
    """The port's UNet and TrainState after `steps` updates from seeded
    gradients (none where the UNet gives none), on the CPU."""
    torch.manual_seed(0)
    unet = TorchUNet(**kw)
    state = trest.init_state(unet, tcfg, device="cpu")
    schedule = trest.make_schedule(tcfg)
    g = torch.Generator().manual_seed(1)
    for _ in range(steps):
        for name, p in trest.trainable(unet):
            p.grad = None if _no_grad(name) else torch.randn(p.shape, generator=g) * 0.1
        trest.apply_gradients(state, unet, tcfg, schedule)
    return unet, state


def _jax_resto_target(kw, jcfg):
    """What daclip_tpu's restoration CLI restores into: `init_state` of its
    own UNet's `init` tree (zeros of its structure)."""
    shapes = jax.eval_shape(JaxUNet(dtype=jnp.float32, **kw).init, jax.random.PRNGKey(0),
                            *_jax_args(kw))
    return jrest.init_state(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), jcfg)


def _assert_resto_equals_pt(want, pt, index, depth):
    """daclip_tpu's restored TrainState against the port's `.pt` payload,
    bit for bit through the map: params, EMA, moments (zeros where the port
    keeps no state), counts and steps."""
    conv = lambda t: unet_state_dict_from_jax(nc._unwrap_flax(_np(t)), depth)
    for got, sd in ((conv(want.params), pt["params"]), (conv(want.ema.params), pt["params_ema"])):
        assert set(got) == set(sd)
        for k, v in sd.items():
            if not k.endswith("attn2.to_q.weight"):  # daclip_tpu has none: zeros by the map
                assert torch.equal(got[k], v), k
    assert int(want.step) == pt["step"] and int(want.ema.step) == pt["ema_step"]
    count, mu, nu = _moments(want.opt_state)
    assert _counts(want.opt_state) == [pt["step"]] * 2 and count == pt["step"]
    state = pt["opt_state"]["state"]
    for conv_m, field in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
        if conv_m is None:
            assert all(set(st) == {"exp_avg"} for st in state.values())
            continue
        m = conv(conv_m)
        for name, i in index.items():
            if i in state:
                assert torch.equal(m[name], state[i][field]), name
            else:
                assert _no_grad(name) and not torch.count_nonzero(m[name]), name


@pytest.mark.parametrize("layout", sorted(RESTO))
def test_restoration_layouts_restore_in_daclip_tpu(tmp_path, layout):
    kw = dict(RESTO[layout], niter=500, ema_update_every=1)
    tcfg, jcfg = trest.RestorationTrainConfig(**kw), jrest.RestorationTrainConfig(**kw)
    unet, state = _port_resto_state(KW, tcfg)
    d = str(tmp_path / "ts")
    tckpt.save_checkpoint(d, unet, state, cfg=tcfg)
    assert sorted(os.listdir(d)) == ["2", "2.pt"]
    pt = torch.load(tckpt.checkpoint_path(d, 2), weights_only=False)
    want = jckpt.restore_checkpoint(d, 2, target=_jax_resto_target(KW, jcfg))
    assert type(want).__name__ == "TrainState"
    index = parallel.optimizer_layout(unet, state.optimizer)[0]
    assert sum(map(_no_grad, index)) == 12  # to_q, to_k, norm2 of down3, mid, up3
    _assert_resto_equals_pt(want, pt, index, 4)
    # the port's reader reads it back: the payload, but the dropped to_q
    back = nc.load_restoration_train_state(d, cfg=tcfg, unet=unet, optimizer=state.optimizer)
    for key in ("params", "params_ema"):
        for k, v in pt[key].items():
            assert torch.equal(back[key][k], v if "attn2.to_q" not in k else 0 * v), k
    assert back["opt_state"]["state"].keys() == pt["opt_state"]["state"].keys()
    for i, st in pt["opt_state"]["state"].items():
        for f, v in st.items():
            assert torch.equal(back["opt_state"]["state"][i][f], v), (i, f)
    # a fresh state restored from the step dir is the one restored from the .pt
    states = []
    for path in (os.path.join(d, "2"), tckpt.checkpoint_path(d, 2)):
        u = TorchUNet(**KW)
        s = trest.init_state(u, tcfg, device="cpu")
        tckpt.restore_checkpoint(path, u, s, cfg=tcfg)
        states.append((u.state_dict(), s))
    for k, v in states[1][0].items():
        if "attn2.to_q" not in k:
            assert torch.equal(states[0][0][k], v), k
    assert states[0][1].step == states[1][1].step == 2
    assert tckpt.pick_checkpoint(d) == ("pt", 2)  # the .pt on a tie


def _md_tree(root, n=4, size=32):
    rng = np.random.RandomState(0)
    for sub in ("GT", "LQ"):
        (root / "noisy" / sub).mkdir(parents=True)
        for i in range(n):
            png.write(str(root / "noisy" / sub / f"{i}.png"),
                      (rng.rand(size, size, 3) * 255).astype(np.uint8))


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


def test_daclip_tpu_resumes_a_port_run_and_the_port_resumes_it_back(tmp_path):
    """One options file: the port trains 2 steps (step dirs written in the
    loop, in the background, and at the end); daclip_tpu's CLI logs
    "resumed from step 2" and trains step 3; the port resumes daclip_tpu's
    step dir 3 and trains step 4."""
    _md_tree(tmp_path / "md")
    yml = tmp_path / "train.yml"
    yml.write_text(textwrap.dedent(f"""
        name: cross
        model: denoising
        distortion: [noisy]
        gpu_ids: [0]
        sde: {{max_sigma: 50, T: 100, schedule: cosine, eps: 0.005}}
        datasets:
          train: {{name: T, mode: MD, dataroot: {tmp_path / 'md'}, batch_size: 2,
                   patch_size: 16, use_shuffle: true, n_workers: 0, use_flip: true,
                   use_rot: true}}
        network_G:
          which_model_G: ConditionalUNet
          setting: {{in_nc: 3, out_nc: 3, nf: 16, ch_mult: [1, 2], context_dim: ~,
                     use_degra_context: false, use_image_context: false}}
        path: {{pretrain_model_G: ~, root: {tmp_path / 'out'}}}
        train: {{optimizer: AdamW, lr_G: !!float 1e-4, lr_scheme: TrueCosineAnnealingLR,
                 beta1: 0.9, beta2: 0.99, niter: 4, warmup_iter: -1, eta_min: !!float 1e-6,
                 loss_type: l1, weight: 1.0, manual_seed: 0, val_freq: 1000}}
        logger: {{print_freq: 1, save_checkpoint_freq: 1}}
    """))
    ts = tmp_path / "out" / "experiments" / "cross" / "training_state"
    logs, done = _grab("train")
    try:
        first = tcli_resto.main(["-opt", str(yml), "--max-steps", "2", "--device", "cpu"])
        n1 = len(logs)
        assert sorted(os.listdir(ts)) == ["1", "1.pt", "2", "2.pt"]
        jax_out = jcli_resto.main(["-opt", str(yml), "--max-steps", "3"])
        n2 = len(logs)
        third = tcli_resto.main(["-opt", str(yml), "--max-steps", "4", "--device", "cpu"])
    finally:
        done()
    assert first["final_step"] == 2 and jax_out["final_step"] == 3 and third["final_step"] == 4
    assert any(m.startswith("saving checkpoint @ 1 (async)") for m in logs[:n1])
    assert "resumed from step 2" in logs[n1:n2]
    assert any(m.startswith("step 3 loss") for m in logs[n1:n2])  # it ran step 3
    assert "resumed from step 3" in logs[n2:]
    assert any(m.startswith("resumed from daclip_tpu's orbax step dir") and m.endswith(
        os.path.join("training_state", "3")) for m in logs[n2:])
    assert orbax_reader.step_dirs(str(ts)) == [1, 2, 3, 4] and tckpt.steps(str(ts)) == [1, 2, 4]


# -- DA-CLIP and plain CLIP, through the CLI ---------------------------------------------------
def _daclip_target(model_name, jcfg):
    """The exact target daclip_tpu's `cli/train_daclip.py:322-325` restores."""
    model, params = jcreate_model(model_name, use_predictor="daclip" in model_name)[:2]
    if "daclip" in model_name:
        trainable, frozen = jclip.partition_daclip_params(params)
    else:
        trainable, frozen = dict(params), {}
    state = jclip.init_state(trainable, jcfg)
    return {"params": state.params, "opt_state": state.opt_state, "step": state.step,
            "frozen": frozen, "epoch": 0}


@pytest.mark.parametrize("model_name,clip_norm", [("daclip_test-tiny", None),
                                                  ("test-tiny", 1.0)])
def test_daclip_cli_dirs_restore_in_daclip_tpu(tmp_path, model_name, clip_norm):
    argv = ["--dataset-type", "synthetic", "--train-num-samples", "8", "--batch-size", "4",
            "--epochs", "1", "--warmup", "1", "--model", model_name, "--logs",
            str(tmp_path / "logs"), "--name", "run", "--precision", "fp32", "--seed", "0",
            "--workers", "0", "--device", "cpu"]
    if clip_norm:
        argv += ["--grad-clip-norm", str(clip_norm)]
    tcli_daclip.main(argv)
    ckpts = tmp_path / "logs" / "run" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["1", "best", "epoch_1.pt"]
    assert sorted(os.listdir(ckpts / "best")) == ["1", "epoch_1.pt"]
    pt = torch.load(tckpt.checkpoint_path(str(ckpts), 1, tckpt.EPOCH), weights_only=False)
    jcfg = jclip.ClipTrainConfig(grad_clip_norm=clip_norm)
    want = jckpt.restore_checkpoint(str(ckpts), 1, target=_daclip_target(model_name, jcfg))
    assert (int(want["step"]), int(want["epoch"])) == (pt["step"], 1) == (2, 1)
    daclip = "daclip" in model_name
    sd = (daclip_state_dict_from_jax({**_np(want["params"]), **_np(want["frozen"])}) if daclip
          else clip_state_dict_from_jax(_np(want["params"])))
    assert set(sd) == set(pt["state_dict"])
    for k, v in pt["state_dict"].items():
        assert torch.equal(sd[k], v), k
    assert set(want["frozen"]) == ({"clip"} if daclip else set())
    count, mu, nu = _moments(want["opt_state"])
    assert _counts(want["opt_state"]) == [2, 2]
    conv = daclip_trainable_state_dict_from_jax if daclip else clip_state_dict_from_jax
    model = create_model(model_name, use_predictor=daclip or None)
    named = [(n, p) for n, p in model.named_parameters() if not (daclip and n.startswith("clip."))]
    optimizer = tclip.make_optimizer(named, tclip.ClipTrainConfig())
    index = parallel.optimizer_layout(model, optimizer)[0]
    state = pt["optimizer"]["state"]
    assert set(state) == set(index.values())
    for m, field in ((conv(_np(mu)), "exp_avg"), (conv(_np(nu)), "exp_avg_sq")):
        for name, i in index.items():
            assert torch.equal(m[name], state[i][field]), name
    # the port resumes the step dir into what the .pt gives
    models = []
    for path in (ckpts / "1", ckpts / "epoch_1.pt"):
        m = create_model(model_name, use_predictor=daclip or None, seed=7)
        tcfg = tclip.ClipTrainConfig(grad_clip_norm=clip_norm)
        s = tclip.init_state(m, tcfg, device="cpu")
        assert tckpt.restore_clip_checkpoint(str(path), m, s, cfg=tcfg) == 1
        models.append((m.state_dict(), s))
    for k, v in models[1][0].items():
        assert torch.equal(models[0][0][k], v), k
    assert models[0][1].step == models[1][1].step == 2


# -- daclip_tpu → port → daclip_tpu -----------------------------------------------------------
def test_a_daclip_tpu_dir_read_and_written_back_by_the_port_is_the_same(tmp_path):
    for src, step, load, save in (
            ("restoration", 4,
             lambda d: nc.load_restoration_train_state(d, cfg=trest.RestorationTrainConfig(
                 optimizer="AdamW", lr_G=1e-4, niter=4, eta_min=1e-6)),
             lambda d, p: nc.save_restoration_train_state(d, p, trest.RestorationTrainConfig())),
            ("daclip", 1,
             lambda d: nc.load_daclip_train_state(d, create_model("daclip_test-tiny",
                                                                  use_predictor=True)),
             lambda d, p: nc.save_daclip_train_state(
                 d, p, create_model("daclip_test-tiny", use_predictor=True),
                 tclip.ClipTrainConfig()))):
        orig = str(FIXTURE / src)
        payload = load(orig)
        out = str(tmp_path / src)
        assert save(out, payload) == os.path.join(out, str(step))
        _assert_same(_np(jckpt.restore_checkpoint(out, step)),
                     _np(jckpt.restore_checkpoint(orig, step)))


# -- async saves, max_to_keep, failures ----------------------------------------------------------
def test_async_saves_leave_finished_dirs_and_keep_what_orbax_keeps(tmp_path):
    tree = lambda n: {"w": torch.full((64, 64), float(n)),  # noqa: E731
                      "step": torch.tensor(n, dtype=torch.int32)}
    jtree = lambda n: {"w": jnp.full((64, 64), float(n)), "step": jnp.asarray(n, jnp.int32)}
    port, ref = tmp_path / "port", tmp_path / "ref"
    for d in (port, ref):
        shutil.copytree(FIXTURE / "restoration", d)  # daclip_tpu's steps 2 and 4
        (d / "7.pt").write_bytes(b"")  # the port's files are no step dirs
    for n in (5, 6, 8, 9, 3):
        orbax_writer.save_checkpoint(str(port), n, tree(n), max_to_keep=3, wait=False)
        jckpt.save_checkpoint(str(ref), n, jtree(n), max_to_keep=3)
    orbax_writer.wait_all()
    assert orbax_reader.step_dirs(str(port)) == orbax_reader.step_dirs(str(ref)) == [6, 8, 9]
    assert sorted(os.listdir(port)) == ["6", "7.pt", "8", "9"]  # no temporary dir left
    # an unfinished save (its temporary dir) is no step for either package
    (port / f"12{orbax_writer.TMP_SUFFIX}1").mkdir()
    assert jckpt.latest_step(str(port)) == orbax_reader.latest_step(str(port)) == 9
    got = jckpt.restore_checkpoint(str(port), 9)
    assert float(got["w"][0, 0]) == 9.0 and int(got["step"]) == 9
    # a step at or before the latest is skipped, as orbax's manager skips it
    orbax_writer.save_checkpoint(str(port), 9, tree(99))
    assert float(jckpt.restore_checkpoint(str(port), 9)["w"][0, 0]) == 9.0


def _record_pid(path, tree):
    pathlib.Path(path).write_text(str(os.getpid()))
    return tree


def _fail_unpicklably(tree):
    class Local(Exception):  # a local class: its instances do not pickle
        pass
    raise Local("the build failed")


def _die(tree):
    os._exit(3)


def test_an_async_write_runs_in_the_writer_process_and_its_failures_come_back(tmp_path):
    """`wait=False` builds and writes in the writer process (no interpreter
    lock shared with the caller; `start_writer` starts it ahead), `wait=True`
    in this one; a build that does
    not pickle is refused at the call; an exception that does not pickle,
    and a writer process that dies, still raise here, and the next save
    starts a new writer process."""
    d = str(tmp_path / "d")
    orbax_writer.start_writer(("json",))  # ahead of the first save; then a no-op
    pid = orbax_writer._process.proc.pid
    orbax_writer.start_writer()
    orbax_writer.save_checkpoint(d, 1, {"x": torch.ones(3)}, wait=False,
                                 build=functools.partial(_record_pid, tmp_path / "a"))
    orbax_writer.save_checkpoint(d, 2, {"x": torch.ones(3)},
                                 build=functools.partial(_record_pid, tmp_path / "s"))
    orbax_writer.wait_all()
    assert int((tmp_path / "a").read_text()) == pid == orbax_writer._process.proc.pid
    assert pid != os.getpid()
    assert int((tmp_path / "s").read_text()) == os.getpid()
    assert orbax_reader.step_dirs(d) == [1, 2]
    with pytest.raises(TypeError, match="must pickle"):
        orbax_writer.save_checkpoint(d, 3, {"x": 1.0}, wait=False, build=lambda t: t)

    orbax_writer.save_checkpoint(d, 3, {"x": 1.0}, wait=False, build=_fail_unpicklably)
    with pytest.raises(RuntimeError, match="(?s)writing .*3 failed.*the build failed"):
        orbax_writer.wait_all()
    orbax_writer.save_checkpoint(d, 4, {"x": 1.0}, wait=False, build=_die)
    with pytest.raises(RuntimeError, match="ended with status 3 and no result"):
        orbax_writer.wait_all()
    assert orbax_reader.step_dirs(d) == [1, 2] and sorted(os.listdir(d)) == ["1", "2"]
    orbax_writer.save_checkpoint(d, 5, {"x": torch.full((2,), 5.0)}, wait=False)
    orbax_writer.wait_all()
    assert float(orbax_reader.restore_checkpoint(d, 5)["x"][1]) == 5.0


def test_a_failed_write_raises_at_the_next_save_and_at_wait_all(tmp_path):
    d = str(tmp_path / "f")
    orbax_writer.save_checkpoint(d, 1, {"bad": "a string"}, wait=False)
    with pytest.raises(TypeError, match="bad: a leaf of type str"):
        orbax_writer.wait_all()
    orbax_writer.save_checkpoint(d, 2, {"bad": object()}, wait=False)
    pending, deadline = orbax_writer._writers[os.path.abspath(d)].pending, time.time() + 60
    while not all(f.done() for f in pending) and time.time() < deadline:
        time.sleep(0.01)
    assert all(f.done() for f in pending)
    with pytest.raises(TypeError, match="bad: a leaf of type object"):
        orbax_writer.save_checkpoint(str(tmp_path / "g"), 1, {"x": 1.0}, wait=False)
    orbax_writer.wait_all()
    assert orbax_reader.step_dirs(d) == [] and os.listdir(d) == []
    assert orbax_reader.step_dirs(str(tmp_path / "g")) == []  # refused before it was queued


def test_saves_from_several_threads_land_whole(tmp_path):
    """Eight threads each queue async saves into three shared directories,
    the interpreter switching threads every microsecond: every directory
    ends with its newest steps, each whole and holding its own step."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for k in range(6):
                n = 100 * k + t
                orbax_writer.save_checkpoint(str(tmp_path / f"d{n % 3}"), n,
                                             {"v": torch.full((8,), float(n))},
                                             max_to_keep=2, wait=False)
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        orbax_writer.wait_all()
    finally:
        sys.setswitchinterval(switch)
    for i in range(3):
        d = str(tmp_path / f"d{i}")
        steps = orbax_reader.step_dirs(d)
        assert len(steps) == 2 and not [e for e in os.listdir(d) if "tmp" in e]
        for n in steps:
            assert float(orbax_reader.restore_checkpoint(d, n)["v"][0]) == n


# -- refusals ------------------------------------------------------------------------------------
def test_the_writers_refuse_what_the_readers_refuse(tmp_path):
    model = create_model("daclip_test-tiny", use_predictor=True)
    state = tclip.init_state(model, tclip.ClipTrainConfig(), device="cpu")
    for cfg, why in ((tclip.ClipTrainConfig(accum_freq=2), "MultiSteps"),
                     (tclip.ClipTrainConfig(skip_scheduler=True), "no schedule count")):
        assert why in nc.clip_chain_refusal(cfg)
        with pytest.raises(ValueError, match=why):
            tckpt.save_clip_checkpoint(str(tmp_path / "a"), model, state, 1, cfg=cfg)
    coca = create_model("coca_test-tiny")
    for call in (lambda: nc.daclip_train_tree({}, coca, tclip.ClipTrainConfig()),
                 lambda: nc.load_daclip_train_state(str(FIXTURE / "daclip"), coca)):
        with pytest.raises(ValueError, match="mapped for a DaCLIP or a CLIP; the model is a CoCa"):
            call()
    with pytest.raises(ValueError, match="unknown optimizer 'SGD'"):
        nc.save_restoration_train_state(str(tmp_path / "b"), {"step": 1},
                                        trest.RestorationTrainConfig(optimizer="SGD"))
    # a state dict that is not the map's layout is refused by name
    sd = dict(TorchUNet(**SMALL).state_dict(), extra=torch.zeros(1))
    with pytest.raises(ValueError, match=r"moves no JAX leaf to \['extra'\]"):
        unet_state_dict_to_jax(sd)
    # a CLIP dir is not a DaCLIP's, nor the other way
    with pytest.raises(ValueError, match="is a DA-CLIP's"):
        nc.load_daclip_train_state(str(FIXTURE / "daclip"), create_model("test-tiny"))
    assert not os.path.exists(tmp_path / "a" / "1") and not os.path.exists(tmp_path / "b")


# -- plain CLIP written by daclip_tpu, resumed by the port ----------------------------------------
def test_the_port_resumes_daclip_tpu_s_plain_clip_dirs(tmp_path):
    jcfg = jclip.ClipTrainConfig(grad_clip_norm=1.0)
    target = _daclip_target("test-tiny", jcfg)
    tx = jclip.make_optimizer(jcfg, None)
    params, opt_state = target["params"], target["opt_state"]
    for k in range(2):
        rng = np.random.RandomState(40 + k)
        g = jax.tree.map(lambda p: jnp.asarray(np.asarray(rng.randn(*np.shape(p)), np.float32)),
                         params)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    jckpt.save_checkpoint(str(tmp_path / "c"), 2, {
        "params": params, "opt_state": opt_state, "step": jnp.asarray(2, jnp.int32),
        "frozen": {}, "epoch": 2})
    want = jckpt.restore_checkpoint(str(tmp_path / "c"), 2, target=dict(target))
    tcfg = tclip.ClipTrainConfig(grad_clip_norm=1.0)
    model = create_model("test-tiny", seed=3)
    state = tclip.init_state(model, tcfg, device="cpu")
    assert tckpt.restore_clip_checkpoint(str(tmp_path / "c"), model, state, cfg=tcfg) == 2
    assert state.step == 2
    sd = clip_state_dict_from_jax(_np(want["params"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    _, mu, nu = _moments(want["opt_state"])
    mu, nu = clip_state_dict_from_jax(_np(mu)), clip_state_dict_from_jax(_np(nu))
    for name, p in model.named_parameters():
        st = state.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert float(st["step"]) == 2


# -- the weight maps, both ways ------------------------------------------------------------------
def _jax_tree(name):
    """A seeded tree of daclip_tpu's structure for `name`."""
    if name in ("unet_small", "unet_production_layout"):
        kw = SMALL if name == "unet_small" else KW
        return _np(_seeded_params(JaxUNet(dtype=jnp.float32, **kw), _jax_args(kw), seed=4))
    params = jcreate_model(name, use_predictor="daclip" in name)[1]
    rng = np.random.RandomState(5)
    return jax.tree.map(lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32), params)


@pytest.mark.parametrize("name", ["unet_small", "unet_production_layout", "daclip_test-tiny",
                                  "test-tiny"])
def test_the_weight_maps_walk_back_bit_for_bit(name):
    tree = _jax_tree(name)
    if name.startswith("unet"):
        depth = len((SMALL if name == "unet_small" else KW)["ch_mult"])
        maps = [(lambda t: unet_state_dict_from_jax(t, depth), unet_state_dict_to_jax, tree)]
        model = TorchUNet(**(SMALL if name == "unet_small" else KW))
    elif name.startswith("daclip"):
        trainable = {k: v for k, v in tree.items() if k != "clip"}
        maps = [(daclip_state_dict_from_jax, daclip_state_dict_to_jax, tree),
                (daclip_trainable_state_dict_from_jax, daclip_trainable_state_dict_to_jax,
                 trainable)]
        model = create_model(name, use_predictor=True)
    else:
        maps = [(clip_state_dict_from_jax, clip_state_dict_to_jax, tree)]
        model = create_model(name)
    for from_jax, to_jax, t in maps:
        _assert_same(to_jax(from_jax(t)), t)
    # the port's own state dict (to_q random, not the map's zeros) and back
    from_jax, to_jax, _ = maps[0]
    sd = model.state_dict()
    dropped = set()
    back = from_jax(to_jax(sd, dropped=dropped) if name.startswith("unet") else to_jax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], torch.zeros_like(v) if k in dropped else v), k
    assert all(k.endswith("attn2.to_q.weight") for k in dropped)
    assert len(dropped) == (0 if not name.startswith("unet") else 1 if name == "unet_small" else 3)
