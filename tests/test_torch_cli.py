"""daclip_torch's restoration CLIs on the CPU: train from an options file and
resume, the config they build against daclip_tpu's CLI, the first batches
against daclip_tpu's loaders, evaluation of the saved EMA UNet, the device
and --mesh refusals, train-dir checkpoints, and a restore from PNG with cv2
hidden."""
import builtins
import logging
import os
import pathlib
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from daclip_torch import config as tcfg
from daclip_torch import pipeline as tpipe
from daclip_torch.cli import test_restoration as t_test
from daclip_torch.cli import train_restoration as t_train
from daclip_torch.data import png
from daclip_torch.utils import checkpoint as tckpt
from daclip_tpu import config as jcfg
from daclip_tpu.utils import metrics as jmetrics

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "parity" / "fixtures" / "e2e"

# tests/test_cli.py's tiny options
TRAIN_YML = """
name: smoke-test
model: denoising
distortion: [noisy]
gpu_ids: [0]
sde:
  max_sigma: 50
  T: 100
  schedule: cosine
  eps: 0.005
datasets:
  train:
    name: T
    mode: MD
    dataroot: {root}
    batch_size: 2
    patch_size: 16
    use_shuffle: true
    n_workers: 0
    use_flip: true
    use_rot: true
  val:
    name: V
    mode: MD
    dataroot: {root}
network_G:
  which_model_G: ConditionalUNet
  setting:
    in_nc: 3
    out_nc: 3
    nf: 16
    ch_mult: [1, 2]
    context_dim: ~
    use_degra_context: false
    use_image_context: false
path:
  pretrain_model_G: ~
  root: {out}
train:
  optimizer: AdamW
  lr_G: !!float 1e-4
  lr_scheme: TrueCosineAnnealingLR
  beta1: 0.9
  beta2: 0.99
  niter: 4
  warmup_iter: -1
  eta_min: !!float 1e-6
  loss_type: l1
  weight: 1.0
  manual_seed: 0
  val_freq: 4
logger:
  print_freq: 2
  save_checkpoint_freq: 4
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A one-type MD tree of 4 pairs at 32², written by the port's PNG
    encoder, an LQGT pair of folders of 2 at 32², and the options files."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    for sub in ("GT", "LQ"):
        (root / "md" / "noisy" / sub).mkdir(parents=True)
        (root / "lqgt" / sub).mkdir(parents=True)
        for i in range(4):
            png.write(str(root / "md" / "noisy" / sub / f"{i}.png"),
                      (rng.rand(32, 32, 3) * 255).astype(np.uint8), ("up", "paeth")[i % 2])
        for i in range(2):
            png.write(str(root / "lqgt" / sub / f"{i}.png"),
                      (rng.rand(32, 32, 3) * 255).astype(np.uint8))
    train = root / "train.yml"
    train.write_text(TRAIN_YML.format(root=root / "md", out=root / "out"))
    test = root / "test.yml"
    test.write_text(textwrap.dedent(f"""
        name: smoke-test
        sde: {{max_sigma: 50, T: 4, schedule: cosine, eps: 0.005}}
        datasets:
          test1: {{name: Test, mode: LQGT, dataroot_GT: {root / 'lqgt' / 'GT'},
                   dataroot_LQ: {root / 'lqgt' / 'LQ'}}}
        network_G:
          setting: {{nf: 16, ch_mult: [1, 2], context_dim: ~, use_degra_context: false,
                     use_image_context: false}}
        path: {{pretrain_model_G: ~, daclip: ~, root: {root / 'out'}}}
    """))
    return root


@pytest.fixture(scope="module")
def trained(tiny):
    """Train 4 steps, then resume to 6; (results, their logs, train dir)."""
    logs = []

    class Grab(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    log = logging.getLogger("train")
    h, level = Grab(), log.level
    log.addHandler(h)
    log.setLevel(logging.INFO)
    try:
        first = t_train.main(["-opt", str(tiny / "train.yml"), "--max-steps", "4",
                              "--val-sample-T", "4", "--device", "cpu"])
        n_first = len(logs)
        second = t_train.main(["-opt", str(tiny / "train.yml"), "--max-steps", "6",
                               "--val-sample-T", "4", "--device", "cpu"])
    finally:
        log.removeHandler(h)
        log.setLevel(level)
    return (first, second), (logs[:n_first], logs[n_first:]), \
        tiny / "out" / "experiments" / "smoke-test" / "training_state"


def test_train_cli_trains_saves_and_resumes(trained):
    (first, second), (log1, log2), ckpt_dir = trained
    assert first["final_step"] == 4 and second["final_step"] == 6
    assert np.isfinite(first["best_psnr"]) and np.isfinite(second["best_psnr"])
    assert first["best_step"] == 4 and second["best_step"] == 6
    assert "training from step 0 to 4" in log1
    assert "resumed from step 4" in log2 and "training from step 4 to 6" in log2
    # each save writes <step>.pt and daclip_tpu's orbax step dir <step>/
    assert sorted(os.listdir(ckpt_dir)) == ["4", "4.pt", "6", "6.pt"]
    assert torch.load(ckpt_dir / "6.pt", weights_only=False)["step"] == 6
    assert sum(m.startswith("step ") and " loss " in m for m in log1) == 2  # print_freq 2


def test_cli_config_equals_what_the_jax_cli_builds(tiny, monkeypatch):
    """Run daclip_tpu's CLI up to its UNet's `init` and compare the
    RestorationTrainConfig, IR-SDE and UNet arguments it built."""
    import dataclasses

    from daclip_tpu import sde as jsde_mod
    from daclip_tpu.cli.train_restoration import main as jmain
    from daclip_tpu.models import unet as junet_mod
    from daclip_tpu.train import restoration as jtrain_mod

    # the production train: and sde: keys over the tiny network and data
    opt = yaml.safe_load((REPO / "configs" / "daclip-sde" / "train.yml").read_text())
    tiny_opt = yaml.safe_load((tiny / "train.yml").read_text())
    opt.update(distortion=["noisy"], datasets=tiny_opt["datasets"],
               network_G=tiny_opt["network_G"], path=dict(tiny_opt["path"], daclip=None))
    opt["train"]["gradient_clipping"] = 0.5
    yml = tiny / "prod.yml"
    yml.write_text(yaml.safe_dump(opt))

    seen = {}

    class Stop(Exception):
        pass

    class UNet:  # records its arguments; the CLI's `init` of it ends the run
        def __init__(self, **kw):
            seen["unet"] = kw
            self.__dict__.update(kw)

        def init(self, *a, **kw):
            raise Stop

    real_sde, real_cfg = jsde_mod.IRSDE, jtrain_mod.RestorationTrainConfig
    monkeypatch.setattr(jtrain_mod, "RestorationTrainConfig",
                        lambda **kw: seen.setdefault("cfg", real_cfg(**kw)))
    monkeypatch.setattr(jsde_mod, "IRSDE", lambda **kw: seen.setdefault("sde", real_sde(**kw)))
    monkeypatch.setattr(junet_mod, "ConditionalUNet", UNet)
    with pytest.raises(Stop):
        jmain(["-opt", str(yml), "--max-steps", "9"])

    topt = tcfg.parse(str(yml))
    assert topt == jcfg.parse(str(yml))
    ours = t_train.train_config(topt["train"], 9)
    assert dataclasses.asdict(ours) == {f: getattr(seen["cfg"], f)
                                        for f in dataclasses.asdict(ours)}
    assert ours.niter == 9 and ours.grad_clip == 0.5 and ours.lr_steps == (200000, 400000,
                                                                           600000)
    tsde, jsde = t_train.make_sde(topt["sde"]), seen["sde"]
    for f in ("T", "max_sigma", "sample_T", "eps"):
        assert getattr(tsde, f) == getattr(jsde, f), f
    assert tsde.schedule_name == jsde.schedule_name
    np.testing.assert_array_equal(tsde.np_schedule.sigma_bars, jsde.np_schedule.sigma_bars)
    kw = dict(seen["unet"])
    kw.pop("dtype")
    assert t_train.unet_kwargs(topt) == kw


def test_cli_first_batches_equal_jax_loaders(tiny):
    from daclip_tpu.cli.train_restoration import build_dataloaders as jbuild

    topt, jopt = tcfg.parse(str(tiny / "train.yml")), jcfg.parse(str(tiny / "train.yml"))
    topt["datasets"]["train"]["seed"] = jopt["datasets"]["train"]["seed"] = 3
    ours, ours_val = t_train.build_dataloaders(topt)
    ref, ref_val = jbuild(jopt)
    assert len(ours) == len(ref) and len(ours_val) == len(ref_val) == 4
    ours.set_epoch(0)
    ref.set_epoch(0)
    for n, (b, jb) in enumerate(zip(ours, ref)):
        assert b.keys() == jb.keys()
        for k in b:
            if k == "LQ_clip":
                np.testing.assert_allclose(b[k], jb[k], atol=1e-6, rtol=0)
            elif isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(b[k], jb[k])
            else:
                assert b[k] == jb[k]
        if n == 1:
            break
    assert b["LQ"].shape == (2, 16, 16, 3)


def test_test_cli_metrics_equal_jax_metrics_on_its_output(tiny, trained):
    ckpt_dir = trained[2]
    out = t_test.main(["-opt", str(tiny / "test.yml"), "--checkpoint", str(ckpt_dir),
                       "--save-images", "--device", "cpu"])["test1"]
    assert len(out["psnr"]) == 2
    res_dir = tiny / "out" / "results" / "smoke-test" / "test1"
    for i in range(2):
        got = png.read(str(res_dir / f"{i}.png"))
        gt = jmetrics.array2img(png.read(str(tiny / "lqgt" / "GT" / f"{i}.png"))[:, :, ::-1]
                                .astype(np.float32) / 255.0)
        assert out["psnr"][i] == jmetrics.calculate_psnr(got, gt)
        assert out["psnr_y"][i] == jmetrics.psnr_y(got, gt)
        np.testing.assert_allclose(out["ssim"][i], jmetrics.calculate_ssim(
            got.astype(np.float64), gt.astype(np.float64)), rtol=1e-10)
        np.testing.assert_allclose(out["ssim_y"][i], jmetrics.ssim_y(got, gt), rtol=1e-10)
    assert all(np.isfinite(v).all() for v in out.values())
    assert out["lpips"] == []      # no --lpips-weights: LPIPS skipped, as daclip_tpu does
    with pytest.raises(FileNotFoundError):
        t_test.main(["-opt", str(tiny / "test.yml"), "--checkpoint", str(ckpt_dir),
                     "--lpips-weights", str(tiny / "missing.npz"), "--device", "cpu"])


def test_clis_need_a_gpu_unless_told_cpu_and_refuse_a_mesh(tiny, monkeypatch):
    with pytest.raises(SystemExit, match="spans 8 processes, and this run has 1"):
        t_train.main(["-opt", str(tiny / "train.yml"), "--mesh", "2,4", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["-opt", str(tiny / "train.yml")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_test.main(["-opt", str(tiny / "test.yml"), "--unet", str(FIXTURE / "unet.pth")])


def test_checkpoints_keep_the_newest_and_load_as_a_restorer(tiny, trained, tmp_path):
    ckpt_dir = trained[2]
    ckpt = torch.load(ckpt_dir / "6.pt", weights_only=False)
    for use_ema, key in ((True, "params_ema"), (False, "params")):
        r = tpipe.DACLIPRestorer.load(str(ckpt_dir), None, use_ema=use_ema, device="cpu")
        sd = r.unet.state_dict()
        assert all(torch.equal(sd[k], v.float()) for k, v in ckpt[key].items())
    assert not all(torch.equal(ckpt["params"][k], ckpt["params_ema"][k].to(v.dtype))
                   for k, v in ckpt["params"].items())
    r4 = tpipe.DACLIPRestorer.load(str(ckpt_dir), None, step=4, use_ema=False, device="cpu")
    four = torch.load(ckpt_dir / "4.pt", weights_only=False)["params"]
    assert all(torch.equal(r4.unet.state_dict()[k], v.float()) for k, v in four.items())
    # max_to_keep: older step files go after the rename
    class State:
        pass
    state = State()
    state.optimizer = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    state.ema = type("E", (), {"params": {}, "step": 0})()
    for step in range(1, 8):
        state.step = step
        tckpt.save_checkpoint(str(tmp_path), torch.nn.Linear(1, 1), state, max_to_keep=3)
    assert sorted(os.listdir(tmp_path)) == ["5.pt", "6.pt", "7.pt"]


def test_predictor_restores_a_png_with_cv2_hidden(tmp_path, monkeypatch):
    from daclip_torch.serve.predictor import Predictor

    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("No module named 'cv2'")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m == "cv2" or m.startswith("cv2.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    img = (np.random.RandomState(8).rand(40, 50, 3) * 255).astype(np.uint8)
    png.write(str(tmp_path / "in.png"), img, "paeth")
    pred = Predictor()  # setup() builds ViT-B-32; the fixture's DA-CLIP is the tiny one
    pred.restorer = tpipe.DACLIPRestorer.load(
        str(FIXTURE / "unet.pth"), str(FIXTURE / "daclip.pt"),
        tpipe.RestorerConfig(model_name="daclip_test-tiny", sample_T=2), device="cpu")
    out = pred.predict(str(tmp_path / "in.png"), seed=1, out_path=str(tmp_path / "out.png"))
    got = png.read(out)
    assert got.shape == (40, 50, 3) and got.dtype == np.uint8
    rgb = img[:, :, ::-1].astype(np.float32) / 255.0
    np.testing.assert_array_equal(got, pred.restorer.restore(rgb, seed=1))
