"""The Wild-IR configuration on the CPU: daclip_torch's MDGT dataset (GT-only
folders degraded on the fly) against daclip_tpu's over two epochs of the
sampler, with and without the LQ cache, and `cli.train_restoration` on a
tiny wild-ir-shaped options file (configs/wild-ir/train.yml with mode
MDGT, the scale-0.5 UNet and the image context only, cut to a tiny DaCLIP
and UNet): its config and first batches against daclip_tpu's CLI, 3 steps
and a resume, then `cli.test_restoration` on the saved EMA UNet."""
import logging
import pathlib
import warnings

import numpy as np
import pytest
import torch
import yaml

from daclip_torch import config as tcfg
from daclip_torch.cli import test_restoration as t_test
from daclip_torch.cli import train_restoration as t_train
from daclip_torch.data import datasets as tds
from daclip_torch.data import loader as tloader
from daclip_torch.data import png
from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
from daclip_tpu import config as jcfg
from daclip_tpu.data import datasets as jds
from daclip_tpu.data import loader as jloader
from tests.test_torch_text import NAME

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
SIZES = [(40, 52), (48, 48), (45, 37), (64, 40), (33, 50)]   # GT (H, W); odd sides too


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """GT/ of five seeded PNGs (Up rows), an LQGT val pair of folders of 2
    at 32 × 40, a tiny DaCLIP .pt, and the tiny wild-ir options files."""
    root = tmp_path_factory.mktemp("wild")
    rng = np.random.RandomState(0)
    (root / "GT").mkdir()
    for i, (h, w) in enumerate(SIZES):
        png.write(str(root / "GT" / f"{i}.png"), (rng.rand(h, w, 3) * 255).astype(np.uint8),
                  "up")
    for sub in ("GT", "LQ"):
        (root / "val" / sub).mkdir(parents=True)
        for i in range(2):
            png.write(str(root / "val" / sub / f"{i}.png"),
                      (rng.rand(32, 40, 3) * 255).astype(np.uint8))
    torch.manual_seed(0)
    daclip = DaCLIP(CLIPCfg.from_dict(get_model_config(NAME)))
    torch.save(daclip.state_dict(), root / "daclip.pt")

    embed = get_model_config(NAME)["embed_dim"]
    opt = yaml.safe_load((REPO / "configs" / "wild-ir" / "train.yml").read_text())
    # the widths, batch and paths cut; mode MDGT, scale 0.5 and the image
    # context only as wild-ir has them. Two keys wild-ir's yml lacks: the
    # tiny DaCLIP's name (`path.daclip_model`: both CLIs pick ViT-L-14 for a
    # 768-d context and ViT-B-32 otherwise) and its 32² view (`clip_size`)
    opt["datasets"]["train"].update(dataroot_GT=str(root / "GT"), n_workers=0, batch_size=2,
                                    patch_size=32, clip_size=32)
    opt["datasets"]["val"].update(dataroot_GT=str(root / "val" / "GT"),
                                  dataroot_LQ=str(root / "val" / "LQ"), clip_size=32)
    opt["network_G"]["setting"].update(nf=16, ch_mult=[1, 2], context_dim=embed)
    opt["path"].update(daclip=str(root / "daclip.pt"), daclip_model=NAME, root=str(root / "out"))
    opt["train"].update(niter=3, val_freq=3)
    opt["logger"].update(print_freq=1, save_checkpoint_freq=3)
    (root / "train.yml").write_text(yaml.safe_dump(opt))
    test = yaml.safe_load((REPO / "configs" / "wild-ir" / "test.yml").read_text())
    test["sde"]["T"] = 4
    test["datasets"]["test1"].update(dataroot_GT=str(root / "val" / "GT"),
                                     dataroot_LQ=str(root / "val" / "LQ"), clip_size=32)
    test["network_G"]["setting"].update(nf=16, ch_mult=[1, 2], context_dim=embed)
    test["path"].update(daclip=str(root / "daclip.pt"), daclip_model=NAME,
                        root=str(root / "out"))
    (root / "test.yml").write_text(yaml.safe_dump(test))
    return root


def _assert_samples_equal(s, j):
    assert s.keys() == j.keys()
    for k in s:
        if isinstance(s[k], np.ndarray):
            assert s[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(s[k], j[k], err_msg=k)
        else:
            assert s[k] == j[k], k


@pytest.mark.parametrize("case", ["train", "train_lq_cache", "val"])
def test_mdgt_samples_equal_jax_over_two_epochs(tree, case):
    opt = dict(mode="MDGT", dataroot_GT=str(tree / "GT"), patch_size=32, use_flip=True,
               use_rot=True, color="RGB", clip_size=32, seed=5,
               phase="val" if case == "val" else "train")
    if case == "train_lq_cache":
        opt.update(lq_cache=3, lq_cache_refresh=0.4)
    ours, ref = tds.create_dataset(dict(opt)), jds.create_dataset(dict(opt))
    assert len(ours) == len(ref) == len(SIZES)
    sampler, jsampler = tloader.IterSampler(len(ours), ratio=3), jloader.IterSampler(len(ref),
                                                                                     ratio=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # under_display_filter's missing ucdpsf.pkl
        for epoch in range(2):
            sampler.set_epoch(epoch)
            jsampler.set_epoch(epoch)
            idx = list(sampler)
            assert idx == list(jsampler)
            for i in idx:
                s = ours[i]
                _assert_samples_equal(s, ref[i])
                shape = SIZES[i] if case == "val" else (32, 32)
                assert s["GT"].shape == s["LQ"].shape == (*shape, 3)
                assert s["LQ_clip"].shape == (32, 32, 3)
    if case == "train_lq_cache":
        assert len(ours._lq_cache) == 3


def test_cli_config_equals_what_the_jax_cli_builds(tree, monkeypatch):
    """daclip_tpu's CLI run up to its UNet's `init` on the tiny wild-ir
    options: the same options, train config, IR-SDE and UNet arguments
    (scale 0.5, the image context only)."""
    import dataclasses

    from daclip_tpu import sde as jsde_mod
    from daclip_tpu.cli.train_restoration import main as jmain
    from daclip_tpu.models import unet as junet_mod
    from daclip_tpu.train import restoration as jtrain_mod

    seen = {}

    class Stop(Exception):
        pass

    class UNet:
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
    yml = str(tree / "train.yml")
    with pytest.raises(Stop):
        jmain(["-opt", yml, "--max-steps", "9"])

    topt = tcfg.parse(yml)
    assert topt == jcfg.parse(yml)
    ours = t_train.train_config(topt["train"], 9)
    assert dataclasses.asdict(ours) == {f: getattr(seen["cfg"], f)
                                        for f in dataclasses.asdict(ours)}
    tsde, jsde = t_train.make_sde(topt["sde"]), seen["sde"]
    for f in ("T", "max_sigma", "sample_T", "eps"):
        assert getattr(tsde, f) == getattr(jsde, f), f
    kw = dict(seen["unet"])
    kw.pop("dtype")
    assert t_train.unet_kwargs(topt) == kw
    assert kw["scale"] == 0.5 and kw["use_image_context"] and not kw["use_degra_context"]


def test_cli_first_batches_equal_jax_loaders(tree):
    from daclip_tpu.cli.train_restoration import build_dataloaders as jbuild

    yml = str(tree / "train.yml")
    topt, jopt = tcfg.parse(yml), jcfg.parse(yml)
    topt["datasets"]["train"]["seed"] = jopt["datasets"]["train"]["seed"] = 3
    ours, ours_val = t_train.build_dataloaders(topt)
    ref, ref_val = jbuild(jopt)
    assert isinstance(ours.dataset, tds.MDGTDataset)
    assert len(ours) == len(ref) and len(ours_val) == len(ref_val) == 2
    ours.set_epoch(0)
    ref.set_epoch(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n, (b, jb) in enumerate(zip(ours, ref)):
            _assert_samples_equal(b, jb)
            if n == 2:
                break
    assert b["LQ"].shape == (2, 32, 32, 3) and b["LQ_clip"].shape == (2, 32, 32, 3)


def test_cli_trains_resumes_and_tests_wild_ir_shaped_options(tree):
    logs = []

    class Grab(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    log = logging.getLogger("train")
    h, level = Grab(), log.level
    log.addHandler(h)
    log.setLevel(logging.INFO)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            first = t_train.main(["-opt", str(tree / "train.yml"), "--val-sample-T", "4",
                                  "--device", "cpu"])
            n_first = len(logs)
            second = t_train.main(["-opt", str(tree / "train.yml"), "--max-steps", "4",
                                   "--val-sample-T", "4", "--device", "cpu"])
    finally:
        log.removeHandler(h)
        log.setLevel(level)
    assert first["final_step"] == 3 and second["final_step"] == 4
    assert np.isfinite([first["best_psnr"], second["best_psnr"]]).all()
    assert not any("without contexts" in m for m in logs)
    assert "training from step 0 to 3" in logs[:n_first]
    assert "resumed from step 3" in logs[n_first:]
    ckpt_dir = tree / "out" / "experiments" / "wild-ir" / "training_state"
    # each save writes <step>.pt and daclip_tpu's orbax step dir <step>/
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["3", "3.pt", "4", "4.pt"]

    out = t_test.main(["-opt", str(tree / "test.yml"), "--checkpoint", str(ckpt_dir),
                       "--device", "cpu"])["test1"]
    assert len(out["psnr"]) == 2 and all(np.isfinite(v).all() for v in out.values())
    cfg = t_test.restorer_config(tcfg.parse(str(tree / "test.yml"), is_train=False))
    assert cfg.scale == 0.5 and cfg.model_name == NAME
    assert cfg.use_image_context and not cfg.use_degra_context
