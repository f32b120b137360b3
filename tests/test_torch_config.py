"""daclip_torch's options parser against daclip_tpu's on the repo's configs."""
import glob
import os
import pathlib
import textwrap

import pytest
import torch

from daclip_torch import config as tcfg
from daclip_tpu import config as jcfg

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(REPO / "configs" / "**" / "*.yml"), recursive=True))


def test_the_repo_has_four_configs():
    assert [os.path.relpath(p, REPO) for p in CONFIGS] == [
        "configs/daclip-sde/test.yml", "configs/daclip-sde/train.yml",
        "configs/wild-ir/test.yml", "configs/wild-ir/train.yml"]


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_parse_equals_jax(path, is_train):
    ours, ref = tcfg.parse(path, is_train=is_train), jcfg.parse(path, is_train=is_train)
    assert ours == ref
    assert type(ours) is tcfg.NoneDict and ours["no_such_key"] is None
    assert ours["datasets"][next(iter(ours["datasets"]))]["no_such_key"] is None


def test_parse_debug_name_and_check_resume_equal_jax(tmp_path):
    yml = tmp_path / "debug.yml"
    yml.write_text(textwrap.dedent(f"""
        name: debug_run
        distortion: [noisy, hazy]
        sde: {{max_sigma: 50}}
        datasets:
          train_1: {{mode: MD, dataroot: ~/data/train}}
          val: {{mode: LQGT, dataroot_GT: ~/gt, dataroot_LQ: ~/lq}}
        path:
          root: {tmp_path}
          resume_state: {tmp_path}/experiments/debug_run/training_state/1200.state
        train: {{val_freq: 1000, lr_G: !!float 2e-4}}
        logger: {{print_freq: 100, save_checkpoint_freq: 5000}}
    """))
    ours, ref = tcfg.parse(str(yml)), jcfg.parse(str(yml))
    assert ours == ref
    assert (ours["train"]["val_freq"], ours["logger"]["print_freq"],
            ours["logger"]["save_checkpoint_freq"]) == (8, 2, 8)
    assert ours["sde"]["T"] == 100 and ours["datasets"]["train_1"]["phase"] == "train"
    assert ours["datasets"]["val"]["dataroot_GT"] == os.path.expanduser("~/gt")
    assert tcfg.check_resume(ours) == jcfg.check_resume(ref)
    assert ours["path"]["pretrain_model_G"].endswith("models/1200_G.pth")
    assert tcfg.check_resume(ours, 7)["path"]["pretrain_model_G"] == \
        jcfg.check_resume(ref, 7)["path"]["pretrain_model_G"]
    assert tcfg.dict_to_nonedict([{"a": 1}, 2]) == jcfg.dict_to_nonedict([{"a": 1}, 2])
