"""Both train CLIs of the port over two gloo ranks on the CPU, launched as
torchrun launches them: RANK / WORLD_SIZE / LOCAL_RANK in each spawned
process's environment, the CLI forming the group itself from `--dist-url
file://…` (tests/torch_parallel_workers.py). A launch with WORLD_SIZE 2
trains one run, not two copies: the ranks read disjoint samples that
together make one process's epoch, rank 0 alone writes, its checkpoint
loads in one process, and a `--mesh` that is not the world size exits
before any work. One process with no launcher behaves as before."""
import os

import numpy as np
import pytest
import torch

from daclip_torch.cli import train_daclip as tcli
from daclip_torch.cli import train_restoration as t_train
from daclip_torch.data.loader import DataLoader, IterSampler
from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
from daclip_torch.models.unet import ConditionalUNet
from daclip_torch.train import restoration as trest
from daclip_torch.utils.checkpoint import restore_checkpoint
from tests import torch_parallel_workers as w
from tests.test_torch_cli import TRAIN_YML, tiny  # noqa: F401  (the fixture)
from tests.test_torch_train_daclip import NAME, _argv, _cli_tree

torch.set_num_threads(1)


def _dist(tmp):
    return ["--dist-url", f"file://{w.store_path(tmp)}", "--dist-backend", "gloo"]


# -- DA-CLIP -------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def daclip_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("daclip2")
    train, val = _cli_tree(str(root))
    argv = _argv(str(root), train, val, 1, "--batch-size", "2") + _dist(root)
    return root, w.spawn(w.cli, 2, root, dict(cli="daclip", argv=argv), init=False)


def test_daclip_cli_over_two_ranks_trains_one_run(daclip_run):
    root, ranks = daclip_run
    assert [r["world"] for r in ranks] == [2, 2]
    # one seeded order (8 samples), striped: disjoint, together the epoch
    # one process reads at --batch-size 4
    one = DataLoader(list(range(8)), batch_size=4, shuffle=True, seed=0)._indices()
    got = [r["order"][0] for r in ranks]
    assert got == [one[0::2], one[1::2]]
    assert not set(got[0]) & set(got[1]) and sorted(got[0] + got[1]) == list(range(8))
    # the loss is the group's mean: both ranks log the same
    assert ranks[0]["result"]["best_loss"] == ranks[1]["result"]["best_loss"]
    # rank 0 alone writes, and only its files exist
    ckpts = os.path.join(root, "logs", "run", "checkpoints")
    assert ranks[1]["saved"] == [] and ranks[0]["saved"]
    assert sorted(os.listdir(ckpts)) == ["best", "epoch_1.pt"]
    assert all(s.startswith(str(root)) for s in ranks[0]["saved"])


def test_daclip_cli_checkpoint_of_two_ranks_loads_in_one_process(daclip_run):
    root, _ = daclip_run
    ckpt = torch.load(os.path.join(root, "logs", "run", "checkpoints", "epoch_1.pt"),
                      weights_only=False)
    model = DaCLIP(CLIPCfg.from_dict(get_model_config(NAME)), use_predictor=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 2
    # a resume in one process continues from it
    out = tcli.main(_argv(str(root), *_cli_tree(str(root / "again")), 2, "--batch-size", "2",
                          "--resume", os.path.join(root, "logs", "run", "checkpoints",
                                                   "epoch_1.pt"), "--name", "resumed"))
    assert np.isfinite(out["best_loss"])


@pytest.mark.parametrize("which", ["daclip", "restoration"])
def test_a_mesh_that_is_not_the_world_exits_before_any_work(tmp_path, tiny, which):
    if which == "daclip":
        train, val = _cli_tree(str(tmp_path))
        argv = _argv(str(tmp_path), train, val, 1, "--mesh", "4") + _dist(tmp_path)
    else:
        argv = ["-opt", str(tiny / "train.yml"), "--device", "cpu", "--mesh", "2,2"] + \
            _dist(tmp_path)
    ranks = w.spawn(w.cli, 2, tmp_path, dict(cli=which, argv=argv), init=False)
    for r in ranks:
        assert "spans 4 processes, and this run has 2" in r["exit"]
        assert r["order"] == [] and r["saved"] == []
    assert not os.path.exists(tmp_path / "logs")


def test_one_process_refuses_a_mesh_past_its_world(tmp_path):
    with pytest.raises(SystemExit, match="spans 2 processes, and this run has 1"):
        tcli.main(["--model", NAME, "--logs", str(tmp_path), "--device", "cpu",
                   "--mesh", "2"])
    assert not os.listdir(tmp_path)


# -- restoration -----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def resto_run(tiny, tmp_path_factory):
    """The tiny MD options (global batch 2, 4 steps, a checkpoint at 4)
    over two ranks under FSDP (1 × 2), into a fresh output root."""
    root = tmp_path_factory.mktemp("resto2")
    opt = root / "train.yml"
    opt.write_text(TRAIN_YML.format(root=tiny / "md", out=root / "out"))
    argv = ["-opt", str(opt), "--device", "cpu", "--mesh", "1,2"] + _dist(root)
    return root, w.spawn(w.cli, 2, root, dict(cli="restoration", argv=argv), init=False)


def test_restoration_cli_over_two_ranks_trains_one_run(resto_run):
    root, ranks = resto_run
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["result"]["final_step"] == ranks[1]["result"]["final_step"] == 4
    # the sampler's one epoch order, strided by rank: each rank 1 of the 2
    one = list(iter(IterSampler(4, ratio=200)))
    assert [r["order"][0] for r in ranks] == [one[0::2], one[1::2]]
    assert ranks[1]["saved"] == [] and len(ranks[0]["saved"]) == 2  # at 4 and at the end
    ckpt_dir = os.path.dirname(ranks[0]["saved"][0])
    assert ckpt_dir.startswith(str(root / "out")) and os.listdir(ckpt_dir) == ["4.pt"]


def test_restoration_cli_checkpoint_of_two_ranks_loads_in_one_process(resto_run):
    root, ranks = resto_run
    net = ConditionalUNet(nf=16, ch_mult=(1, 2), context_dim=None, use_degra_context=False,
                          use_image_context=False)
    state = trest.init_state(net, trest.RestorationTrainConfig(), device="cpu")
    restore_checkpoint(os.path.dirname(ranks[0]["saved"][0]), net, state)
    assert state.step == 4 and state.ema.step == 4
    # and the CLI resumes it in one process, with no launcher
    out = t_train.main(["-opt", str(root / "train.yml"), "--device", "cpu",
                        "--max-steps", "6"])
    assert out["final_step"] == 6
