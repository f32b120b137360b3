"""`cli.train_daclip`'s last single-card flags on the CPU, against
daclip_tpu: one run over seeded webdataset shards with
`--force-patch-dropout`, in-training ImageNet zero-shot and `--remote-sync`
(fsspec, a local path), two epochs, then `--resume latest` with the local
checkpoints deleted, which downloads them from the remote; the zero-shot
metrics in `results.jsonl` equal daclip_tpu's `evaluate_with_encoders` on
the saved weights; and `--fast-clip-view` normalising by a registry tag's
mean and std. The model is a tiny ViT with a 77-token text tower (the
zero-shot classifier tokenizes at 77), registered in both packages'
config tables for the module."""
import json
import pathlib
import shutil
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from daclip_torch.cli import params as tparams
from daclip_torch.cli import train_daclip as tcli
from daclip_torch.convert import load_torch_state_dict
from daclip_torch.models import clip as tclip
from daclip_torch.tokenizer import tokenize as ttokenize
from daclip_torch.utils import checkpoint as tckpt
from daclip_tpu import transforms as jtf
from daclip_tpu.eval import imagenet_zero_shot as jzs
from daclip_tpu.models import CLIPCfg as JaxCfg
from daclip_tpu.models import clip as jclip
from daclip_tpu.utils.torch_convert import convert_clip
from tests.test_torch_webdataset import write_shards

torch.set_num_threads(1)
MODEL = "test-tiny77"
CONFIG = {"embed_dim": 32,
          "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8,
                         "head_width": 32},
          "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 32, "heads": 2,
                       "layers": 2}}
CLASSES = ("cat", "dog", "car", "tree")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI's two runs; returns (root, argv of the first, the first's
    checkpoints and results, the resumed run's checkpoint)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tclip._MODEL_CONFIGS, MODEL, CONFIG)
    mp.setitem(jclip._MODEL_CONFIGS, MODEL, CONFIG)
    root = tmp_path_factory.mktemp("wds")
    pattern = write_shards(str(root / "shards"), shards=4, per_shard=6, seed=3, extra=False)
    rng = np.random.RandomState(4)
    for c in CLASSES:
        (root / "zs" / c).mkdir(parents=True)
        for i in range(3):
            Image.fromarray((rng.rand(36, 40, 3) * 255).astype(np.uint8)).save(
                root / "zs" / c / f"{i}.png")
    argv = ["--train-data", pattern, "--train-num-samples", "16", "--model", MODEL,
            "--batch-size", "4", "--epochs", "2", "--workers", "0", "--logs",
            str(root / "logs"), "--name", "run", "--precision", "fp32", "--warmup", "2",
            "--lr", "1e-3", "--eps", "1e-3", "--device", "cpu", "--force-patch-dropout",
            "0.5", "--imagenet-val", str(root / "zs"), "--zeroshot-frequency", "1",
            "--remote-sync", str(root / "remote"), "--remote-sync-protocol", "fsspec"]
    first = tcli.main(argv)
    ckpts = root / "logs" / "run" / "checkpoints"
    saved = {str(p.relative_to(ckpts)): p.read_bytes() for p in ckpts.rglob("*.pt")}
    rows = [json.loads(x) for x in open(root / "logs" / "run" / "results.jsonl")]
    remote = {p.relative_to(root / "remote" / "run"): p.read_bytes()
              for p in (root / "remote" / "run").rglob("*") if p.is_file()}
    local = {p.relative_to(root / "logs" / "run"): p.read_bytes()
             for p in (root / "logs" / "run").rglob("*") if p.is_file()}
    shutil.rmtree(ckpts)
    resumed = argv[:argv.index("--epochs") + 1] + ["3"] + argv[argv.index("--epochs") + 2:]
    second = tcli.main(resumed + ["--resume", "latest"])
    yield dict(root=root, first=first, second=second, saved=saved, rows=rows, remote=remote,
               local=local, ckpts=ckpts)
    mp.undo()


def test_the_run_trains_syncs_and_resumes_from_the_remote(run):
    assert np.isfinite([run["first"]["best_loss"], run["second"]["best_loss"]]).all()
    # the remote mirrors the log dir as the first run left it (out.log
    # grows with the final sync's own lines after it is copied)
    log = pathlib.Path("out.log")
    assert run["remote"].pop(log) and run["local"].pop(log)
    assert run["remote"] == run["local"]
    assert set(run["saved"]) == {"epoch_1.pt", "epoch_2.pt", "best/epoch_2.pt"}
    # the resume downloaded epoch_2.pt, and continued its step and moments
    ckpts = run["ckpts"]
    assert tckpt.steps(ckpts, tckpt.EPOCH) == [1, 2, 3]
    assert (ckpts / "epoch_2.pt").read_bytes() == run["saved"]["epoch_2.pt"]
    before = torch.load(ckpts / "epoch_2.pt", weights_only=False)
    after = torch.load(ckpts / "epoch_3.pt", weights_only=False)
    assert (before["step"], after["step"], after["epoch"]) == (8, 12, 3)
    # AdamW's moments were loaded, not restarted: their step count goes on
    # from 8 (a fresh optimizer's would read 4)
    assert set(after["optimizer"]["state"]) == set(before["optimizer"]["state"])
    for k, s in after["optimizer"]["state"].items():
        assert int(before["optimizer"]["state"][k]["step"]) == 8 and int(s["step"]) == 12, k
    rows = [json.loads(x) for x in open(run["root"] / "logs" / "run" / "results.jsonl")]
    assert [r["step"] for r in rows if "train/loss" in r] == [4, 8, 12]


def test_zero_shot_keys_each_epoch(run):
    zs = [r for r in run["rows"] if "val/imagenet-zeroshot-val-top1" in r]
    assert [r["step"] for r in zs] == [4, 8]
    assert set(zs[0]) == {"step", "val/imagenet-zeroshot-val-top1",
                          "val/imagenet-zeroshot-val-top5"}
    assert all(0.0 <= v <= 1.0 for r in zs for k, v in r.items() if k != "step")


def test_zero_shot_metrics_equal_jax_on_the_saved_weights(run, monkeypatch):
    """The last epoch's metrics against daclip_tpu's evaluate_with_encoders
    with its CLIP on the epoch_2.pt weights (the zero-shot ran on them,
    just before the save)."""
    monkeypatch.setitem(jclip._MODEL_CONFIGS, MODEL, CONFIG)
    path = run["root"] / "epoch_2.pt"
    path.write_bytes(run["saved"]["epoch_2.pt"])
    sd = {k: v.numpy() for k, v in load_torch_state_dict(str(path)).items()}
    cfg = JaxCfg.from_dict(CONFIG)
    model = jclip.CLIP(cfg)
    params = {"params": convert_clip(sd, 32, 8)}
    want = jzs.evaluate_with_encoders(
        lambda x: model.apply(params, x, normalize=True, method=model.encode_image),
        lambda t: model.apply(params, jnp.asarray(t), normalize=True,
                              method=model.encode_text),
        str(run["root"] / "zs"), 32, batch_size=4)
    got = [r for r in run["rows"] if "val/imagenet-zeroshot-val-top1" in r][-1]
    assert {k: got["val/" + k] for k in want} == want
    # the tree's images, one class per label
    assert want["imagenet-zeroshot-val-top5"] == 1.0


def test_fast_clip_view_normalises_by_the_tags_mean_and_std(tmp_path):
    """ViT-L-14's laion2b_s32b_b82k tag carries mean = std = 0.5: the cv2
    train view takes them, as daclip_tpu's CLI does
    (cli/train_daclip.py:158-172), unless --image-mean/--image-std say
    otherwise."""
    img = (np.random.RandomState(6).rand(60, 70, 3) * 255).astype(np.uint8)
    csv = tmp_path / "train.csv"
    Image.fromarray(img).save(tmp_path / "a.png")
    csv.write_text(f"filepath\ttitle\n{tmp_path / 'a.png'}\ta photo| noisy\n")
    base = ["--train-data", str(csv), "--model", "ViT-L-14", "--pretrained",
            "laion2b_s32b_b82k", "--fast-clip-view", "--batch-size", "1", "--workers", "0"]
    for extra, mean in (([], (0.5,) * 3), (["--image-mean", "0.1", "0.2", "0.3"],
                                           (0.1, 0.2, 0.3))):
        args = tparams.parse_args(base + extra)
        loader = tcli.build_data(args, None, None, partial(ttokenize, context_length=77),
                                 32)[0]
        want = jtf.image_transform(32, is_train=True, mean=mean, std=(0.5,) * 3,
                                   seed=args.seed, backend="cv2")
        np.testing.assert_array_equal(loader.dataset.transforms(img), want(img))
