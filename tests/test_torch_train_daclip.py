"""daclip_torch's DA-CLIP training front end against daclip_tpu's on the
CPU: `cli.params.parse_args`, the train transform's bytes (PIL's box
resize), `CsvDataset` / `SyntheticDataset` samples over seeded PNG trees of
every 8-bit layout, the factory from a plain CLIP and a full DaCLIP `.pt`,
`eval.retrieval.evaluate`, the CLI's first batches, and `cli.train_daclip`
itself on `daclip_test-tiny`: two epochs, a resume to three, validation,
checkpoints that `DACLIPRestorer.load` takes, and each flag it still refuses; the
cv2 view of `--fast-clip-view` and its batches."""
import json
import os
import random
import struct
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from daclip_torch import factory as tfactory
from daclip_torch import pipeline as tpipe
from daclip_torch import transforms as ttf
from daclip_torch.cli import params as tparams
from daclip_torch.cli import train_daclip as tcli
from daclip_torch.convert import clip_state_dict_from_jax, daclip_state_dict_from_jax
from daclip_torch.data import csv_dataset as tdata
from daclip_torch.data import loader as tloader
from daclip_torch.data import util as tutil
from daclip_torch.eval import retrieval as tret
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.tokenizer import tokenize as ttokenize
from daclip_torch.utils import checkpoint as tckpt
from daclip_torch.utils.native_checkpoint import save_params_npz
from daclip_tpu import factory as jfactory
from daclip_tpu import transforms as jtf
from daclip_tpu.cli import params as jparams_mod
from daclip_tpu.data import csv_dataset as jdata
from daclip_tpu.data import loader as jloader
from daclip_tpu.eval import retrieval as jret
from daclip_tpu.models import CLIPCfg as JaxCfg
from daclip_tpu.models import DaCLIP as JaxDaCLIP
from daclip_tpu.models import get_model_config
from daclip_tpu.tokenizer import tokenize as jtokenize
from tests.test_torch_text import NAME, jax_daclip_params

torch.set_num_threads(1)
L = 16
FIXTURE = os.path.join(os.path.dirname(__file__), "parity", "fixtures", "e2e")


# -- parse_args -----------------------------------------------------------------------
def _store_true_flags():
    import argparse

    seen = []
    real = argparse.ArgumentParser.add_argument

    def spy(self, *names, **kw):
        if kw.get("action") == "store_true":
            seen.append(names[0])
        return real(self, *names, **kw)

    argparse.ArgumentParser.add_argument = spy
    try:
        jparams_mod.parse_args([])
    finally:
        argparse.ArgumentParser.add_argument = real
    return seen


@pytest.mark.parametrize("argv", [
    [], ["--model", "ViT-B-32"], ["--model", "RN50"], ["--model", "daclip_ViT-B-32", "--lr",
                                                       "2e-5", "--beta2", "0.99"],
    ["--train-data", "a.csv", "--batch-size", "128", "--epochs", "50", "--precision", "fp32",
     "--aug-cfg", "scale=(0.5,1.0)", "color_jitter=0.4", "name=x", "--image-mean", "0.5",
     "0.5", "0.5", "--force-image-size", "224", "--lr-scheduler", "const-cooldown",
     "--epochs-cooldown", "2", "--grad-clip-norm", "1.0", "--accum-freq", "4"],
    "store_true"])
def test_parse_args_equals_jax(argv):
    if argv == "store_true":
        argv = _store_true_flags()
        assert len(argv) >= 25
    ours, ref = vars(tparams.parse_args(argv)), vars(jparams_mod.parse_args(argv))
    assert ours.pop("device") is None
    assert ours == ref
    assert vars(tparams.parse_args(["--device", "cpu"]))["device"] == "cpu"
    with pytest.raises(SystemExit):
        tparams.parse_args(["--use-bnb-linear", "x"])


# -- the train transform ------------------------------------------------------------------
@pytest.mark.parametrize("shape,size", [((70, 90), 32), ((61, 45), 48), ((100, 12), 32),
                                        ((40, 40), 64), ((224, 288), 224)])
def test_train_transform_bytes_equal_jax(shape, size):
    """The crop draws and PIL's resize over the box (taps outside it), the
    fallback of a 100 × 12 image included; then normalised."""
    rng = np.random.RandomState(sum(shape))
    img = (rng.rand(*shape, 3) * 255).astype(np.uint8)
    ours = ttf.image_transform(size, is_train=True, rng=random.Random(3))
    ref = jtf.image_transform(size, is_train=True, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(ours(img), ref(Image.fromarray(img)))
    val = ttf.image_transform(size, is_train=False)(img)
    np.testing.assert_array_equal(val, jtf.image_transform(size)(Image.fromarray(img)))


@pytest.mark.parametrize("shape,size", [((70, 90), 32), ((61, 45), 48), ((100, 12), 32),
                                        ((40, 40), 64), ((224, 288), 224)])
def test_cv2_views_bytes_equal_jax(shape, size):
    """The cv2 backend (`--fast-clip-view`): the same crop draws, cv2's area
    and bicubic resizes, on uint8, [0, 1] float and one-channel inputs."""
    rng = np.random.RandomState(sum(shape) + 1)
    u8 = (rng.rand(*shape, 3) * 255).astype(np.uint8)
    for img in (u8, rng.rand(*shape, 3).astype(np.float32), u8[:, :, :1], u8[:, :, 0]):
        ours = ttf.image_transform(size, is_train=True, rng=random.Random(5), backend="cv2")
        ref = jtf.image_transform(size, is_train=True, seed=5, backend="cv2")
        for _ in range(3):
            got = ours(img)
            assert got.shape == (size, size, 3) and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref(img))
        np.testing.assert_array_equal(ttf.image_transform(size, backend="cv2")(img),
                                      jtf.image_transform(size, backend="cv2")(img))
    decoded = ttf.DecodedImage(u8, None, "RGB")
    np.testing.assert_array_equal(ttf.image_transform(size, backend="cv2")(decoded),
                                  jtf.image_transform(size, backend="cv2")(Image.fromarray(u8)))
    with pytest.raises(ValueError, match="backend"):
        ttf.image_transform(size, backend="pillow")


def test_box_resize_is_not_crop_then_resize():
    img = (np.random.RandomState(1).rand(50, 60, 3) * 255).astype(np.uint8)
    box = (7, 5, 47, 45)
    got = ttf._resample_bicubic(img, 24, 24, box)
    np.testing.assert_array_equal(
        got, np.asarray(Image.fromarray(img).resize((24, 24), Image.BICUBIC, box=box)))
    assert not np.array_equal(got, ttf._resample_bicubic(img[5:45, 7:47], 24, 24))


# -- the CSV dataset ------------------------------------------------------------------------
def _layout(mode, rgb, rng):
    if mode == "RGB":
        return Image.fromarray(rgb), {}
    if mode == "RGBA":
        a = (rng.rand(*rgb.shape[:2]) * 255).astype(np.uint8)
        return Image.fromarray(np.dstack([rgb, a]), "RGBA"), {}
    if mode == "L":
        return Image.fromarray(rgb[:, :, 0]), {}
    if mode == "LA":
        return Image.fromarray(np.dstack([rgb[:, :, 0], rgb[:, :, 1]]), "LA"), {}
    if mode == "P":
        return Image.fromarray(rgb).quantize(64), {}
    if mode == "P_trns":
        return Image.fromarray(rgb).quantize(64), {"transparency": 3}
    if mode == "RGB_key":
        return Image.fromarray(rgb), {"transparency": tuple(int(c) for c in rgb[0, 0])}
    raise ValueError(mode)


MODES = ["RGB", "RGBA", "L", "LA", "P", "P_trns", "RGB_key"]


def _write_tree(root, n, seed, modes=MODES, lo=64, hi=80):
    """root/{LQ,GT}/<i>.png in the given layouts and a train.csv of them."""
    rng = np.random.RandomState(seed)
    rows = []
    for sub in ("LQ", "GT"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    types = ["noisy", "blur", "jpeg", "resize"]
    vals = [25, 1.5, 30, 2.0]
    for i in range(n):
        h, w = rng.randint(lo, hi, 2)
        for sub in ("LQ", "GT"):
            rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            im, kw = _layout(modes[(i + (sub == "GT")) % len(modes)], rgb, rng)
            im.save(os.path.join(root, sub, f"{i}.png"), **kw)
        degs = [f"{t} with parameter {v}" for t, v in zip(types, vals) if rng.rand() > 0.5]
        rows.append(f"{root}/LQ/{i}.png\tphoto {i} of a scene| "
                    f"{', '.join(degs) or 'noisy with parameter 15'}")
    path = os.path.join(root, "train.csv")
    with open(path, "w") as f:
        f.write("filepath\ttitle\n" + "\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("crop", [False, True])
def test_csv_dataset_samples_equal_jax(tmp_path, crop):
    csv = _write_tree(str(tmp_path), len(MODES), seed=2)
    kw = dict(da=True, crop=crop, seed=7)
    ours = tdata.CsvDataset(csv, ttf.image_transform(32, True, rng=random.Random(4)),
                            tokenizer=partial(ttokenize, context_length=L), **kw)
    ref = jdata.CsvDataset(csv, jtf.image_transform(32, True, seed=4),
                           tokenizer=partial(jtokenize, context_length=L), **kw)
    assert len(ours) == len(ref) == len(MODES)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} of sample {i}")
    for x, y in zip(ours.banks(), ref.banks()):
        np.testing.assert_array_equal(x, y)


def test_csv_val_samples_and_synthetic_equal_jax(tmp_path):
    """The val transform resizes in the file's own mode (a palette NEAREST,
    alpha premultiplied), as PIL does: every layout, scaled up (16-30 px to
    32) and down (40-70 px), byte for byte."""
    n = len(MODES)
    for sub, (lo, hi) in (("up", (16, 30)), ("down", (40, 70))):
        csv = _write_tree(str(tmp_path / sub), n, seed=3, lo=lo, hi=hi)
        ours = tdata.CsvDataset(csv, ttf.image_transform(32), da=False)
        ref = jdata.CsvDataset(csv, jtf.image_transform(32), da=False)
        for i in range(n):
            for k, v in ours[i].items():
                np.testing.assert_array_equal(v, ref[i][k], err_msg=f"{k} of {sub} {i}")
    for da in (False, True):
        ours = tdata.SyntheticDataset(ttf.image_transform(32, True, rng=random.Random(0)),
                                      dataset_size=5, da=da)
        ref = jdata.SyntheticDataset(jtf.image_transform(32, True, seed=0), dataset_size=5,
                                     da=da)
        assert len(ours) == 5
        for k, v in ours[2].items():
            np.testing.assert_array_equal(v, ref[2][k], err_msg=k)


@pytest.mark.parametrize("mode", ["P", "1", "RGBA", "LA"])
def test_resize_in_mode_equals_pil(mode):
    """`transforms._resize_decoded` against PIL's resize in the image's mode
    and `convert("RGB")`, up and down, with many zero and opaque alphas."""
    rng = np.random.RandomState(len(mode))
    for _ in range(12):
        h, w = rng.randint(3, 90, 2)
        nw, nh = rng.randint(1, 120, 2)
        rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        a = (rng.rand(h, w) * 255).astype(np.uint8)
        a[rng.rand(h, w) < 0.3] = 0
        a[rng.rand(h, w) < 0.2] = 255
        im = {"P": lambda: Image.fromarray(rgb).quantize(32),
              "1": lambda: Image.fromarray(rgb[:, :, 0]).convert("1"),
              "RGBA": lambda: Image.fromarray(np.dstack([rgb, a]), "RGBA"),
              "LA": lambda: Image.fromarray(np.dstack([rgb[:, :, 0], a]), "LA")}[mode]()
        alpha = a if mode in ("RGBA", "LA") else None
        got = ttf._resize_decoded(ttf.DecodedImage(np.asarray(im.convert("RGB")), alpha, mode),
                                  nw, nh)
        want = np.asarray(im.resize((nw, nh), Image.BICUBIC).convert("RGB"))
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} {(h, w)} -> {(nh, nw)}")


def test_a_16_bit_png_is_refused(tmp_path):
    """A 16-bit PNG is refused only where the spec forbids it (a palette);
    a 16-bit gray one reads as PIL reads it: mode "I;16", its samples kept
    for the resize, its RGB as `convert("RGB")` gives it (clipped)."""
    path = str(tmp_path / "x.png")
    samples = np.arange(64 * 64, dtype=np.uint16).reshape(64, 64)
    Image.fromarray(samples).save(path)
    dec = tutil.imread_decoded(path)
    with Image.open(path) as im:
        assert im.mode == "I;16"
        np.testing.assert_array_equal(dec.rgb, np.asarray(im.convert("RGB")))
    assert dec.mode == "I;16" and dec.alpha is None and dec.rgb.max() == 255
    np.testing.assert_array_equal(dec.gray16, samples)
    data = bytearray(open(path, "rb").read())
    data[24:26] = bytes([16, 3])                      # IHDR: 16-bit palette
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="colour type 3 at bit depth 16 is not valid"):
        tutil.imread_decoded(path)


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (16, 2), (16, 4), (16, 6),
                                         (2, 3), (8, 0)])
def test_csv_val_view_of_other_depths_equals_jax(tmp_path, depth, ctype):
    """The val transform's view of sub-byte and 16-bit PNGs (Adam7 ones
    among them), which PIL opens in 8-bit modes, equals daclip_tpu's."""
    from tests.test_torch_data import _encode_png

    rng = np.random.RandomState(depth * 7 + ctype)
    C = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    s = rng.randint(0, 2 ** depth, (45, 38, C))
    plte = rng.randint(0, 256, (2 ** depth, 3)) if ctype == 3 else None
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_encode_png(s, depth, ctype, plte, interlace=(depth + ctype) % 2))
    for res in (32, 64):
        with Image.open(path) as im:
            want = jtf.image_transform(res)(im)
        np.testing.assert_array_equal(ttf.image_transform(res)(tutil.imread_decoded(path)),
                                      want)


# -- the factory ------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jparams():
    return jax_daclip_params(seed=0)


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


def test_factory_from_a_plain_clip_pt_equals_jax(tmp_path, jparams):
    """The CLIP weights go to the frozen tower and are copied into the
    controller (zero modules zero, logit_scale copied); a predictor asked
    for stays seeded."""
    path = str(tmp_path / "clip.pt")
    torch.save(clip_state_dict_from_jax(jparams["clip"]), path)
    ours = tfactory.create_model(NAME, pretrained=path)
    _, jp = jfactory.create_model(NAME, pretrained=path)
    got = ours.state_dict()
    _assert_sd_equal(got, daclip_state_dict_from_jax(jax.tree.map(np.asarray, jp)))
    assert not got["visual_control.transformer.zero_modules.0.weight"].any()
    assert torch.equal(got["logit_scale"], got["clip.logit_scale"])
    with_pred = tfactory.create_model(NAME, pretrained=path, use_predictor=True).state_dict()
    assert any(k.startswith("predictor.") for k in with_pred)
    _assert_sd_equal({k: v for k, v in with_pred.items() if not k.startswith("predictor.")},
                     got)


@pytest.mark.parametrize("use_predictor", [False, True])
def test_factory_from_a_daclip_pt_and_npz_equals_jax(tmp_path, jparams, use_predictor):
    pt, npz = str(tmp_path / "daclip.pt"), str(tmp_path / "daclip.npz")
    torch.save(daclip_state_dict_from_jax(jparams), pt)
    save_params_npz(npz, jparams)
    _, jp = jfactory.create_model(NAME, pretrained=pt, use_predictor=use_predictor)
    want = daclip_state_dict_from_jax(jax.tree.map(np.asarray, jp))
    for path in (pt, npz):
        model = tfactory.create_model(NAME, pretrained=path, use_predictor=use_predictor,
                                      precision="amp")
        assert model.dtype == torch.bfloat16
        _assert_sd_equal(model.state_dict(), want)


@pytest.mark.parametrize("name,pretrained", [
    ("RN50", None), ("coca_ViT-B-32", None), ("convnext_base", None), ("EVA02-B-16", None),
    ("roberta-ViT-B-32", None), ("ViT-M-16-alt", None)])
def test_factory_refuses_what_waits_for_item_6(name, pretrained):
    """The towers and CoCa that waited for queue 1 item 6 now build (on the
    meta device: full width, no memory); an HF text tower in a config is
    refused as daclip_tpu's CustomTextCLIP refuses it."""
    if name.startswith("roberta"):
        with pytest.raises(ImportError, match="compose daclip_torch.models.hf_text"):
            tfactory.create_model(name, pretrained=pretrained)
        return
    with torch.device("meta"):
        model = tfactory.create_model(name, pretrained=pretrained)
    assert sum(p.numel() for p in model.parameters()) > 5e7


def test_factory_transforms_and_seed():
    model, train, val = tfactory.create_model_and_transforms(NAME, seed=3,
                                                             rng=random.Random(0))
    again = tfactory.create_model(NAME, seed=3)
    _assert_sd_equal(model.state_dict(), again.state_dict())
    img = (np.random.RandomState(0).rand(40, 50, 3) * 255).astype(np.uint8)
    assert train(img).shape == val(img).shape == (32, 32, 3)
    big = tfactory.create_model(NAME, force_image_size=64, force_quick_gelu=True)
    assert big.cfg.vision.image_size == 64 and big.cfg.quick_gelu


# -- retrieval.evaluate -------------------------------------------------------------------------
class _Samples(list):
    """A dataset of ready samples."""


def _val_samples(n, seed):
    rng = np.random.RandomState(seed)
    bank_toks = lambda t: ttokenize(t, context_length=L)
    out = _Samples()
    for i in range(n):
        deg_type = (rng.rand(4) > 0.5).astype(np.float32)
        out.append({"images": rng.randn(32, 32, 3).astype(np.float32),
                    "gt_images": rng.randn(32, 32, 3).astype(np.float32),
                    "texts": np.concatenate([bank_toks([f"a photo {i}"])[0],
                                             bank_toks([f"noisy {i}"])[0]]).astype(np.int32),
                    "deg_type": deg_type,
                    "gt_val": (deg_type * rng.rand(4) * 30).astype(np.float32)})
    return out


@pytest.mark.parametrize("variant", ["fork", "uir"])
def test_retrieval_evaluate_equals_jax(jparams, variant):
    cfg_dict = get_model_config(NAME)
    use_pred = variant == "fork"
    params = dict(jparams) if use_pred else {k: v for k, v in jparams.items()
                                             if k != "predictor"}
    model = TorchDaCLIP(TorchCfg.from_dict(cfg_dict), use_predictor=use_pred)
    model.load_state_dict(daclip_state_dict_from_jax(params), strict=True)
    jmodel = JaxDaCLIP(JaxCfg.from_dict(cfg_dict), use_predictor=use_pred, dtype=jnp.float32)
    ds = _val_samples(7, seed=5)
    banks = tdata.build_banks(lambda t: ttokenize(t, context_length=L))
    got = tret.evaluate(model, ds, batch_size=3, banks=banks, variant=variant, device="cpu")
    want = jret.evaluate(jax.jit(jmodel.apply), {"params": params}, ds, batch_size=3,
                         banks=banks, variant=variant)
    assert set(got) == set(want) and got["num_samples"] == 7
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)


# -- the CLI ----------------------------------------------------------------------------------------
def _cli_tree(root):
    train = _write_tree(os.path.join(root, "train"), 8, seed=11, modes=["RGB", "L", "P"])
    val = _write_tree(os.path.join(root, "val"), 4, seed=12, modes=["RGB"])
    return train, val


def _argv(root, train, val, epochs, *extra):
    return ["--train-data", train, "--val-data", val, "--da", "--model", NAME,
            "--batch-size", "4", "--epochs", str(epochs), "--workers", "0", "--logs",
            os.path.join(root, "logs"), "--name", "run", "--precision", "fp32", "--warmup",
            "2", "--lr", "1e-4", "--crop", "--device", "cpu", *extra]


def test_cli_trains_resumes_validates_and_saves(tmp_path):
    root = str(tmp_path)
    train, val = _cli_tree(root)
    first = tcli.main(_argv(root, train, val, 2))
    # epoch 3 is off --save-frequency 2: it goes to latest/
    second = tcli.main(_argv(root, train, val, 3, "--resume", "latest", "--save-frequency",
                             "2", "--save-most-recent"))
    assert np.isfinite([first["best_loss"], second["best_loss"]]).all()
    run_dir = os.path.join(root, "logs", "run", "checkpoints")
    ckpts = os.path.join(run_dir, "latest")
    assert tckpt.steps(run_dir, tckpt.EPOCH) == [1, 2] and tckpt.steps(ckpts, tckpt.EPOCH) == [3]
    assert len(tckpt.steps(os.path.join(run_dir, "best"), tckpt.EPOCH)) == 1
    last = torch.load(tckpt.checkpoint_path(ckpts, 3, tckpt.EPOCH), weights_only=False)
    assert (last["epoch"], last["step"], last["name"]) == (3, 6, "run")
    assert set(last["optimizer"]["state"]) and last["optimizer"]["param_groups"]

    rows = [json.loads(line) for line in open(os.path.join(root, "logs", "run",
                                                           "results.jsonl"))]
    train_rows = [r for r in rows if "train/loss" in r]
    val_rows = [r for r in rows if "val/image_to_text_R@1" in r]
    assert [r["step"] for r in train_rows] == [r["step"] for r in val_rows] == [2, 4, 6]
    assert set(train_rows[0]) == {"step", "train/loss", "train/grad_norm",
                                  "train/logit_scale", "train/samples_per_s"}
    assert {"val/val_fcrc_loss", "val/val_reg_ls_loss", "val/num_samples"} <= set(val_rows[0])
    assert all(np.isfinite(v) for r in rows for v in r.values())

    # the saved DA-CLIP: strict into DaCLIP, and through the restorer, which
    # classifies, from the file and from the train dir
    model = TorchDaCLIP(TorchCfg.from_dict(get_model_config(NAME)), use_predictor=True)
    model.load_state_dict(tckpt.load_clip_state_dict(ckpts), strict=True)
    img = np.random.RandomState(0).rand(40, 48, 3).astype(np.float32)
    cfg = tpipe.RestorerConfig(model_name=NAME, dtype="float32", T=4)
    probs = []
    for daclip in (ckpts, tckpt.checkpoint_path(ckpts, 3, tckpt.EPOCH)):
        r = tpipe.DACLIPRestorer.load(os.path.join(FIXTURE, "unet.pth"), daclip, cfg,
                                      device="cpu")
        name, p = r.classify_degradation(img)
        assert name in tpipe.DEGRADATION_CLASSES and abs(sum(p.values()) - 1) < 1e-5
        probs.append(p)
    assert probs[0] == probs[1]
    # the factory takes the train dir as `pretrained`
    again = tfactory.create_model(NAME, pretrained=ckpts, use_predictor=True)
    _assert_sd_equal(again.state_dict(), tckpt.load_clip_state_dict(ckpts))


def test_cli_first_batches_equal_jax_loader(tmp_path):
    """At 0 workers the CLI's loader gives daclip_tpu's batches: the crop
    draws from the dataset's Random(seed), the transform's from a second
    stream with the same seed (the JAX CLI's global `random`, seeded here)."""
    root = str(tmp_path)
    train, val = _cli_tree(root)
    args = tparams.parse_args(_argv(root, train, val, 1))
    _, pp_train, pp_val = tfactory.create_model_and_transforms(
        NAME, seed=args.seed, rng=random.Random(args.seed))
    loader, banks, val_ds = tcli.build_data(args, pp_train, pp_val,
                                            partial(ttokenize, context_length=L))
    _, _, jpp_train, _ = jfactory.create_model_and_transforms(NAME)
    jds = jdata.CsvDataset(train, jpp_train, tokenizer=partial(jtokenize, context_length=L),
                           da=True, crop=True, seed=args.seed)
    jl = jloader.DataLoader(jds, batch_size=4, shuffle=True, num_workers=0, seed=args.seed)
    assert len(loader) == len(jl) == 2 and len(val_ds) == 4
    random.seed(args.seed)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jl.set_epoch(epoch)
        for ours, ref in zip(loader, jl):
            assert set(ours) == set(ref)
            for k in ours:
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for x, y in zip(banks, jds.banks()):
        np.testing.assert_array_equal(x, y)
    batch = tloader.to_device(next(iter(loader)), "cpu")
    assert batch["images"].shape == (4, 3, 32, 32) and batch["texts"].shape == (4, 2 * L)


def test_cli_fast_clip_view_first_batches_equal_jax_loader(tmp_path):
    """`--fast-clip-view`: the train set decodes with cv2 and takes the cv2
    view, as daclip_tpu's CLI builds it (its view draws from the global
    `random`, seeded here); the val set keeps the PIL path."""
    root = str(tmp_path)
    train, val = _cli_tree(root)
    args = tparams.parse_args(_argv(root, train, val, 1, "--fast-clip-view"))
    _, pp_train, pp_val = tfactory.create_model_and_transforms(
        NAME, seed=args.seed, rng=random.Random(args.seed))
    size = get_model_config(NAME)["vision_cfg"]["image_size"]
    loader, _, val_ds = tcli.build_data(args, pp_train, pp_val,
                                        partial(ttokenize, context_length=L), size)
    assert loader.dataset.decode == "cv2" and val_ds.decode == "pil"
    jds = jdata.CsvDataset(train, jtf.image_transform(size, is_train=True, backend="cv2"),
                           tokenizer=partial(jtokenize, context_length=L), da=True, crop=True,
                           seed=args.seed, decode="cv2")
    jl = jloader.DataLoader(jds, batch_size=4, shuffle=True, num_workers=0, seed=args.seed)
    random.seed(args.seed)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jl.set_epoch(epoch)
        for ours, ref in zip(loader, jl):
            assert set(ours) == set(ref)
            for k in ours:
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    plain = tcli.build_data(tparams.parse_args(_argv(root, train, val, 1)), pp_train, pp_val,
                            partial(ttokenize, context_length=L), size)[0]
    assert not np.array_equal(next(iter(plain))["images"], next(iter(loader))["images"])


@pytest.mark.parametrize("extra,match", [
    (["--mesh", "2"], "spans 2 processes, and this run has 1"),
    (["--report-to", "tensorboard,wandb"], "wandb is not a dependency of daclip_torch"),
    (["--imagenet-v2", "/data/v2"], "daclip_tpu parses it and no module of it evaluates")])
def test_cli_refuses_flags_it_does_not_carry(tmp_path, monkeypatch, extra, match):
    def no_work(*a, **k):
        raise AssertionError("work started")

    monkeypatch.setattr(tfactory, "create_model_and_transforms", no_work)
    argv = ["--model", NAME, "--logs", str(tmp_path), "--device", "cpu", *extra]
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv)
    assert not os.listdir(tmp_path)


def test_help_and_refusal_text_name_no_queue(capsys):
    """--fast-clip-view's help says what the flag does (the cv2 train
    transform, carried by the CLI), and the --report-to wandb refusal says
    why it refuses; neither names a ROADMAP queue."""
    with pytest.raises(SystemExit) as exit_:
        tparams.parse_args(["--help"])
    assert exit_.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    start = text.index("--fast-clip-view", text.index("options:"))
    flag = text[start:text.index("--device", start)]
    assert "the cv2 train transform: the CSV train set decoded by cv2" in flag
    assert "not ported" not in flag and "ROADMAP" not in text
    with pytest.raises(SystemExit) as refusal:
        tcli.refuse_unported(tparams.parse_args(["--report-to", "wandb"]))
    msg = str(refusal.value)
    assert msg.startswith("--report-to wandb: wandb is not a dependency of daclip_torch")
    assert "does not report to it (not queued)" in msg and "ROADMAP" not in msg


def test_cli_needs_a_device_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--model", NAME, "--logs", str(tmp_path), "--dataset-type", "synthetic"])
