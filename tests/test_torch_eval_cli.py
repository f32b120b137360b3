"""daclip_torch's eval CLIs and tools against daclip_tpu's on the CPU, on the
same `.npz` (daclip_tpu's `save_params_npz` of a `daclip_test-tiny` DaCLIP
initialised from a fixed PRNGKey, with and without the level predictor) and
the same seeded class tree (3 classes × 3 PNGs, <class>/LQ): evaluate_daclip,
evaluate_numclip and encode_folder, each file they write; parse_checkpoint_
spec; imagenet_zero_shot.evaluate_with_encoders on the same encoders'
outputs; inspect_checkpoint on every kind the port reads; empty orbax dirs
an error (the fixture's orbax dirs: tests/test_torch_orbax.py).

Both packages run DaCLIP in bf16, which rounds differently in each: the
features are held to FEAT_TOL, and a classification row is held equal only
where daclip_tpu's top-1 cosine margin exceeds twice that."""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.data import png
from daclip_torch.eval import evaluate_daclip as t_daclip
from daclip_torch.eval import evaluate_numclip as t_numclip
from daclip_torch.eval import imagenet_zero_shot as t_zs
from daclip_torch.eval import parse_checkpoint_spec
from daclip_torch.tools import encode_folder as t_encode
from daclip_torch.tools import inspect_checkpoint as t_inspect
from daclip_torch.utils import checkpoint as tckpt
from daclip_tpu.eval import evaluate_daclip as j_daclip
from daclip_tpu.eval import evaluate_numclip as j_numclip
from daclip_tpu.eval import imagenet_zero_shot as j_zs
from daclip_tpu.eval import parse_checkpoint_spec as j_parse
from daclip_tpu.models import CLIPCfg, DaCLIP, get_model_config
from daclip_tpu.tools import encode_folder as j_encode
from daclip_tpu.tools import inspect_checkpoint as j_inspect
from daclip_tpu.utils.native_checkpoint import save_params_npz

torch.set_num_threads(1)
NAME = "daclip_test-tiny"
FEAT_TOL = 2e-2        # bf16 features, abs (tests/test_eval.py's unit-norm tolerance)
CLASSES = ["blur05", "blur20", "noisy25"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(root, {with/without predictor: .npz}, class tree, flat folder)."""
    root = tmp_path_factory.mktemp("evalcli")
    cfg = CLIPCfg.from_dict(get_model_config(NAME))
    L, res = cfg.text.context_length, cfg.vision.image_size
    npz = {}
    for pred in (True, False):
        model = DaCLIP(cfg, use_predictor=pred)
        params = model.init(jax.random.PRNGKey(0), image=jnp.zeros((1, res, res, 3)),
                            text=jnp.zeros((1, 2 * L), jnp.int32),
                            all_d_type_tokens=jnp.zeros((28, L), jnp.int32),
                            bin_center_bank=jnp.zeros((4, 7)))["params"]
        npz[pred] = str(root / f"tiny_{'pred' if pred else 'nopred'}.npz")
        save_params_npz(npz[pred], jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(0)
    tree, flat = root / "tree", root / "flat"
    flat.mkdir()
    for ci, cname in enumerate(CLASSES):
        (tree / cname / "LQ").mkdir(parents=True)
        for i in range(3):
            h, w = rng.randint(36, 60, 2)
            img = np.clip(rng.rand(h, w, 3) * (0.3 + 0.35 * ci) + 0.1 * i, 0, 1)
            png.write(str(tree / cname / "LQ" / f"{i}.png"), (img * 255).astype(np.uint8))
    for name in ("lvl05", "lvl10", "lvl20"):
        png.write(str(flat / f"{name}.png"), (rng.rand(40, 44, 3) * 255).astype(np.uint8))
    return root, npz, tree, flat


def _jax_margins(npz, tree):
    """daclip_tpu's top-1 cosine margins of each image of the tree, in its
    order, over the fine and the base classes (bf16, as its CLIs run)."""
    from daclip_tpu.data.util import read_img
    from daclip_tpu.tokenizer import tokenize
    from daclip_tpu.transforms import clip_transform
    from daclip_tpu.utils.native_checkpoint import load_params_npz

    cfg = CLIPCfg.from_dict(get_model_config(NAME))
    model = DaCLIP(cfg, dtype=jnp.bfloat16)
    params = {"params": {k: v for k, v in load_params_npz(npz).items() if k != "predictor"}}
    text = lambda names: np.asarray(model.apply(
        params, jnp.asarray(tokenize(names, context_length=cfg.text.context_length)),
        normalize=True, method=model.encode_text), np.float32)
    views = [clip_transform(read_img(None, str(tree / c / "LQ" / f))[:, :, ::-1],
                            cfg.vision.image_size)
             for c in CLASSES for f in sorted(os.listdir(tree / c / "LQ"))]
    _, degra = model.apply(params, jnp.asarray(np.stack(views)), control=True, normalize=True,
                           method=model.encode_image)
    degra = np.asarray(degra, np.float32)
    out = []
    for names in (CLASSES, sorted({c.rstrip("0123456789") for c in CLASSES})):
        s = np.sort(degra @ text(names).T, axis=-1)
        out.append(s[:, -1] - s[:, -2])
    return out


@pytest.fixture(scope="module")
def runs(setup):
    """Each eval CLI of both packages over the tree, two checkpoints each
    (so compare_checkpoints runs too): {(package, cli): (out dir, result)}."""
    root, npz, tree, _ = setup
    ckpts = ["--checkpoint", f"pred={npz[True]}", "--checkpoint", f"nopred={npz[False]}"]
    out = {}
    for pkg, mods, extra in (("jax", (j_daclip, j_numclip), []),
                             ("torch", (t_daclip, t_numclip), ["--device", "cpu"])):
        for cli, mod in zip(("daclip", "numclip"), mods):
            d = root / f"{pkg}_{cli}"
            res, real = {}, mod.evaluate_checkpoint

            def spy(path, *a, display_name=None, **kw):   # main's per-checkpoint results
                res[display_name] = real(path, *a, display_name=display_name, **kw)
                return res[display_name]

            mod.evaluate_checkpoint = spy
            try:
                mod.main(["--dataset", str(tree), *ckpts, "--model", NAME, "--batch-size",
                          "2", "--out-dir", str(d), *extra])
            finally:
                mod.evaluate_checkpoint = real
            out[pkg, cli] = (d, res)
    return out


@pytest.fixture(scope="module")
def held(setup):
    """The images, in tree order, whose fine-class and base-class
    predictions both packages must agree on: daclip_tpu's top-1 margin
    exceeds 2 · FEAT_TOL in both."""
    root, npz, tree, _ = setup
    fine, base = _jax_margins(npz[True], tree)
    ok = (fine > 2 * FEAT_TOL) & (base > 2 * FEAT_TOL)
    assert ok.sum() >= 6, (fine, base)   # most rows are held
    return ok


def _csv_rows(path):
    with open(path) as f:
        return f.read().splitlines()


def test_evaluate_daclip_files_equal_jax(runs, held):
    (jd, jres), (td, tres) = runs["jax", "daclip"], runs["torch", "daclip"]
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    assert set(jres) == set(tres) == {"pred", "nopred"}
    by_class = held.reshape(len(CLASSES), 3).all(axis=1)
    for name in ("pred", "nopred"):
        j_rows = _csv_rows(jd / f"per_class_accuracy_{name}.csv")
        t_rows = _csv_rows(td / f"per_class_accuracy_{name}.csv")
        assert j_rows[0] == t_rows[0] == "class,correct,total,accuracy"
        j_cm = _csv_rows(jd / f"confusion_matrix_{name}.csv")
        t_cm = _csv_rows(td / f"confusion_matrix_{name}.csv")
        assert j_cm[0] == t_cm[0] == "# " + ",".join(CLASSES)     # the header
        for ci in np.flatnonzero(by_class):
            assert j_rows[1 + ci] == t_rows[1 + ci]
            assert j_cm[1 + ci] == t_cm[1 + ci]
            assert jres[name]["full_class_acc"][ci] == tres[name]["full_class_acc"][ci]
        for key in ("classes", "base_classes"):
            assert jres[name][key] == tres[name][key]
        if by_class.all():
            for key in ("accuracy", "base_accuracy", "base_class_acc"):
                assert jres[name][key] == tres[name][key]
        assert 0 <= tres[name]["accuracy"] <= 1 and 0 <= tres[name]["base_accuracy"] <= 1
    for png_name in ("base_class_accuracy_table.png", "compare_base_class_accuracy.png",
                     "compare_full_class_accuracy.png", "confusion_matrix_pred.png"):
        assert (td / png_name).exists()


def test_evaluate_numclip_files_equal_jax(runs, held):
    from daclip_torch.data.csv_dataset import build_banks

    (jd, jres), (td, tres) = runs["jax", "numclip"], runs["torch", "numclip"]
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    emb = sorted(os.listdir(jd / "embeddings"))
    assert emb == sorted(os.listdir(td / "embeddings")) == sorted(
        [f"{c}_embeddings.npy" for c in CLASSES] + ["all_embeddings.npy", "labels.npy"])
    for f in emb:
        a, b = np.load(jd / "embeddings" / f), np.load(td / "embeddings" / f)
        if f == "labels.npy":
            np.testing.assert_array_equal(a, b)
        else:
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, atol=FEAT_TOL)
    # the regression head amplifies the features' bf16 rounding by 1 / 0.07 in its
    # softmax: held to FEAT_TOL of each type's largest bin center
    scale = build_banks()[0].max(axis=1)
    for name in ("pred", "nopred"):
        j_pred, t_pred = (_csv_rows(d / f"predictions_{name}.csv") for d in (jd, td))
        assert j_pred[0] == t_pred[0] == "filename,ground_truth,prediction"
        for k in np.flatnonzero(held):
            assert j_pred[1 + k] == t_pred[1 + k]
        j_reg, t_reg = (_csv_rows(d / f"regression_values_{name}.csv") for d in (jd, td))
        assert j_reg[0] == t_reg[0]
        for a, b in zip(j_reg[1:], t_reg[1:]):
            a, b = a.split(","), b.split(",")
            assert a[4:] == b[4:]                             # gt_val, type
            diff = np.abs(np.float64(b[:4]) - np.float64(a[:4]))
            assert (diff <= FEAT_TOL * scale + 1e-4).all(), (a, b)   # + the %.4f rounding
            if name == "nopred":
                assert b[:4] == ["0.0000"] * 4
        j_cm, t_cm = (_csv_rows(d / f"confusion_matrix_{name}.csv") for d in (jd, td))
        assert not j_cm[0].startswith("#") and not t_cm[0].startswith("#")   # no header
        for ci in np.flatnonzero(held.reshape(len(CLASSES), 3).all(axis=1)):
            assert j_cm[ci] == t_cm[ci]
        assert set(jres[name]["regression_mae"]) == set(tres[name]["regression_mae"])
        for t, v in jres[name]["regression_mae"].items():
            assert abs(tres[name]["regression_mae"][t] - v) <= FEAT_TOL * scale[
                ["blur", "noisy", "resize", "jpeg"].index(t)]
            assert np.isfinite(tres[name]["regression_mae"][t])
    assert tres["nopred"]["regression_mae"] == {}
    assert tres["pred"]["regression_mae"]
    assert (td / "confusion_matrix_pred.png").exists()


def test_gt_value_from_class_equals_jax():
    for c in ("blur05", "blur20", "resize4", "noisy25", "jpeg30", "rainy", "low-light10"):
        assert t_numclip._gt_value_from_class(c) == j_numclip._gt_value_from_class(c)


@pytest.mark.parametrize("features", ["degra", "image"])
def test_encode_folder_dumps_equal_jax(setup, features):
    """Both layouts: the flat folder (labels are the stems) and the class
    tree (labels are the classes, images under <class>/LQ)."""
    root, npz, tree, flat = setup
    for src in (flat, tree):
        dirs = {pkg: root / f"enc_{pkg}_{src.name}_{features}" for pkg in ("jax", "torch")}
        base = ["--input", str(src), "--checkpoint", npz[True], "--model", NAME,
                "--batch-size", "2", "--features", features]
        j_encode.main(base + ["--out", str(dirs["jax"])])
        n = t_encode.main(base + ["--out", str(dirs["torch"]), "--device", "cpu"])
        assert n == (3 if src == flat else 9)
        files = sorted(os.listdir(dirs["jax"]))
        assert files == sorted(os.listdir(dirs["torch"])) == sorted(
            ["all_embeddings.npy", "degra_embeddings.npy", "image_embeddings.npy",
             "labels.npy", "filenames.npy"])
        for f in files:
            a, b = np.load(dirs["jax"] / f), np.load(dirs["torch"] / f)
            if a.dtype.kind == "U":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(b, a, atol=FEAT_TOL)
                np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=FEAT_TOL)
        chosen = "degra_embeddings.npy" if features == "degra" else "image_embeddings.npy"
        np.testing.assert_array_equal(np.load(dirs["torch"] / "all_embeddings.npy"),
                                      np.load(dirs["torch"] / chosen))
    assert list(np.load(dirs["torch"] / "labels.npy")) == [c for c in CLASSES for _ in range(3)]


def test_parse_checkpoint_spec_equals_jax(tmp_path):
    existing = tmp_path / "epoch=5.pt"
    existing.write_bytes(b"")
    for spec in ("best=runs/a/epoch_3.pt", "runs/a/epoch_3.pt", str(existing),
                 "=x.npz", "name=with=equals.pt"):
        assert parse_checkpoint_spec(spec) == j_parse(spec), spec
    assert parse_checkpoint_spec(str(existing)) == ("epoch=5", str(existing))
    assert parse_checkpoint_spec("best=a.pt") == ("best", "a.pt")


def test_zero_shot_with_encoders_equals_jax(setup):
    """Both packages' evaluate_with_encoders on encoders that give the same
    numbers (numpy projections of the tokens and of the views): the
    classifier over the dir names × the 80 templates, then top-1/top-5."""
    _, _, tree, _ = setup
    zs_tree = tree.parent / "zs"
    for c in CLASSES:
        (zs_tree / c).mkdir(parents=True)
        for f in os.listdir(tree / c / "LQ"):
            os.link(tree / c / "LQ" / f, zs_tree / c / f)
    rng = np.random.RandomState(7)
    emb = rng.randn(49408, 16).astype(np.float32)
    proj = rng.randn(32 * 32 * 3, 16).astype(np.float32)

    def text_np(toks):
        f = emb[np.asarray(toks)].sum(axis=1)
        return f / np.linalg.norm(f, axis=-1, keepdims=True)

    def image_np(views):
        f = np.asarray(views, np.float32).reshape(len(views), -1) @ proj
        return f / np.linalg.norm(f, axis=-1, keepdims=True)

    want = j_zs.evaluate_with_encoders(lambda v: jnp.asarray(image_np(v)),
                                       lambda t: jnp.asarray(text_np(t)), str(zs_tree), 32,
                                       batch_size=2)
    got = t_zs.evaluate_with_encoders(image_np, lambda t: torch.from_numpy(text_np(t.numpy())),
                                      str(zs_tree), 32, batch_size=2, device="cpu")
    assert got == want
    assert set(got) == {"imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5"}


def test_inspect_checkpoint_equals_jax_on_the_npz(setup):
    _, npz, _, _ = setup
    lines = {}
    for pkg, mod in (("jax", j_inspect), ("torch", t_inspect)):
        tree, fmt = mod.load_tree(npz[True])
        lines[pkg] = []
        counts = mod.describe(tree, fmt, _print=lines[pkg].append)
        lines[pkg].append(counts)
    assert lines["torch"] == lines["jax"]
    limited = []
    t_inspect.describe(*t_inspect.load_tree(npz[True]), keys_only=True, limit=3,
                       _print=limited.append)
    assert len(limited) == 2 + 3 + 2 and limited[-2].startswith("... (")


def test_inspect_checkpoint_reads_each_kind_of_the_port(tmp_path, setup):
    _, npz, _, _ = setup
    from daclip_torch.utils.native_checkpoint import load_daclip_any

    sd = load_daclip_any(npz[True])
    pt = tmp_path / "daclip.pt"
    torch.save(sd, pt)
    tree, fmt = t_inspect.load_tree(str(pt))
    assert fmt == "torch" and set(tree) == set(sd)
    restoration, clip_dir = tmp_path / "training_state", tmp_path / "checkpoints"
    for n in (2, 4):
        tckpt._save(str(restoration), n, {"params": {"w": torch.ones(2, 3)}, "step": n}, None)
        tckpt._save(str(clip_dir), n // 2, {"state_dict": {"w": torch.ones(5)},
                                            "epoch": n // 2}, None, tckpt.EPOCH)
    tree, fmt = t_inspect.load_tree(str(restoration))
    assert fmt == "train_dir (step 4)" and tree["step"] == 4
    tree, fmt = t_inspect.load_tree(str(clip_dir), step=1)
    assert fmt == "clip_train_dir (epoch 1)" and tree["epoch"] == 1
    assert t_inspect.main([str(clip_dir)]) == {"leaves": 2, "elements": 5}   # w, epoch


def test_orbax_dirs_are_refused_by_both_tools(tmp_path, setup):
    """An orbax dir the tools read (the fixture daclip_tpu's train_daclip
    wrote) lists as daclip_tpu's tool lists it and encodes; an empty one
    raises FileNotFoundError in both tools."""
    _, _, tree, _ = setup
    fixture = pathlib.Path(__file__).parent / "fixtures" / "orbax" / "daclip"
    lines = {}
    for pkg, mod in (("jax", j_inspect), ("torch", t_inspect)):
        lines[pkg] = []
        lines[pkg].append(mod.describe(*mod.load_tree(str(fixture)), keys_only=True,
                                       _print=lines[pkg].append))
    assert lines["torch"] == lines["jax"]
    out = tmp_path / "enc"
    assert t_encode.encode_folder(str(fixture), str(tree), str(out), NAME, device="cpu") == 9
    assert np.load(out / "all_embeddings.npy").shape == (9, 32)
    (tmp_path / "orbax" / "100").mkdir(parents=True)
    for path in (tmp_path / "orbax", tmp_path / "orbax" / "100"):
        with pytest.raises(FileNotFoundError):
            t_inspect.load_tree(str(path))
        with pytest.raises(FileNotFoundError):
            t_encode.encode_folder(str(path), str(tree), str(tmp_path / "x"), NAME,
                                   device="cpu")
