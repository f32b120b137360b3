"""daclip_torch's offline data tools against daclip_tpu's on the CPU:
`tools.generate_lq` for each degradation type (two epochs, a crop, one
source smaller than the crop) and `tools.generate_masked`, run through
their `main` on the same folder and seed; the output trees hold the same
file names, the same decoded pixels and the same prompts JSON."""
import json
import os
import pathlib

import cv2
import numpy as np
import pytest
import torch

from daclip_torch.tools import generate_lq as t_lq
from daclip_torch.tools import generate_masked as t_masked
from daclip_tpu.tools import generate_lq as j_lq
from daclip_tpu.tools import generate_masked as j_masked

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """Three seeded images: two PNGs (one smaller than the crop, so it is
    reflect-padded) and a JPEG, and a file that is not an image."""
    root = tmp_path_factory.mktemp("src")
    rng = np.random.RandomState(0)
    for name, (h, w) in (("a.png", (60, 72)), ("b.jpg", (50, 66)), ("c.png", (30, 41))):
        cv2.imwrite(str(root / name), (rng.rand(h, w, 3) * 255).astype(np.uint8))
    (root / "notes.txt").write_text("not an image")
    return root


def _tree(root: pathlib.Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _assert_trees_equal(ours: pathlib.Path, ref: pathlib.Path):
    files = _tree(ours)
    assert files == _tree(ref) and files
    for rel in files:
        if rel.endswith(".json"):
            assert json.loads((ours / rel).read_text()) == json.loads((ref / rel).read_text())
        else:
            a = cv2.imread(str(ours / rel), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(ref / rel), cv2.IMREAD_UNCHANGED)
            assert a is not None and a.dtype == np.uint8, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
    return files


@pytest.mark.parametrize("deg_type", ["blur", "noisy", "resize", "jpeg"])
def test_generate_lq_tree_equals_jax(tmp_path, source, deg_type):
    argv = ["--source", str(source), "--deg-type", deg_type, "--mode", "val", "--epochs", "2",
            "--crop", "48", "--seed", "4"]
    np.random.seed(9)  # "noisy" draws from the global np.random in both
    j_lq.main(argv + ["--save", str(tmp_path / "jax")])
    np.random.seed(9)
    t_lq.main(argv + ["--save", str(tmp_path / "torch")])
    files = _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    levels = {"jpeg": 8}.get(deg_type, 36)  # 1-39 without 10, 20, 30 (or 10-80 by 10)
    assert len([f for f in files if f.endswith(".json")]) == levels
    assert len(files) == levels * (1 + 2 * 2 * 3)   # prompts, {GT, LQ} × 2 epochs × 3 images
    level = "blur0.5" if deg_type == "blur" else sorted(os.listdir(tmp_path / "torch" /
                                                                   "val"))[0]
    prompts = json.loads((tmp_path / "torch" / "val" / level /
                          "degraded_prompts.json").read_text())
    assert sorted(prompts) == [f"./{e}_{n}" for e in (0, 1) for n in ("a.png", "b.jpg",
                                                                       "c.png")]
    gt = cv2.imread(str(tmp_path / "torch" / "val" / level / "GT" / "0_c.png"))
    assert gt.shape == (48, 48, 3)


def test_generate_masked_tree_equals_jax(tmp_path, source, capsys):
    argv = ["--source", str(source), "--n", "20", "--seed", "2"]
    j_masked.main(argv + ["--save", str(tmp_path / "jax")])
    t_masked.main(argv + ["--save", str(tmp_path / "torch")])
    files = _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    assert files == [f"{d}/{n}" for d in ("GT", "LQ") for n in ("a.png", "b.jpg", "c.png")]
    assert capsys.readouterr().out.count("masked 3 images") == 2
