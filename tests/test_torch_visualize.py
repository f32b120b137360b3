"""daclip_torch's tools/visualize against daclip_tpu's on the CPU, on seeded
embedding dumps: every function of both packages runs on the same inputs;
the cosine heatmap's matrix and the Spearman monotonicity are equal, and
every PNG is written (matplotlib and sklearn are here; UMAP is not, so
`--method umap` falls back to t-SNE in both)."""
import json
import os

import numpy as np
import pytest
import torch

from daclip_torch.data import png
from daclip_torch.tools import visualize as tviz
from daclip_tpu.tools import visualize as jviz

torch.set_num_threads(1)
LABELS = [f"{t}{lv}" for t, levels in (("blur", ("05", "10", "20")),
                                       ("noisy", ("15", "25", "35"))) for lv in levels]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """An encode_folder-style dump: 6 classes × 5 unit embeddings that drift
    away from the lowest level as the level grows, labels, filenames and the
    generate_lq prompts json."""
    root = tmp_path_factory.mktemp("viz")
    rng = np.random.RandomState(0)
    base = {t: rng.randn(16) for t in ("blur", "noisy")}
    drift = {t: rng.randn(16) for t in ("blur", "noisy")}
    feats, labels, names, prompts = [], [], [], {}
    for lab in LABELS:
        t, lv = tviz._split_label(lab)
        for i in range(5):
            f = base[t] + 0.15 * lv * drift[t] + 0.05 * rng.randn(16)
            feats.append(f / np.linalg.norm(f))
            labels.append(lab)
            names.append(f"{lab}_{i}.png")
            prompts[f"./{lab}_{i}.png"] = f"{t} with parameter {lv}"
    emb = root / "emb"
    emb.mkdir()
    np.save(emb / "all_embeddings.npy", np.asarray(feats, np.float32))
    np.save(emb / "labels.npy", np.asarray(labels))
    np.save(emb / "filenames.npy", np.asarray(names))
    (root / "prompts.json").write_text(json.dumps(prompts))
    for lv in ("0.5", "1.0", "1.5"):
        for sub in ("GT", "LQ"):
            (root / "levels" / f"blur{lv}" / sub).mkdir(parents=True)
            png.write(str(root / "levels" / f"blur{lv}" / sub / "a.png"),
                      (rng.rand(24, 20, 3) * 255).astype(np.uint8))
    return root


def test_monotonicity_and_heatmap_equal_jax(dump, tmp_path):
    feats, labels = tviz.load_embeddings(str(dump / "emb"))
    jf, jl = jviz.load_embeddings(str(dump / "emb"))
    np.testing.assert_array_equal(feats, jf)
    np.testing.assert_array_equal(labels, jl)
    got, want = tviz.embedding_monotonicity(feats, labels), jviz.embedding_monotonicity(jf, jl)
    assert got == want and set(got) == {"blur", "noisy"}
    assert all(v["spearman_rho"] == 1.0 for v in got.values())
    sim, classes = tviz.cosine_heatmap(feats, labels, str(tmp_path / "ours.png"))
    jsim, jclasses = jviz.cosine_heatmap(jf, jl, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(sim, jsim)
    assert classes == jclasses == sorted(LABELS)
    assert (tmp_path / "ours.png").stat().st_size > 0


@pytest.mark.parametrize("method", ["tsne", "umap"])
def test_projections_write_their_pngs(dump, tmp_path, method):
    feats, labels = tviz.load_embeddings(str(dump / "emb"))
    names = np.load(dump / "emb" / "filenames.npy")
    prompts = json.loads((dump / "prompts.json").read_text())
    for pkg, mod in (("jax", jviz), ("torch", tviz)):
        out = tmp_path / f"{pkg}_{method}.png"
        assert mod.plot_projection(feats, labels, str(out), method) == str(out)
        assert out.stat().st_size > 0
        out = tmp_path / f"{pkg}_param_{method}.png"
        assert mod.param_colored_projection(feats, names, prompts, str(out), method) == str(out)
        assert out.stat().st_size > 0
    with pytest.raises(ValueError, match="no filenames matched"):
        tviz.param_colored_projection(feats, names, {}, str(tmp_path / "x.png"))


def test_residual_grid_and_main_equal_jax(dump, tmp_path):
    outs = {}
    for pkg, mod in (("jax", jviz), ("torch", tviz)):
        out = tmp_path / pkg
        mod.main(["--embeddings", str(dump / "emb"), "--out", str(out), "--heatmap",
                  "--monotonicity", "--param-json", str(dump / "prompts.json"),
                  "--residual-root", str(dump / "levels"), "--residual-levels", "0.5,1.0,1.5"])
        outs[pkg] = out
        assert sorted(os.listdir(out)) == ["cosine_heatmap.png", "monotonicity.json",
                                           "param_tsne.png", "residual_grid.png", "tsne.png"]
    assert (json.loads((outs["torch"] / "monotonicity.json").read_text())
            == json.loads((outs["jax"] / "monotonicity.json").read_text()))
    grid = tmp_path / "grid.png"
    assert tviz.residual_grid(str(dump / "levels"), "blur", ["0.5", "1.0"], "a.png",
                              str(grid)) == str(grid)
    assert grid.stat().st_size > 0
    with pytest.raises(SystemExit):
        tviz.main(["--out", str(tmp_path / "none")])
