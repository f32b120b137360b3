"""daclip_torch's remote sync (`utils/file_utils.py`) and pretrained registry
(`models/pretrained.py`) against daclip_tpu's on the CPU, with no network:
`urllib.request.urlopen` raises in every registry test. The fsspec sync on
local paths, the s3/gs argv, the listing and the download for a resume, the
sync thread's final sync; the tag table and its lookups, a cache hit and a
sha256 mismatch, the HF-hub path's file names, and the factory loading a
registry tag from the cache."""
import os
import subprocess
import urllib.error
import urllib.request
import warnings

import jax
import numpy as np
import pytest
import torch

from daclip_torch import factory as tfactory
from daclip_torch.convert import clip_state_dict_from_jax, daclip_state_dict_from_jax
from daclip_torch.models import pretrained as tpre
from daclip_torch.utils import file_utils as tfu
from daclip_tpu import factory as jfactory
from daclip_tpu.models import pretrained as jpre
from daclip_tpu.utils import file_utils as jfu
from tests.test_torch_text import NAME, jax_daclip_params

torch.set_num_threads(1)


def _tree(root):
    files = {"out.log": b"log", "results.jsonl": b'{"step": 1}\n',
             "checkpoints/epoch_1.pt": b"x" * 40, "checkpoints/best/epoch_1.pt": b"y" * 7,
             "checkpoints/epoch_latest.pt": b"skip me"}
    for rel, data in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    return files


def _read(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_fsspec_sync_equals_jax(tmp_path):
    local = str(tmp_path / "local")
    files = _tree(local)
    for mod, name in ((tfu, "ours"), (jfu, "ref")):
        assert mod.remote_sync(local, str(tmp_path / name), "fsspec")
    ours, ref = _read(tmp_path / "ours"), _read(tmp_path / "ref")
    assert ours == ref == {k: v for k, v in files.items() if "epoch_latest" not in k}
    # same size: skipped; another size: copied again
    with open(os.path.join(local, "out.log"), "wb") as f:
        f.write(b"LOG")
    with open(os.path.join(local, "results.jsonl"), "ab") as f:
        f.write(b'{"step": 2}\n')
    for mod, name in ((tfu, "ours"), (jfu, "ref")):
        assert mod.remote_sync(local, str(tmp_path / name), "fsspec")
    ours = _read(tmp_path / "ours")
    assert ours == _read(tmp_path / "ref")
    assert ours["out.log"] == b"log" and ours["results.jsonl"].count(b"\n") == 2
    assert not tfu.remote_sync(local, str(tmp_path / "x"), "ftp")
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("rc", [0, 1])
def test_s3_and_gs_argv_equal_jax(monkeypatch, rc):
    calls = {}

    def fake_run(argv, **kw):
        calls.setdefault(pkg, []).append(list(argv))
        return subprocess.CompletedProcess(argv, rc, b"", b"denied")

    for pkg, mod in (("ours", tfu), ("ref", jfu)):
        monkeypatch.setattr(mod.subprocess, "run", fake_run)
        results = [mod.remote_sync("logs/run", "s3://b/run", "s3"),
                   mod.remote_sync("logs/run", "gs://b/run", "gs"),
                   mod.download_remote_dir("s3://b/run/checkpoints", "/tmp/none/a"),
                   mod.download_remote_dir("gs://b/run/checkpoints", "/tmp/none/b")]
        calls[pkg + "_results"] = results
    assert calls["ours"] == calls["ref"]
    assert calls["ours"][0] == ["aws", "s3", "sync", "logs/run", "s3://b/run", "--exclude",
                                "*epoch_latest*"]
    assert calls["ours"][1] == ["gsutil", "-m", "rsync", "-r", "-x", ".*epoch_latest.*",
                                "logs/run", "gs://b/run"]
    assert calls["ours_results"] == calls["ref_results"]
    assert calls["ours_results"][:2] == [rc == 0] * 2


def test_listing_download_and_exists_equal_jax(tmp_path):
    remote = str(tmp_path / "remote")
    _tree(remote)
    for path in (remote, os.path.join(remote, "checkpoints"), str(tmp_path / "missing"),
                 "file://" + os.path.join(remote, "checkpoints")):
        assert tfu.list_remote_dir(path) == jfu.list_remote_dir(path), path
    assert tfu.list_remote_dir(os.path.join(remote, "checkpoints")) == [
        "best", "epoch_1.pt", "epoch_latest.pt"]
    for path in (os.path.join(remote, "out.log"), str(tmp_path / "nope"),
                 "file://" + os.path.join(remote, "out.log"), "file://" + str(tmp_path / "no")):
        assert tfu.check_exists(path) == jfu.check_exists(path), path
    src = os.path.join(remote, "checkpoints")
    assert tfu.download_remote_dir(src, str(tmp_path / "a")) == str(tmp_path / "a")
    assert jfu.download_remote_dir(src, str(tmp_path / "b")) == str(tmp_path / "b")
    assert _read(tmp_path / "a") == _read(tmp_path / "b") == _read(src)


def test_sync_thread_syncs_on_its_clock_and_once_more_at_stop(tmp_path):
    local, remote = str(tmp_path / "local"), str(tmp_path / "remote")
    _tree(local)
    t = tfu.start_sync_process(0.05, local, remote, "fsspec")
    assert t.daemon and isinstance(t, tfu.SyncThread)
    t.start()
    with open(os.path.join(local, "late.txt"), "wb") as f:
        f.write(b"written before the stop")
    assert t.stop(final_sync=True)
    assert not t.is_alive()
    assert _read(remote)["late.txt"] == b"written before the stop"


# -- the registry -------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_tag_table_and_lookups_equal_jax():
    assert tpre._PRETRAINED == jpre._PRETRAINED
    assert tpre.list_pretrained() == jpre.list_pretrained()
    assert tpre.list_pretrained(as_str=True) == jpre.list_pretrained(as_str=True)
    for model in ("ViT-B-32", "daclip_ViT-B-32", "ViT-L-14", "RN50", "coca_ViT-B-32", "x"):
        assert (tpre.list_pretrained_tags_by_model(model)
                == jpre.list_pretrained_tags_by_model(model))
    for model, tag in (("ViT-B-32", "openai"), ("daclip_ViT-B-32", "laion2b_s34b_b79k"),
                       ("ViT-L-14", "laion2b-s32b-b82k"), ("ViT-B-16", "OpenAI"),
                       ("ViT-B-32", "datacomp_m_s128m_b4k"), ("RN50", "yfcc15m"),
                       ("ViT-B-32", "nope")):
        assert tpre.is_pretrained_cfg(model, tag) == jpre.is_pretrained_cfg(model, tag)
        assert tpre.get_pretrained_cfg(model, tag) == jpre.get_pretrained_cfg(model, tag)
        url = tpre.get_pretrained_url(model, tag)
        assert url == jpre.get_pretrained_url(model, tag)
        assert tpre._expected_sha256(url) == jpre._expected_sha256(url)
    assert tpre.get_pretrained_cfg("ViT-L-14", "laion2b_s32b_b82k")["mean"] == (0.5, 0.5, 0.5)
    assert len(tpre._expected_sha256(tpre.get_pretrained_url("ViT-B-32", "openai"))) == 64


def _seeded_file(path, seed=0, n=4096):
    data = np.random.RandomState(seed).bytes(n)
    with open(path, "wb") as f:
        f.write(data)
    import hashlib

    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("kind", ["openai", "mlfoundations", "plain", "file"])
def test_cache_hit_equals_jax(tmp_path, kind):
    """A cached file whose sha256 matches what the URL names is returned
    without a download (urlopen raises here)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    probe = str(tmp_path / "probe")
    sha = _seeded_file(probe)
    url = {"openai": f"https://openaipublic.azureedge.net/clip/models/{sha}/tiny.pt",
           "mlfoundations": ("https://github.com/mlfoundations/open_clip/releases/download/"
                             f"v0.2-weights/tiny-{sha[:8]}.pt"),
           "plain": "https://example.invalid/weights/tiny.pt",
           "file": f"file://{tmp_path}/src/tiny.pt"}[kind]
    os.replace(probe, cache / os.path.basename(url))
    got = tpre.download_pretrained_from_url(url, cache_dir=str(cache))
    assert got == jpre.download_pretrained_from_url(url, cache_dir=str(cache))
    assert got == str(cache / os.path.basename(url))
    assert tpre.download_pretrained({"url": url}, cache_dir=str(cache)) == got


def test_sha_mismatch_downloads_again_as_jax(tmp_path):
    """A cached file whose hash differs: a warning, then a download through
    a `.part` file, which fails here as it does in daclip_tpu; the cache
    keeps no `.part`."""
    cache = tmp_path / "cache"
    cache.mkdir()
    sha = "0" * 64
    url = f"https://openaipublic.azureedge.net/clip/models/{sha}/tiny.pt"
    _seeded_file(cache / "tiny.pt", seed=1)
    for mod in (tpre, jpre):
        with pytest.warns(UserWarning, match="sha256 mismatches"):
            with pytest.raises(urllib.error.URLError, match="no network"):
                mod.download_pretrained_from_url(url, cache_dir=str(cache))
        assert sorted(os.listdir(cache)) == ["tiny.pt"]
    (cache / "dir.pt").mkdir()
    for mod in (tpre, jpre):
        with pytest.raises(RuntimeError, match="not a regular file"):
            mod.download_pretrained_from_url("https://x.invalid/dir.pt", cache_dir=str(cache))
    assert tpre.download_pretrained({}) == jpre.download_pretrained({}) == ""


def test_hf_hub_tags_name_the_same_files(monkeypatch, tmp_path):
    import huggingface_hub

    seen = []
    monkeypatch.setattr(huggingface_hub, "hf_hub_download",
                        lambda repo, name, cache_dir=None: seen.append((repo, name, cache_dir))
                        or f"{cache_dir}/{repo}/{name}")
    for cfg in (tpre.get_pretrained_cfg("ViT-B-32", "laion2b_s34b_b79k"),
                {"hf_hub": "org/model/weights.pt"}):
        assert (tpre.download_pretrained(cfg, cache_dir=str(tmp_path))
                == jpre.download_pretrained(cfg, cache_dir=str(tmp_path)))
    assert seen[0] == seen[1] == ("laion/CLIP-ViT-B-32-laion2B-s34B-b79K",
                                  "open_clip_pytorch_model.bin", str(tmp_path))
    assert seen[2] == seen[3] == ("org/model", "weights.pt", str(tmp_path))


@pytest.mark.parametrize("ckpt", ["clip", "daclip"])
def test_factory_loads_a_registry_tag_as_jax(tmp_path, monkeypatch, ckpt):
    """A tag registered for daclip_test-tiny in both tables, its file in the
    cache under an mlfoundations URL naming its hash: both factories resolve
    it and load the same weights (a plain CLIP is copied into the
    controller); an unknown tag is refused by both."""
    jp = jax_daclip_params(seed=2)
    src = str(tmp_path / "w.pt")
    torch.save(clip_state_dict_from_jax(jp["clip"]) if ckpt == "clip"
               else daclip_state_dict_from_jax(jp), src)
    import hashlib

    sha = hashlib.sha256(open(src, "rb").read()).hexdigest()
    url = ("https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/"
           f"tiny-{sha[:8]}.pt")
    cache = tmp_path / "cache"
    cache.mkdir()
    os.replace(src, cache / os.path.basename(url))
    for mod in (tpre, jpre):
        monkeypatch.setitem(mod._PRETRAINED, "test-tiny", {"seeded": mod._pcfg(url)})
    ours = tfactory.create_model(NAME, pretrained="seeded", cache_dir=str(cache),
                                 use_predictor=True)
    _, ref = jfactory.create_model(NAME, pretrained="seeded", cache_dir=str(cache),
                                   use_predictor=True)
    want = daclip_state_dict_from_jax(jax.tree.map(np.asarray, ref))
    got = ours.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if ckpt == "clip" and k.startswith("predictor."):
            continue  # seeded on each side
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)
    for mod in (tfactory, jfactory):
        with pytest.raises(FileNotFoundError, match="neither a local file nor a known tag"):
            mod.create_model(NAME, pretrained="no-such-tag")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tfactory.tag_cfg(NAME, "seeded")["url"] == url
    assert tfactory.tag_cfg(NAME, str(cache)) == {}
