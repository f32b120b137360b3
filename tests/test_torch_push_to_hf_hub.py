"""daclip_torch's tools/push_to_hf_hub against daclip_tpu's: the upload
folder (config.json, model card, the checkpoint copied as a file or a
directory) and the upload, through a stand-in `huggingface_hub` module, so
no network is touched."""
import json
import os
import sys
import types

import pytest
import torch

from daclip_torch.tools import push_to_hf_hub as tpush
from daclip_tpu.tools import push_to_hf_hub as jpush

torch.set_num_threads(1)


def _tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _checkpoint(tmp_path, kind):
    """A `.pt`, a `.npz`, or a train dir of `<step>.pt` files."""
    if kind == "dir":
        d = tmp_path / "run"
        d.mkdir()
        for step in (2, 4):
            torch.save({"step": step}, str(d / f"{step}.pt"))
        return str(d) + "/"
    p = tmp_path / f"model.{kind}"
    p.write_bytes(bytes(range(256)) * 4)
    return str(p)


@pytest.mark.parametrize("kind", ["pt", "npz", "dir"])
@pytest.mark.parametrize("model", ["daclip_ViT-B-32", "daclip_test-tiny"])
def test_payload_equals_jax_apart_from_the_framework_name(tmp_path, kind, model):
    ckpt = _checkpoint(tmp_path, kind)
    ours = _tree(tpush.build_payload(ckpt, model, str(tmp_path / "t")))
    ref = _tree(jpush.build_payload(ckpt, model, str(tmp_path / "j")))
    assert set(ours) == set(ref)
    card = ref.pop("README.md").decode()
    for a, b in (("daclip-tpu", "daclip-torch"), ("daclip_tpu", "daclip_torch"),
                 ("JAX/TPU", "PyTorch/CUDA")):
        card = card.replace(a, b)
    assert ours.pop("README.md").decode() == card
    assert ours == ref
    cfg = json.loads(ours["config.json"])
    assert cfg["model_name"] == model and set(cfg) == {"model_cfg", "model_name"}
    base = os.path.basename(ckpt.rstrip("/"))
    assert any(k == base or k.startswith(base + os.sep) for k in ours)


class _Recorder:
    """A stand-in `huggingface_hub.HfApi`: records its calls and the upload
    folder's files (read while the folder exists)."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, token=None):
        self.calls.append(("HfApi", {"token": token}))
        return self

    def create_repo(self, repo_id, **kw):
        self.calls.append(("create_repo", dict(repo_id=repo_id, **kw)))

    def upload_folder(self, **kw):
        self.calls.append(("upload_folder", dict(kw, files=sorted(_tree(kw["folder_path"])))))


def _push(monkeypatch, module, ckpt, **kw):
    calls = []
    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(HfApi=_Recorder(calls)))
    url = module.push_to_hf_hub(ckpt, "daclip_ViT-B-32", "user/daclip", **kw)
    for _, c in calls:
        c.pop("folder_path", None)   # a temporary directory of each call's own
    return url, calls


@pytest.mark.parametrize("private", [False, True])
def test_upload_reaches_hfapi_with_jax_arguments(tmp_path, monkeypatch, private):
    ckpt = _checkpoint(tmp_path, "pt")
    ours = _push(monkeypatch, tpush, ckpt, private=private, token="t0")
    assert ours == _push(monkeypatch, jpush, ckpt, private=private, token="t0")
    url, calls = ours
    assert url == "https://huggingface.co/user/daclip"
    assert [c[0] for c in calls] == ["HfApi", "create_repo", "upload_folder"]
    assert calls[1][1] == {"repo_id": "user/daclip", "private": private, "exist_ok": True}
    assert calls[2][1] == {"repo_id": "user/daclip",
                           "files": ["README.md", "config.json", "model.pt"]}


def test_main_prints_the_url_and_a_missing_hub_raises(tmp_path, monkeypatch, capsys):
    ckpt = _checkpoint(tmp_path, "npz")
    calls = []
    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(HfApi=_Recorder(calls)))
    tpush.main(["--checkpoint", ckpt, "--model", "daclip_ViT-B-32", "--repo-id", "u/r",
                "--private"])
    assert capsys.readouterr().out.strip() == "https://huggingface.co/u/r"
    assert calls[1][1]["private"] is True
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)   # import fails
    with pytest.raises(ImportError) as ours:
        tpush.push_to_hf_hub(ckpt, "daclip_ViT-B-32", "u/r")
    with pytest.raises(ImportError) as ref:
        jpush.push_to_hf_hub(ckpt, "daclip_ViT-B-32", "u/r")
    assert str(ours.value) == str(ref.value)
