"""daclip_torch's `tools/generate_captions` and `serve/gradio_app` against
daclip_tpu's on the CPU: the caption CSVs byte for byte (both model-free
captioners, the prompts file, a GT without its LQ, the merge) and what each
CLI prints; BLIP through a stand-in `transformers` on the explicit device;
both packages' Gradio handlers through a stand-in `gradio` module on the
tiny fixture restorer at sample_T 3 (the degradation name equal, the image
the restorer's own output as RGB), `main`'s restorer config (`--wild-ir`)
and port, and the exit without gradio."""
import contextlib
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from daclip_torch import pipeline as tpipe
from daclip_torch.serve import gradio_app as tgr
from daclip_torch.tools import generate_captions as tgc
from daclip_tpu import pipeline as jpipe
from daclip_tpu.serve import gradio_app as jgr
from daclip_tpu.tools import generate_captions as jgc

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(__file__), "parity", "fixtures", "e2e")


def _caption_tree(root):
    rng = np.random.RandomState(8)
    for deg, names in (("noisy", ["0001_a-red_car.png", "0002_two_dogs.png", "0003.png"]),
                       ("rainy", ["im_b.png", "im_a.png"])):
        for sub in ("GT", "LQ"):
            os.makedirs(os.path.join(root, deg, sub))
        for i, name in enumerate(names):
            img = (rng.rand(12, 10 + i, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, deg, "GT", name))
            if name != "0003.png":  # a GT without its LQ is skipped
                Image.fromarray(img[::-1]).save(os.path.join(root, deg, "LQ", name))
    with open(os.path.join(root, "rainy", "degraded_prompts.json"), "w") as f:
        json.dump({"./im_a.png": "rainy with heavy streaks"}, f)
    os.makedirs(os.path.join(root, "empty"))


def _run(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*a)
    return out.getvalue()


@pytest.mark.parametrize("captioner", ["constant", "filename"])
def test_caption_csvs_equal_jax_byte_for_byte(tmp_path, captioner):
    trees = {}
    for pkg, mod in (("ours", tgc), ("ref", jgc)):
        root = str(tmp_path / pkg)
        _caption_tree(root)
        said = _run(mod.main, ["captions", "--dataroot", root, "--captioner", captioner,
                               "--mode", "val"])
        merged = os.path.join(root, "all.csv")
        said += _run(mod.main, ["merge", "--root", root, "--output", merged, "--csv-name",
                                "daclip_val.csv"])
        files = {}
        for d in ("noisy", "rainy"):
            files[d] = open(os.path.join(root, d, "daclip_val.csv"), "rb").read()
        files["all"] = open(merged, "rb").read()
        trees[pkg] = (root, files, said)
    (r_ours, ours, said_ours), (r_ref, ref, said_ref) = trees["ours"], trees["ref"]
    norm = lambda files, root: {k: v.replace(root.encode(), b"ROOT") for k, v in files.items()}
    assert norm(ours, r_ours) == norm(ref, r_ref)
    assert said_ours.replace(r_ours, "ROOT") == said_ref.replace(r_ref, "ROOT")
    rows = ours["all"].decode().splitlines()
    assert rows[0] == "filepath\ttitle" and len(rows) == 5
    assert rows[-1].endswith("| rainy") and "| rainy with heavy streaks" in rows[3]
    if captioner == "filename":
        assert rows[1].split("\t")[1] == "a red car| noisy"


def test_blip_captions_on_the_given_device(monkeypatch):
    seen = {}

    class Inputs(dict):
        def to(self, device):
            seen["inputs_on"] = str(device)
            return self

    class Processor:
        @classmethod
        def from_pretrained(cls, path, **kw):
            seen["processor"] = (path, kw)
            return cls()

        def __call__(self, img, return_tensors):
            return Inputs(pixel_values=torch.zeros(1))

        def decode(self, ids, skip_special_tokens):
            return f"caption {int(ids[0])}"

    class Model:
        @classmethod
        def from_pretrained(cls, path, **kw):
            seen["model"] = (path, kw)
            return cls()

        def to(self, device):
            seen["model_on"] = str(device)
            return self

        def eval(self):
            return self

        def generate(self, max_new_tokens, **inputs):
            seen["max_new_tokens"] = max_new_tokens
            return torch.tensor([[7, 8]])

    fake = types.ModuleType("transformers")
    fake.BlipProcessor, fake.BlipForConditionalGeneration = Processor, Model
    monkeypatch.setitem(sys.modules, "transformers", fake)
    cap = tgc.make_captioner("blip", "/models/blip", device="cpu")
    assert cap(Image.new("RGB", (4, 4)), "x.png") == "caption 7"
    assert seen == {"processor": ("/models/blip", {"local_files_only": True}),
                    "model": ("/models/blip", {"local_files_only": True}),
                    "model_on": "cpu", "inputs_on": "cpu", "max_new_tokens": 30}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgc.make_captioner("blip", "/models/blip")
    with pytest.raises(ValueError):
        tgc.make_captioner("nope")


class _Interface:
    def __init__(self, fn, inputs, outputs, title):
        self.fn, self.inputs, self.outputs, self.title = fn, inputs, outputs, title
        self.launched = None

    def launch(self, server_port):
        self.launched = server_port


def _stand_in_gradio():
    gr = types.ModuleType("gradio")
    gr.Interface = _Interface
    gr.Image = lambda label: ("Image", label)
    gr.Text = lambda label: ("Text", label)
    return gr


def test_gradio_handlers_equal_jax_on_the_tiny_restorer(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", _stand_in_gradio())
    unet, daclip = os.path.join(FIXTURE, "unet.pth"), os.path.join(FIXTURE, "daclip.pt")
    kw = dict(model_name="daclip_test-tiny", sample_T=3, dtype="float32")
    ours = tpipe.DACLIPRestorer.load(unet, daclip, tpipe.RestorerConfig(**kw), device="cpu")
    ref = jpipe.DACLIPRestorer.load(unet, daclip, jpipe.RestorerConfig(**kw))
    app, japp = tgr.build_app(ours), jgr.build_app(ref)
    assert (app.inputs, app.outputs) == (japp.inputs, japp.outputs)
    assert app.title == "DA-CLIP Universal Image Restoration" and "TPU" not in app.title
    img = (np.random.RandomState(9).rand(32, 32, 3) * 255).astype(np.uint8)
    out, name = app.fn(img)
    jout, jname = japp.fn(img)
    assert name == jname == ours.classify_degradation(img.astype(np.float32) / 255.0)[0]
    assert out.shape == jout.shape == img.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ours.restore(img.astype(np.float32) / 255.0)[:, :, ::-1])


def test_gradio_main_builds_the_restorer_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", _stand_in_gradio())
    built = {}
    for pkg, mod, pipe in (("ours", tgr, tpipe), ("ref", jgr, jpipe)):
        def load(unet, daclip, cfg, device=None, pkg=pkg):
            built[pkg] = (unet, daclip, cfg)
            return object()

        monkeypatch.setattr(pipe.DACLIPRestorer, "load", load)
        launched = []
        monkeypatch.setattr(mod, "build_app", lambda r: types.SimpleNamespace(
            launch=lambda server_port: launched.append(server_port)))
        extra = ["--device", "cpu"] if mod is tgr else []
        mod.main(["--unet", "u.pth", "--daclip", "d.pt", "--wild-ir", "--sample-T", "20",
                  "--port", "7999", *extra])
        assert launched == [7999]
    (u, d, cfg), (ju, jd, jcfg) = built["ours"], built["ref"]
    assert (u, d) == (ju, jd) == ("u.pth", "d.pt")
    for field in ("model_name", "context_dim", "scale", "sample_T", "T", "nf",
                  "spatial_attn_min_level"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert (cfg.model_name, cfg.context_dim, cfg.scale, cfg.sample_T) == (
        "daclip_ViT-L-14", 768, 0.5, 20)


def test_gradio_main_exits_without_gradio_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    argv = ["--unet", "u.pth", "--daclip", "d.pt"]
    with pytest.raises(SystemExit) as ours:
        tgr.main(argv)
    with pytest.raises(SystemExit) as ref:
        jgr.main(argv)
    assert "daclip_torch.cli.predict" in str(ours.value)
    assert str(ours.value) == str(ref.value).replace("daclip_tpu", "daclip_torch")
