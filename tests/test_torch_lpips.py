"""daclip_torch's LPIPS(alex) against daclip_tpu's on the CPU, on seeded
weights in daclip_tpu's `.npz` layout (HWIO convs, (1, 1, C, 1) heads), and
`cli.test_restoration --lpips-weights` on a tiny seeded UNet: its summary
carries LPIPS, equal to the port's LPIPS of the saved output against the GT."""
import textwrap

import numpy as np
import pytest
import torch

from daclip_torch.cli import test_restoration as t_test
from daclip_torch.data import png
from daclip_torch.models.unet import ConditionalUNet
from daclip_torch.utils.lpips import LPIPS
from daclip_torch.utils.metrics import array2img
from daclip_tpu.utils.lpips import LPIPS as JaxLPIPS

torch.set_num_threads(1)
RTOL = 1e-5   # f32, the port's LPIPS against daclip_tpu's, relative
_CONVS = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    """Seeded AlexNet-shaped weights in daclip_tpu's layout."""
    rng = np.random.RandomState(0)
    w = {}
    for i, (cin, cout, k) in enumerate(_CONVS):
        w[f"conv{i}_w"] = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
        w[f"conv{i}_b"] = (0.05 * rng.randn(cout)).astype(np.float32)
        w[f"lin{i}_w"] = np.abs(rng.randn(1, 1, cout, 1)).astype(np.float32)
    path = tmp_path_factory.mktemp("lpips") / "alex.npz"
    np.savez(path, **w)
    return str(path)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 96, 80)])
def test_lpips_equals_jax(weights_npz, shape):
    rng = np.random.RandomState(sum(shape))
    a = rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    ours = LPIPS.from_npz(weights_npz, device="cpu")
    want = JaxLPIPS.from_npz(weights_npz)(a, b)
    got = ours(a, b)
    assert got.shape == want.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert (got > 0).all()
    np.testing.assert_allclose(ours(a[0], b[0]), want[:1], rtol=RTOL)   # HWC
    np.testing.assert_array_equal(ours(a, a), np.zeros(shape[0], np.float32))


def test_lpips_needs_a_gpu_unless_told_cpu(weights_npz, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LPIPS.from_npz(weights_npz)


def _seeded_unet(path, **kw):
    rng = np.random.RandomState(4)
    sd = {}
    for key, v in ConditionalUNet(**kw).state_dict().items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith(".g") or (key.endswith(".weight") and len(shape) == 1):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.02 * rng.randn(*shape)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    torch.save(sd, path)


def test_test_restoration_scores_lpips(tmp_path, weights_npz):
    """Two 64² LQGT pairs restored by a tiny seeded UNet (T = 4): the
    summary's LPIPS is the port's LPIPS of each saved output against its GT,
    and daclip_tpu's LPIPS agrees with it."""
    rng = np.random.RandomState(0)
    for sub in ("GT", "LQ"):
        (tmp_path / "lqgt" / sub).mkdir(parents=True)
        for i in range(2):
            png.write(str(tmp_path / "lqgt" / sub / f"{i}.png"),
                      (rng.rand(64, 64, 3) * 255).astype(np.uint8))
    kw = dict(nf=16, ch_mult=(1, 2), context_dim=None, use_degra_context=False,
              use_image_context=False)
    _seeded_unet(str(tmp_path / "unet.pth"), **kw)
    test_yml = tmp_path / "test.yml"
    test_yml.write_text(textwrap.dedent(f"""
        name: lpips-test
        sde: {{max_sigma: 50, T: 4, schedule: cosine, eps: 0.005}}
        datasets:
          test1: {{name: Test, mode: LQGT, dataroot_GT: {tmp_path / 'lqgt' / 'GT'},
                   dataroot_LQ: {tmp_path / 'lqgt' / 'LQ'}}}
        network_G:
          setting: {{nf: 16, ch_mult: [1, 2], context_dim: ~, use_degra_context: false,
                     use_image_context: false}}
        path: {{pretrain_model_G: {tmp_path / 'unet.pth'}, daclip: ~,
                root: {tmp_path / 'out'}}}
    """))
    out = t_test.main(["-opt", str(test_yml), "--lpips-weights", weights_npz,
                       "--save-images", "--device", "cpu"])["test1"]
    assert len(out["lpips"]) == 2 and np.isfinite(out["lpips"]).all()
    ours = LPIPS.from_npz(weights_npz, device="cpu")
    ref = JaxLPIPS.from_npz(weights_npz)
    res_dir = tmp_path / "out" / "results" / "lpips-test" / "test1"
    for i in range(2):
        got = png.read(str(res_dir / f"{i}.png"))[:, :, ::-1] / 127.5 - 1.0
        gt = png.read(str(tmp_path / "lqgt" / "GT" / f"{i}.png"))
        gt = array2img(gt[:, :, ::-1].astype(np.float32) / 255.0)[:, :, ::-1] / 127.5 - 1.0
        assert out["lpips"][i] == float(ours(got, gt)[0])
        np.testing.assert_allclose(out["lpips"][i], ref(got, gt)[0], rtol=RTOL)
