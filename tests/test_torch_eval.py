"""daclip_torch's evaluation helpers against daclip_tpu's on the CPU: the
zero-shot classifier on one seeded text tower, top-k accuracy, retrieval
metrics, PSNR/SSIM and their Y-channel variants, and the YCbCr conversions."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.convert import daclip_state_dict_from_jax
from daclip_torch.data import util as tutil
from daclip_torch.eval import retrieval as tret
from daclip_torch.eval import zero_shot as tzs
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.models.clip import get_model_config
from daclip_torch.pipeline import DEGRADATION_CLASSES
from daclip_torch.tokenizer import tokenize as ttokenize
from daclip_torch.utils import metrics as tmet
from daclip_tpu.data import util as jutil
from daclip_tpu.eval import retrieval as jret
from daclip_tpu.eval import zero_shot as jzs
from daclip_tpu.models import CLIPCfg as JaxCfg
from daclip_tpu.models import DaCLIP as JaxDaCLIP
from daclip_tpu.tokenizer import tokenize as jtokenize
from daclip_tpu.utils import metrics as jmet
from tests.test_torch_text import NAME, jax_daclip_params

torch.set_num_threads(1)
SSIM_RTOL = 1e-10   # the reference filters by DFT (cv2.filter2D), the port directly
TOL = 1e-5          # float32 classifier weights


def test_zero_shot_classifier_equals_jax():
    jparams = jax_daclip_params(seed=31, use_predictor=False)
    tmodel = TorchDaCLIP(TorchCfg.from_dict(get_model_config(NAME))).eval()
    tmodel.load_state_dict(daclip_state_dict_from_jax(jparams), strict=True)
    jmodel = JaxDaCLIP(JaxCfg.from_dict(get_model_config(NAME)), dtype=jnp.float32)
    jenc = jax.jit(lambda t: jmodel.apply({"params": jparams}, t, normalize=True,
                                          method=jmodel.encode_text))
    classnames, templates = tzs.load_imagenet_metadata()
    assert (classnames, templates) == tuple(jzs.load_imagenet_metadata())
    assert len(classnames) == 1000 and len(templates) == 80
    for names, temps in ((DEGRADATION_CLASSES, templates[:12]),
                         (classnames[:7], ["a photo of a {}.", "itap of a {}."])):
        want = np.asarray(jzs.build_zero_shot_classifier(
            jenc, functools.partial(jtokenize, context_length=16), names, temps,
            num_classes_per_batch=3))
        got = tzs.build_zero_shot_classifier(
            lambda t: tmodel.encode_text(t, normalize=True),
            functools.partial(ttokenize, context_length=16), names, temps,
            num_classes_per_batch=3, device="cpu")
        assert got.shape == (32, len(names)) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_accuracy_and_retrieval_metrics_equal_jax():
    rng = np.random.RandomState(32)
    logits = rng.randn(50, 20)
    target = rng.randint(0, 20, 50)
    assert tzs.accuracy(logits, target, topk=(1, 5)) == jzs.accuracy(logits, target, (1, 5))
    img = rng.randn(40, 16)
    txt = img + 0.8 * rng.randn(40, 16)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    got, want = tret.get_clip_metrics(img, txt, 100.0), jret.get_clip_metrics(img, txt, 100.0)
    assert got == want and len(got) == 10


def _pairs():
    rng = np.random.RandomState(33)
    for shape in ((32, 32, 3), (45, 61, 3), (40, 57), (64, 48, 1), (11, 11, 3)):
        a = (rng.rand(*shape) * 255).astype(np.uint8)
        b = np.clip(a.astype(int) + rng.randint(-25, 26, shape), 0, 255).astype(np.uint8)
        yield a, b
        yield a, a


@pytest.mark.parametrize("i", range(10))
def test_psnr_ssim_equal_jax(i):
    a, b = list(_pairs())[i]
    assert tmet.calculate_psnr(a, b) == jmet.calculate_psnr(a, b)     # bit for bit
    got, want = tmet.calculate_ssim(a, b), jmet.calculate_ssim(a, b)
    assert abs(got - want) <= SSIM_RTOL * abs(want), (got, want)
    if a.ndim == 3 and a.shape[2] == 3:
        assert tmet.psnr_y(a, b) == jmet.psnr_y(a, b)   # the Y planes are equal
        got, want = tmet.ssim_y(a, b), jmet.ssim_y(a, b)
        assert abs(got - want) <= SSIM_RTOL * abs(want), (got, want)


def test_ssim_refuses_what_jax_refuses():
    a, b = np.zeros((16, 16, 3), np.uint8), np.zeros((16, 15, 3), np.uint8)
    two = np.zeros((16, 16, 2), np.uint8)
    for mod in (tmet, jmet):
        with pytest.raises(ValueError, match="same dimensions"):
            mod.calculate_ssim(a, b)
        with pytest.raises(ValueError, match="Wrong input"):
            mod.calculate_ssim(two, two)


@pytest.mark.parametrize("only_y", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_ycbcr_equal_jax(only_y, dtype):
    rng = np.random.RandomState(34)
    img = rng.rand(17, 23, 3)
    img = (img * 255).astype(np.uint8) if dtype == np.uint8 else img.astype(dtype)
    for name in ("rgb2ycbcr", "bgr2ycbcr"):
        got = getattr(tutil, name)(img, only_y=only_y)
        want = getattr(jutil, name)(img, only_y=only_y)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
