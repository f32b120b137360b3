"""daclip_torch DaCLIP image path against daclip_tpu's and against the
committed reference outputs, on the CPU, in float32."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from daclip_torch.convert import daclip_state_dict_from_jax, load_torch_state_dict
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.models.clip import get_model_config as torch_model_config
from daclip_tpu.models import CLIPCfg as JaxCfg
from daclip_tpu.models import DaCLIP as JaxDaCLIP
from daclip_tpu.models import get_model_config as jax_model_config
from daclip_tpu.utils.torch_convert import convert_daclip

torch.set_num_threads(1)
FIXTURE = pathlib.Path(__file__).parent / "parity" / "fixtures" / "e2e"


def _models(name="daclip_test-tiny"):
    assert torch_model_config(name) == jax_model_config(name)
    return (TorchDaCLIP(TorchCfg.from_dict(torch_model_config(name))).eval(),
            JaxDaCLIP(JaxCfg.from_dict(jax_model_config(name)), dtype=jnp.float32))


def _encode_both(tmodel, jmodel, jparams, img_nhwc, normalize=False):
    want = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, control=True, normalize=normalize,
        method=jmodel.encode_image))(jparams, img_nhwc)
    with torch.no_grad():
        got = tmodel.encode_image(
            torch.from_numpy(np.ascontiguousarray(img_nhwc.transpose(0, 3, 1, 2))),
            control=True, normalize=normalize)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_fixture_daclip_loads_strict_and_matches_reference_and_jax():
    sd = load_torch_state_dict(str(FIXTURE / "daclip.pt"))
    tmodel, jmodel = _models()
    tmodel.load_state_dict(sd, strict=True)
    assert tmodel.visual is tmodel.clip.visual
    arrs = np.load(FIXTURE / "arrays.npz")
    jparams = convert_daclip({k: v.numpy() for k, v in sd.items()})
    (img, degra), (jimg, jdegra) = _encode_both(tmodel, jmodel, jparams,
                                                arrs["img4clip"][None])
    np.testing.assert_allclose(img, arrs["image_context"], atol=2e-3)
    np.testing.assert_allclose(degra, arrs["degra_context"], atol=2e-3)
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    np.testing.assert_allclose(degra, jdegra, atol=1e-4)


def test_tiny_daclip_matches_jax_on_jax_param_tree():
    """The JAX DaCLIP's parameter tree (structure traced from init) filled
    from a numpy seed — controller zero modules included, so the reversed
    control injection is exercised — converted and run in both packages."""
    tmodel, jmodel = _models()
    rng = np.random.RandomState(0)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, control=True,
                              method=jmodel.encode_image), img)["params"]
    text_shapes = jax.eval_shape(
        lambda t: jmodel.init(jax.random.PRNGKey(0), t, method=jmodel.encode_text),
        np.zeros((1, 16), np.int32))["params"]
    shapes["clip"]["text"] = text_shapes["clip"]["text"]

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) >= 2 and "embedding" not in name:
            a = rng.randn(*s.shape) / np.sqrt(s.shape[-2])
        elif "scale" in name:
            a = 1.0 + 0.1 * rng.randn(*s.shape)
        else:
            a = 0.1 * rng.randn(*s.shape)
        return np.asarray(a, np.float32)
    jparams = jax.tree_util.tree_map_with_path(fill, shapes)
    tmodel.load_state_dict(daclip_state_dict_from_jax(jparams), strict=True)
    (img_f, degra_f), (jimg, jdegra) = _encode_both(tmodel, jmodel, jparams, img,
                                                    normalize=True)
    assert img_f.shape == (2, 32) and degra_f.shape == (2, 32)
    np.testing.assert_allclose(img_f, jimg, atol=1e-4)
    np.testing.assert_allclose(degra_f, jdegra, atol=1e-4)
    # the control path matters: without it the image features differ
    with torch.no_grad():
        plain = tmodel.encode_image(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                    normalize=True).numpy()
    assert np.abs(plain - img_f).max() > 1e-3
