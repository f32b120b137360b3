"""daclip_torch's utils/profile and utils/stage_profile against daclip_tpu's
on the CPU: the parameter rows (exact), the FLOP count on the plain path
(the same in every wiring of the wraps, on fake and on real CPU tensors,
and 2 × the multiply-adds of a tiny ViT reckoned by hand), and the stage
rows' names."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.models.clip import get_model_config as torch_model_config
from daclip_torch.models.unet import ConditionalUNet
from daclip_torch.utils import profile as tprof
from daclip_torch.utils import stage_profile as tstage
from daclip_tpu.models import CLIPCfg, DaCLIP, get_model_config
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet
from daclip_tpu.utils import profile as jprof
from daclip_tpu.utils import stage_profile as jstage

torch.set_num_threads(1)
UNET = dict(nf=16, ch_mult=(1, 2), context_dim=32)


def test_clip_param_rows_equal_jax():
    cfg = CLIPCfg.from_dict(get_model_config("daclip_test-tiny"))
    res, L = cfg.vision.image_size, cfg.text.context_length
    p = jax.eval_shape(lambda: DaCLIP(cfg).init(
        jax.random.PRNGKey(0), image=jnp.zeros((1, res, res, 3)),
        text=jnp.zeros((1, 2 * L), jnp.int32)))["params"]
    want = {"clip.visual": jprof.count_params(p["clip"]["visual"]),
            "clip.text": jprof.count_params(p["clip"]["text"]),
            "visual_control": jprof.count_params(p["visual_control"]),
            "total": jprof.count_params(p)}
    model = TorchDaCLIP(TorchCfg.from_dict(torch_model_config("daclip_test-tiny")))
    assert tprof.clip_param_rows(model) == want
    # the state dict holds the image tower twice (clip.visual.*, visual.*)
    assert sum(t.numel() for t in model.state_dict().values()) > want["total"]
    out = tprof.profile_clip("daclip_test-tiny", device="cpu")
    assert out["params"] == {k: v / 1e6 for k, v in want.items()}
    assert set(out) == {"params", "encode_image_control", "encode_text"}
    for key in ("encode_image_control", "encode_text"):
        assert set(out[key]) == {"gflops", "gbytes"}
        assert out[key]["gflops"] > 0 and np.isnan(out[key]["gbytes"])


def test_unet_param_count_equals_jax_and_the_reference_to_q():
    kw = dict(UNET, use_degra_context=True, use_image_context=True)
    x, c = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, UNET["context_dim"]))
    p = jax.eval_shape(lambda: JaxUNet(**kw).init(jax.random.PRNGKey(0), x, x, jnp.ones((1,)),
                                                  c, c))["params"]
    net = ConditionalUNet(**kw)
    # the port keeps the reference's to_q of each single-token cross-attention,
    # which gets no gradient; the JAX module never creates it (its context is
    # one token, so it computes to_out(v) without it)
    to_q = sum(p_.numel() for k, p_ in net.named_parameters() if ".attn2.to_q." in k)
    assert to_q > 0
    want = jprof.count_params(p) + to_q
    assert tprof.count_params(net) == want
    out = tprof.profile_unet(**UNET, size=32, device="cpu")
    assert out["params_M"] == want / 1e6 and set(out) == {"params_M", "forward"}


def _unet_flops(real=False, **kw):
    def run(net, x, ctx):
        return tprof.cost_analysis(lambda xt: net(xt, x, torch.ones(1), ctx, ctx), x)["gflops"]

    if real:
        torch.manual_seed(0)
        net = ConditionalUNet(**UNET, use_degra_context=True, use_image_context=True, **kw)
        with torch.no_grad():
            return run(net, torch.rand(1, 3, 32, 32), torch.rand(1, UNET["context_dim"]))
    with tprof.plain_path():
        net = ConditionalUNet(**UNET, use_degra_context=True, use_image_context=True, **kw)
        return run(net, torch.zeros(1, 3, 32, 32), torch.zeros(1, UNET["context_dim"]))


def test_unet_flops_are_the_same_whichever_path_computes_the_wraps():
    """v5 (`attn_wrap`), v4 (prenorm, `linear_attention_fused`, residual)
    and v3 (`attn_wrap_fused`), with and without the dual 1×1, all count
    the same FLOPs; so does the forward on real CPU tensors."""
    want = _unet_flops()
    assert want > 0
    for la in ("v5", "v4", "v3"):
        for pointwise in (False, True):
            assert _unet_flops(linear_attention=la, pointwise=pointwise) == want, (la, pointwise)
    assert _unet_flops(real=True) == want
    assert tprof.profile_unet(**UNET, size=32, device="cpu")["forward"]["gflops"] == want


def test_vit_flops_are_twice_its_multiply_adds():
    """test-tiny's image tower: 32², patch 16 (4 patches + the class token),
    width 64, 2 blocks of 2 heads, MLP 4×, projection to 32."""
    cfg = TorchCfg.from_dict(torch_model_config("daclip_test-tiny"))
    v = cfg.vision
    P, N, w = (v.image_size // v.patch_size) ** 2, (v.image_size // v.patch_size) ** 2 + 1, v.width
    macs = (P * 3 * v.patch_size ** 2 * w                       # patch embedding
            + v.layers * (N * w * 3 * w + 2 * N * N * w + N * w * w + 2 * N * w * 4 * w)
            + w * cfg.embed_dim)                                 # the class token's proj
    with tprof.plain_path():
        model = TorchDaCLIP(cfg)
        img = torch.zeros(1, 3, v.image_size, v.image_size)
        got = tprof.cost_analysis(model.encode_image, img)["gflops"]
        both = tprof.cost_analysis(lambda x: model.encode_image(x, control=True), img)["gflops"]
    assert got * 1e9 == 2 * macs
    # the controller is a second tower, and each of its blocks feeds a zero
    # Linear(w → w) on all N tokens
    assert both * 1e9 == 2 * (2 * macs + v.layers * N * w * w)


def test_wallclock_ms_is_positive():
    assert tprof.wallclock_ms(lambda x: x @ x, torch.ones(8, 8), iters=3) > 0


def test_stage_profile_rows_have_the_jax_names(capsys):
    argv = ["--batch", "1", "--size", "32", "--dtype", "float32"]
    jstage.main(argv)
    want = [line[:42].strip() for line in capsys.readouterr().out.splitlines()
            if line.endswith(" ms")]
    got = tstage.main(argv + ["--device", "cpu"])
    assert list(got) == want and len(want) == 11
    assert all(np.isfinite(v) and v > 0 for v in got.values())
    assert "level-0 pair estimate" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            tstage.main(argv)
