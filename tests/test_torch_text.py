"""daclip_torch's text side against daclip_tpu's on the CPU: the tokenizer
(ids equal, non-ASCII text included), the causal text tower, the fork's
level predictor, DaCLIP's training forward, the level-prompt banks, and
the restorer's text features and zero-shot degradation classification, on
one seeded parameter tree in float32."""
import html

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from daclip_torch import pipeline as tpipe
from daclip_torch import tokenizer as ttok
from daclip_torch.convert import daclip_state_dict_from_jax, unet_state_dict_from_jax
from daclip_torch.data import csv_dataset as tdata
from daclip_torch.models.clip import CLIP as TorchCLIP
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.models.clip import MultiTypeDegradationPredictor as TorchPredictor
from daclip_torch.models.clip import get_model_config as torch_model_config
from daclip_torch.models.transformer import causal_mask
from daclip_tpu import pipeline as jpipe
from daclip_tpu import tokenizer as jtok
from daclip_tpu.data import csv_dataset as jdata
from daclip_tpu.models import CLIPCfg as JaxCfg
from daclip_tpu.models import DaCLIP as JaxDaCLIP
from daclip_tpu.models import get_model_config as jax_model_config
from daclip_tpu.models.clip import CLIP as JaxCLIP
from daclip_tpu.models.clip import MultiTypeDegradationPredictor as JaxPredictor
from daclip_tpu.models.transformer import causal_mask as jax_causal_mask
from daclip_tpu.models.unet import ConditionalUNet as JaxUNet

torch.set_num_threads(1)
NAME = "daclip_test-tiny"   # text tower: width 32, 2 layers, 2 heads, context 16
TOL = 1e-5                  # float32, max abs, on unit-norm features and predictions

CAPTIONS = [  # tests/test_tokenizer.py's golden captions
    "a photo of a cat",
    "A bridge over the river| noisy with parameter 25.0",
    "motion-blurry image, low quality",
    "high quality jpeg",
    "it's 100% AMAZING!!! (really)",
    "",
]


# -- the tokenizer ----------------------------------------------------------------
def test_tokenizer_equals_jax_on_captions_prompts_and_class_names():
    texts = (CAPTIONS + [p for d in jdata.LEVEL_DESCRIPTIONS.values() for p in d]
             + list(jpipe.DEGRADATION_CLASSES))
    for ctx in (77, 16):
        np.testing.assert_array_equal(ttok.tokenize(texts, context_length=ctx),
                                      jtok.tokenize(texts, context_length=ctx))
    assert tdata.LEVEL_DESCRIPTIONS == jdata.LEVEL_DESCRIPTIONS
    assert tpipe.DEGRADATION_CLASSES == jpipe.DEGRADATION_CLASSES


# letters, numbers that `[^\W\d_]` would take for letters, CJK, combining
# marks, format and control characters, whitespace `str.isspace` and `regex`
# disagree on, the long s that IGNORECASE folds to s, HTML entities
_SPECIAL_CHARS = list("²½Ⅳ³⅓ⅻ中文日本語한국어éñßſİ́̈⃝​‍\x1c\x1f\x85\xa0　\t")
_CHARS = st.one_of(
    st.characters(codec="utf-8", categories=(
        "Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd",
        "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Cf")),
    st.sampled_from(_SPECIAL_CHARS))
_PIECES = st.one_of(
    st.text(alphabet=_CHARS, max_size=10),
    st.sampled_from(["&amp;", "&lt;b&gt;", "&#39;s", "&amp;amp;", "&eacute;", "&#x4e2d;",
                     "<|endoftext|>", "<|startoftext|>", "<|ſtartoftext|>", "it's", "'LL",
                     "'ſ", "x'd", " ", "  \n", "don't", "!'s"]))


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.lists(st.lists(_PIECES, max_size=6).map("".join), min_size=1, max_size=4))
def test_tokenizer_equals_jax_on_non_ascii_text(texts):
    np.testing.assert_array_equal(ttok.tokenize(texts), jtok.tokenize(texts))


def test_tokenizer_pre_tokenize_scanner_cases():
    """The scanner against the JAX pattern's findall on chosen strings."""
    tk = jtok._default_tokenizer()
    for text in ("x²+½ Ⅳ 12ab", "naïve café", "ét́é", "it'ſ <|ſtartoftext|>",
                 "a\x1cb　c", "!'s ''ll 'd'", "中文 text"):
        text = ttok._clean(text).lower()
        assert ttok._pre_tokenize(text) == jtok.re.findall(tk.pat, text), text
        assert ttok._clean(text) == jtok._clean(text)


def test_tokenizer_truncation_and_decode():
    tk = ttok.SimpleTokenizer()
    long = "word " * 200
    out = ttok.tokenize(long, context_length=77)
    np.testing.assert_array_equal(out, jtok.tokenize(long, context_length=77))
    assert out.shape == (1, 77) and out.dtype == np.int32 and out[0, -1] == tk.eot_token
    ids = tk.encode("hello world, a blurry image!")
    assert ids == jtok.SimpleTokenizer().encode("hello world, a blurry image!")
    assert tk.decode(ids).strip() == "hello world , a blurry image !"
    assert (tk.sot_token, tk.eot_token, tk.vocab_size) == (49406, 49407, 49408)
    assert ttok.get_tokenizer("ViT-B-32") is ttok.tokenize
    assert ttok._clean(html.escape("a  &  b")) == "a & b"


def test_causal_mask_equals_jax():
    for n in (1, 5, 16, 77):
        np.testing.assert_array_equal(causal_mask(n).numpy(), jax_causal_mask(n))


# -- a seeded parameter tree through both packages ------------------------------------
def _fill(rng):
    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) >= 2 and "embedding" not in name:
            a = rng.randn(*s.shape) / np.sqrt(s.shape[-2])
        elif "scale" in name:
            a = 1.0 + 0.1 * rng.randn(*s.shape)
        else:
            a = 0.1 * rng.randn(*s.shape)
        return np.asarray(a, np.float32)
    return fill


def jax_daclip_params(seed=0, use_predictor=True, name=NAME):
    """The JAX DaCLIP's full parameter tree (traced from init, predictor
    included) filled from a numpy seed."""
    cfg = JaxCfg.from_dict(jax_model_config(name))
    model = JaxDaCLIP(cfg, use_predictor=use_predictor)
    L, res = cfg.text.context_length, cfg.vision.image_size
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), image=jnp.zeros((1, res, res, 3)),
        text=jnp.zeros((1, 2 * L), jnp.int32), all_d_type_tokens=jnp.zeros((28, L), jnp.int32),
        bin_center_bank=jnp.zeros((4, 7))))["params"]
    return jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(seed)), shapes)


def jax_unet_params(seed=1, **kw):
    net = JaxUNet(**kw)
    x = jnp.zeros((1, 16, 16, 3))
    c = jnp.zeros((1, kw["context_dim"]))
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x, x, jnp.ones((1,)),
                                             c, c))["params"]
    return jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(seed)), shapes)


@pytest.fixture(scope="module")
def models():
    jparams = jax_daclip_params()
    cfg_dict = torch_model_config(NAME)
    assert cfg_dict == jax_model_config(NAME)
    tmodel = TorchDaCLIP(TorchCfg.from_dict(cfg_dict), use_predictor=True).eval()
    tmodel.load_state_dict(daclip_state_dict_from_jax(jparams), strict=True)
    jmodel = JaxDaCLIP(JaxCfg.from_dict(cfg_dict), use_predictor=True, dtype=jnp.float32)
    return tmodel, jmodel, jparams


def _tokens(n, L=16, seed=3):
    """Tokenized prompts of mixed lengths, the EOT at each row's end."""
    rng = np.random.RandomState(seed)
    words = ["noisy", "hazy", "a", "photo", "of", "rain", "blurry", "image", "jpeg"]
    texts = [" ".join(rng.choice(words, rng.randint(0, 20))) for _ in range(n)]
    return ttok.tokenize(texts, context_length=L)


def test_encode_text_equals_jax(models):
    tmodel, jmodel, jparams = models
    toks = _tokens(6)
    assert (toks[:, -1] == 49407).any() and (toks == 0).any()  # truncated and padded rows
    for normalize in (False, True):
        want = np.asarray(jax.jit(lambda p, t: jmodel.apply(
            {"params": p}, t, normalize=normalize, method=jmodel.encode_text))(jparams, toks))
        with torch.no_grad():
            t = torch.from_numpy(toks)
            got = tmodel.encode_text(t, normalize=normalize).numpy()
            via_clip = tmodel.clip.encode_text(t, normalize=normalize).numpy()
        assert got.shape == (6, 32)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_array_equal(via_clip, got)


def test_clip_forward_equals_jax(models):
    """CLIP.forward (model.py:244-252) on the frozen CLIP's own parameters."""
    tmodel, _, jparams = models
    cfg = JaxCfg.from_dict(jax_model_config(NAME))
    jclip = JaxCLIP(cfg, dtype=jnp.float32)
    rng = np.random.RandomState(4)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    toks = _tokens(2, seed=5)
    want = jclip.apply({"params": jparams["clip"]}, img, toks)
    with torch.no_grad():
        got = tmodel.clip(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                          torch.from_numpy(toks))
    assert set(got) == set(want)
    for key in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4 if key == "image_features" else TOL, rtol=1e-6)


@pytest.mark.parametrize("tok_rank", [2, 3])
def test_predictor_equals_jax(models, tok_rank):
    """Both ranks of the prompt features, (28, D) and (B, 28, D), and both
    of the bin centers, (4, 7) and (B, 4, 7)."""
    tmodel, _, jparams = models
    rng = np.random.RandomState(6 + tok_rank)
    B, D = 5, 32
    f = rng.randn(B, D).astype(np.float32)
    tokf = rng.randn(*((28, D) if tok_rank == 2 else (B, 28, D))).astype(np.float32)
    centers = jdata.build_banks(exact_bins=True)[0]
    if tok_rank == 3:
        centers = centers[None] * rng.uniform(0.5, 2.0, (B, 1, 1)).astype(np.float32)
    want = np.asarray(JaxPredictor().apply({"params": jparams["predictor"]}, f, tokf, centers))
    with torch.no_grad():
        got = tmodel.predictor(torch.from_numpy(f), torch.from_numpy(tokf),
                               torch.from_numpy(centers)).numpy()
    assert got.shape == (B, 4)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    # the regressors matter: with them zeroed the prediction moves
    zeroed = TorchPredictor()
    with torch.no_grad():
        plain = zeroed(torch.from_numpy(f), torch.from_numpy(tokf),
                       torch.from_numpy(centers)).numpy()
    assert np.abs(plain - got).max() > 1e-3


def test_daclip_forward_with_predictor_equals_jax(models):
    """DaCLIP.forward against the JAX training forward, key by key: images
    through the controller, caption‖degradation split, GT images without
    control, and the constant (B, 28, L) bank encoded once."""
    tmodel, jmodel, jparams = models
    rng = np.random.RandomState(8)
    B = 3
    img = rng.randn(B, 32, 32, 3).astype(np.float32)
    gt = rng.randn(B, 32, 32, 3).astype(np.float32)
    text = np.concatenate([_tokens(B, seed=9), _tokens(B, seed=10)], axis=1)
    bank, toks = tdata.build_banks(lambda t: ttok.tokenize(t, context_length=16))
    bank_b = np.broadcast_to(toks, (B,) + toks.shape).copy()
    deg_type = np.asarray([0, 1, 3], np.int32)
    gt_val = rng.rand(B, 4).astype(np.float32)
    want = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(
        jparams, img, text, gt, deg_type, gt_val, bank, bank_b)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = tmodel(nchw(img), torch.from_numpy(text), nchw(gt), torch.from_numpy(deg_type),
                     torch.from_numpy(gt_val), torch.from_numpy(bank), torch.from_numpy(bank_b))
    assert set(got) == set(want)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.shape == w.shape, key
        # the ViT towers' features are held at test_torch_clip.py's 1e-4
        tol = 1e-4 if "image" in key else TOL * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=key)


@pytest.mark.parametrize("exact_bins", [False, True])
def test_build_banks_equal_jax(exact_bins):
    tb, tt = tdata.build_banks(exact_bins=exact_bins)
    jb, jt = jdata.build_banks(exact_bins=exact_bins)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tt, jt)
    assert tb.dtype == jb.dtype and tt.dtype == jt.dtype and tt.shape == (28, 77)
    for d in jdata.DEGRADATION_TYPES:
        np.testing.assert_array_equal(tdata.level_grid(d), jdata.level_grid(d))
    assert tdata.DEG_TYPE_TO_ID == jdata.DEG_TYPE_TO_ID
    caption = "a dog| noisy with parameter 25.0, blur with parameter 1.5, jpeg with parameter 40"
    assert tdata.parse_degradations(caption) == jdata.parse_degradations(caption)


def test_coca_text_tower_is_refused():
    with pytest.raises(NotImplementedError, match="embed_cls"):
        TorchCLIP(TorchCfg.from_dict({
            "embed_dim": 32, "vision_cfg": {"image_size": 32, "layers": 1, "width": 64,
                                            "patch_size": 16, "head_width": 32},
            "text_cfg": {"context_length": 15, "width": 32, "heads": 2, "layers": 1,
                         "embed_cls": True}}))


# -- the restorer's text features and classification -----------------------------------
def test_restorer_text_features_and_classify_equal_jax(monkeypatch):
    """daclip_tpu's DACLIPRestorer and the port's on one seeded tree, float32."""
    jd = jax_daclip_params(seed=11, use_predictor=False)
    unet_kw = dict(nf=16, ch_mult=(1, 2), context_dim=32, use_degra_context=True,
                   use_image_context=True)
    ju = jax_unet_params(**unet_kw)
    common = dict(model_name=NAME, nf=16, ch_mult=(1, 2), context_dim=32, dtype="float32")
    ref = jpipe.DACLIPRestorer(jpipe.RestorerConfig(**common), ju, jd)
    ours = tpipe.DACLIPRestorer(tpipe.RestorerConfig(**common), unet_state_dict_from_jax(ju, 2),
                                daclip_state_dict_from_jax(jd), device="cpu")
    names = tpipe.DEGRADATION_CLASSES
    feats = ours.text_features(names)
    assert feats.dtype == np.float32 and feats.shape == (10, 32)
    np.testing.assert_allclose(feats, ref.text_features(names), atol=TOL, rtol=0)
    assert ours.text_features(list(names)) is feats          # cached by the tuple of names
    rng = np.random.RandomState(12)
    for shape, class_names in (((40, 40, 3), None), ((50, 30, 3), ["noisy", "rainy", "hazy"])):
        img = rng.rand(*shape).astype(np.float32)
        name, probs = ours.classify_degradation(img, class_names)
        want_name, want = ref.classify_degradation(img, class_names)
        assert name == want_name and list(probs) == list(want)   # same order
        np.testing.assert_allclose(list(probs.values()), list(want.values()), atol=TOL, rtol=0)
        assert abs(sum(probs.values()) - 1.0) < 1e-5
    monkeypatch.setattr(ours, "daclip", None)  # as a restorer loaded without DA-CLIP
    with pytest.raises(ValueError, match="DA-CLIP"):
        ours.classify_degradation(np.zeros((32, 32, 3), np.float32))
