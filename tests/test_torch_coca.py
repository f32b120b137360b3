"""daclip_torch's CoCa against daclip_tpu's on the CPU, in float32, on one
seeded parameter tree (`coca_test-tiny`, in both packages' registries): the
latents, the caption logits and labels, `coca_loss`, the state dict both
ways, group beam search on the model and on a shared logit table, and
`generate` fed daclip_tpu's Gumbel draws; the factory's CoCa dispatch, the
tokenizer's context_length + 1 and the loss dispatch."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daclip_torch.factory as tfactory
import daclip_tpu.factory as jfactory
from daclip_torch.convert import coca_state_dict_from_jax
from daclip_torch.losses import coca_loss as t_coca_loss
from daclip_torch.models import coca as tcoca
from daclip_tpu.losses.clip_loss import coca_loss as j_coca_loss
from daclip_tpu.models import coca as jcoca
from daclip_tpu.utils.torch_convert import convert_coca
from tests.test_torch_towers import _assert_tree_equal, seeded

torch.set_num_threads(1)
NAME = "coca_test-tiny"
EOS, SOT = 49407, 49406


@pytest.fixture(scope="module")
def pair():
    jmodel, p0 = jfactory.create_model(NAME)
    jparams = seeded(p0, seed=4)
    tmodel = tfactory.create_model(NAME).eval()
    tmodel.load_state_dict(coca_state_dict_from_jax(jparams), strict=True)
    return jmodel, jparams, tmodel


def _inputs(B=2, seed=5):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, 32, 32, 3).astype(np.float32)
    n = tfactory.get_tokenizer(NAME).keywords["context_length"]
    txt = rng.randint(1, 400, (B, n)).astype(np.int32)
    txt[0, 9:] = 0   # padding: the CLS query masks it
    txt[:, 0] = SOT
    return img, txt


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_forward_latents_logits_and_loss_equal_jax(pair):
    jmodel, jparams, tmodel = pair
    img, txt = _inputs()
    want = jmodel.apply({"params": jparams}, img, txt)
    with torch.no_grad():
        got = tmodel(_nchw(img), torch.from_numpy(txt))
    for k in ("image_features", "text_features", "logits"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    jl = j_coca_loss(want["image_features"], want["text_features"], want["logits"],
                     want["labels"], want["logit_scale"])
    tl = t_coca_loss(got["image_features"], got["text_features"], got["logits"],
                     got["labels"], got["logit_scale"])
    for k in ("contrastive_loss", "caption_loss"):
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    jt = j_coca_loss(*[want[k] for k in ("image_features", "text_features", "logits",
                                         "labels", "logit_scale")],
                     caption_loss_weight=0.5, clip_loss_weight=0.0, output_dict=False)
    tt = t_coca_loss(*[got[k] for k in ("image_features", "text_features", "logits",
                                        "labels", "logit_scale")],
                     caption_loss_weight=0.5, clip_loss_weight=0.0, output_dict=False)
    assert tt[0] == jt[0] == 0.0
    np.testing.assert_allclose(float(tt[1]), float(jt[1]), rtol=1e-5)


def test_encoders_equal_jax(pair):
    jmodel, jparams, tmodel = pair
    img, txt = _inputs(seed=6)
    wi = jmodel.apply({"params": jparams}, img, method=jmodel.encode_image)
    wt = jmodel.apply({"params": jparams}, txt, method=jmodel.encode_text)
    with torch.no_grad():
        gi = tmodel.encode_image(_nchw(img))
        gt = tmodel.encode_text(torch.from_numpy(txt))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-4, rtol=0)


def test_state_dict_round_trips_through_convert_coca(pair):
    _, jparams, tmodel = pair
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert "visual.attn_pool.attn.k_proj_weight" in sd  # tokens wider than the queries
    assert "text_decoder.cross_attn.0.attn.in_proj_weight" in sd
    _assert_tree_equal(convert_coca(sd), jax.tree.map(np.asarray, jparams))


def test_generate_beam_on_the_model_equals_jax(pair):
    jmodel, jparams, tmodel = pair
    img, _ = _inputs(B=2, seed=7)
    want = jcoca.generate_beam(jmodel, {"params": jparams}, img, seq_len=12, num_beams=6,
                               num_beam_groups=3, min_seq_len=3)
    got = tcoca.generate_beam(tmodel, _nchw(img), seq_len=12, num_beams=6, num_beam_groups=3,
                              min_seq_len=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_beam_on_a_shared_table_equals_jax(pair, seed):
    """A logit table that makes EOS likely at some steps, so hypotheses
    finish, the shared pool fills and batch elements end early: the same
    tokens from both searches (the table is a function of the position and
    the last token, added in f32 on both sides)."""
    jmodel, _, tmodel = pair
    B, N, L, V, K = 3, 6, 10, jmodel.cfg.text.vocab_size, 7
    rng = np.random.RandomState(seed)
    pos = rng.randn(L, V).astype(np.float32)
    pos[:, :V - 40] -= 30.0  # the search plays over the last 40 ids
    pos[[3, 5, 6], EOS] += 2.5 + rng.rand(3).astype(np.float32)
    last = (0.5 * rng.randn(K, V)).astype(np.float32)
    img = np.zeros((B, 32, 32, 3), np.float32)

    def jtable(tokens):
        return jnp.asarray(pos)[None, None] + jnp.asarray(last)[tokens % K]

    def ttable(tokens):
        return torch.from_numpy(pos)[None, None] + torch.from_numpy(last)[tokens % K]

    want = jcoca.generate_beam(jmodel, None, img, seq_len=L, num_beams=N, num_beam_groups=3,
                               min_seq_len=3, logits_fn=jtable)
    got = tcoca.generate_beam(tmodel, _nchw(img), seq_len=L, num_beams=N, num_beam_groups=3,
                              min_seq_len=3, logits_fn=ttable)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == EOS).any()


@pytest.mark.parametrize("kind,kw", [("top_k", dict(top_k=5)), ("top_p", dict(top_p=0.9)),
                                     ("greedy", {}),
                                     ("top_k", dict(top_k=3, temperature=0.7,
                                                    repetition_penalty=1.3))])
def test_generate_under_daclip_tpu_s_draws_equals_jax(pair, monkeypatch, kind, kw):
    jmodel, jparams, tmodel = pair
    img, _ = _inputs(B=2, seed=8)
    key = jax.random.PRNGKey(11)
    want = jcoca.generate(jmodel, {"params": jparams}, img, key, seq_len=10, min_seq_len=3,
                          generation_type=kind, **kw)

    def draws(shape, step, generator=None, device=None):
        """jax.random.categorical's Gumbel noise at step `step`."""
        g = jax.random.gumbel(jax.random.fold_in(key, step), shape, jnp.float32)
        return torch.from_numpy(np.array(g))

    monkeypatch.setattr(tmodel, "sampling_noise", draws)
    got = tcoca.generate(tmodel, _nchw(img), seq_len=10, min_seq_len=3, generation_type=kind,
                         **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].tolist() == [SOT, SOT]


def test_generate_draws_only_through_sampling_noise(pair, monkeypatch):
    """With the noise method fixed, the default stream does not matter."""
    _, _, tmodel = pair
    img = _nchw(_inputs(B=2, seed=9)[0])
    zero = lambda shape, step, generator=None, device=None: torch.zeros(shape)  # noqa: E731
    monkeypatch.setattr(tmodel, "sampling_noise", zero)
    a = tcoca.generate(tmodel, img, seq_len=8, min_seq_len=2, top_k=4)
    torch.manual_seed(123)
    b = tcoca.generate(tmodel, img, seq_len=8, min_seq_len=2, top_k=4)
    greedy = tcoca.generate(tmodel, img, seq_len=8, min_seq_len=2, generation_type="greedy")
    assert torch.equal(a, b) and torch.equal(a, greedy)


def test_factory_tokenizer_and_loss_dispatch():
    model = tfactory.create_model(NAME, seed=3)
    assert isinstance(model, tcoca.CoCa)
    jtok, ttok = jfactory.get_tokenizer(NAME), tfactory.get_tokenizer(NAME)
    assert ttok.keywords == jtok.keywords == {"context_length": 16}
    np.testing.assert_array_equal(ttok(["a red fox"]), jtok(["a red fox"]))
    assert tfactory.get_tokenizer("ViT-B-32").keywords["context_length"] == 77
    for args in [dict(model=NAME), dict(model="daclip_ViT-B-32"), dict(model="x", da=True),
                 dict(model="ViT-B-32"), dict(model="ViT-B-32", distill=True)]:
        ns = argparse.Namespace(**args)
        j, t = jfactory.create_loss(ns), tfactory.create_loss(ns)
        name = lambda f: getattr(getattr(f, "func", f), "__name__", "")  # noqa: E731
        assert name(t) == name(j), args
    with pytest.raises(TypeError, match="no train-time forward"):
        model(image=torch.zeros(1, 3, 32, 32), text=torch.zeros(1, 16, dtype=torch.long),
              train=True)


def test_coca_loss_masks_pad_and_has_the_gradient_of_jax(pair):
    rng = np.random.RandomState(0)
    img_f, txt_f = rng.randn(3, 8).astype(np.float32), rng.randn(3, 8).astype(np.float32)
    logits = rng.randn(3, 5, 11).astype(np.float32)
    labels = rng.randint(1, 11, (3, 5))
    labels[1, 3:] = 0
    jg = jax.grad(lambda lg: sum(j_coca_loss(img_f, txt_f, lg, labels, 10.0).values()))(logits)
    t = torch.from_numpy(logits).requires_grad_(True)
    sum(t_coca_loss(torch.from_numpy(img_f), torch.from_numpy(txt_f), t,
                    torch.from_numpy(labels), torch.tensor(10.0)).values()).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-6)
    assert np.abs(t.grad.numpy()[1, 3:]).max() == 0.0
