"""daclip_torch's HFTextTower (transformers' PyTorch models) against
daclip_tpu's (transformers' Flax models) on the CPU, in float32, on tiny
local BERT, RoBERTa and T5 configs: the Flax weights through
`convert.hf_text_state_dict_from_flax` → `load_state_dict(strict=True)` →
the same features for each pooler and projection, the same tokens, the same
lock masks."""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from daclip_torch.convert import hf_text_state_dict_from_flax  # noqa: E402
from daclip_torch.models import hf_text as thf  # noqa: E402
from daclip_tpu.models import hf_text as jhf  # noqa: E402

torch.set_num_threads(1)
IDS = np.asarray([[5, 6, 7, 8, 1, 1, 1], [9, 10, 11, 12, 13, 14, 15]], np.int32)


def _cfg(kind):
    if kind == "bert":
        return transformers.BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                                       num_attention_heads=2, intermediate_size=64,
                                       max_position_embeddings=64, pad_token_id=1)
    if kind == "roberta":
        return transformers.RobertaConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                                          num_attention_heads=2, intermediate_size=64,
                                          max_position_embeddings=64, pad_token_id=1)
    return transformers.T5Config(vocab_size=100, d_model=32, d_kv=16, d_ff=64, num_layers=2,
                                 num_heads=2, pad_token_id=1, feed_forward_proj="relu")


def _pair(kind, pooler, proj, output_dim=16):
    """daclip_tpu's tower and its parameters (re-drawn from a numpy seed,
    so the comparison sees no zero-initialised weights), and the port's
    tower with them loaded strictly."""
    jt = jhf.HFTextTower.from_config(_cfg(kind), output_dim, pooler_type=pooler, proj=proj)
    params = jt.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def fill(leaf):
        a = np.asarray(leaf)
        return (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)

    params = jax.tree.map(fill, params)
    tt = thf.HFTextTower.from_config(_cfg(kind), output_dim, pooler_type=pooler, proj=proj)
    tt.load_state_dict(hf_text_state_dict_from_flax(params["hf"], params["proj"],
                                                    encoder_only=tt.encoder_decoder),
                       strict=True)
    return jt, params, tt.eval()


@pytest.mark.parametrize("kind", ["bert", "roberta"])
@pytest.mark.parametrize("pooler", list(thf.POOLERS))
def test_each_pooler_equals_jax(kind, pooler):
    jt, params, tt = _pair(kind, pooler, "mlp")
    want = np.asarray(jt.encode(params, IDS, normalize=True))
    with torch.no_grad():
        got = tt(torch.from_numpy(IDS).long(), normalize=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("proj,dim", [(None, 32), ("linear", 16), ("mlp", 24)])
def test_each_projection_and_the_tokens_equal_jax(proj, dim):
    for pooler in ("cls_pooler", "mean_pooler"):
        jt, params, tt = _pair("bert", pooler, proj, output_dim=dim)
        wf, wtok = jt.encode(params, IDS, output_tokens=True)
        with torch.no_grad():
            gf, gtok = tt(torch.from_numpy(IDS).long(), output_tokens=True)
        assert gf.shape == (2, dim) and gtok.shape == wtok.shape
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=1e-5, rtol=0)
        np.testing.assert_allclose(gtok.numpy(), np.asarray(wtok), atol=1e-5, rtol=0)


def test_t5_encoder_equals_jax():
    jt, params, tt = _pair("t5", "mean_pooler", "linear")
    assert tt.encoder_decoder and not any("decoder" in k for k in tt.state_dict())
    want = np.asarray(jt.encode(params, IDS))
    with torch.no_grad():
        got = tt(torch.from_numpy(IDS).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _flax_name(path):
    leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(path[-1],
                                                                           path[-1])
    return ".".join(["transformer"] + list(path[:-1]) + [leaf])


@pytest.mark.parametrize("unlocked,freeze_ln", [(0, True), (1, True), (1, False), (0, False)])
def test_lock_mask_equals_jax(unlocked, freeze_ln):
    from flax.traverse_util import flatten_dict

    jt, params, tt = _pair("roberta", "mean_pooler", "mlp")
    jmask = jt.lock_mask(params, unlocked_layers=unlocked, freeze_layer_norm=freeze_ln)
    tmask = tt.lock_mask(unlocked_layers=unlocked, freeze_layer_norm=freeze_ln)
    want = {_flax_name(k): float(v) for k, v in flatten_dict(jmask["hf"]).items()}
    got = {k: v for k, v in tmask.items() if k.startswith("transformer.")}
    assert got == want
    assert all(v == 1.0 for k, v in tmask.items() if k.startswith("proj"))
    assert 0.0 in got.values() and (unlocked == 0 and freeze_ln) == (1.0 not in got.values())


def test_refusals_are_daclip_tpu_s():
    for kw in [dict(pooler_type="nope"), dict(proj=None)]:
        with pytest.raises(ValueError) as je:
            jhf.HFTextTower.from_config(_cfg("bert"), 16, **kw)
        with pytest.raises(ValueError) as te:
            thf.HFTextTower.from_config(_cfg("bert"), 16, **kw)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unsupported HF model_type"):
        thf.HFTextTower.from_config(transformers.GPT2Config(n_layer=1), 16)


def test_from_a_local_config_dir_and_a_dict(tmp_path):
    _cfg("roberta").save_pretrained(tmp_path)
    a = thf.HFTextTower.from_config(str(tmp_path), 16, seed=3)
    b = thf.HFTextTower.from_config(dict(_cfg("roberta").to_dict()), 16, seed=3)
    assert a.pooler_type == "mean_pooler" and a.pad_id == 1
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
