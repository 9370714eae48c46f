"""Port parity for AWQ (``quick_tpu_torch/quantize/awq.py`` and
``quantize/calib.py``) on the llama path: the calibration tokens, the
weight score, the scale and clip searches, ``awq_quantize_block`` at GQA
and MHA, and ``AutoQuickModel.quantize(calib)`` on a whole tiny model, each
against ``quick_tpu`` on the CPU on inputs made from a seed.

The JAX searches run eagerly (``jax.disable_jit``; tests/_awq_parity.py
says why). On these models the port makes every pick the JAX package makes
and packs the same bytes; ``_awq_parity.check_searches`` states the rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _awq_parity import assert_close, assert_params_equal, check_searches, recorded, to_jax, to_torch

import quick_tpu.quantize.awq as jawq
import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.quantize.awq as tawq
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import init_float_params as jax_init_float
from quick_tpu.models.auto import AutoQuickModel as JaxAuto
from quick_tpu.quantize.calib import get_calib_tokens as jax_calib
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import model_forward, quantize_params
from quick_tpu_torch.modules.linear import Linear, QuantLinear
from quick_tpu_torch.quantize.calib import get_calib_tokens

TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64)
G = 32
CALIB = (2, 32)


def _calib(vocab=TINY["vocab_size"], seed=1):
    return np.random.default_rng(seed).integers(0, vocab, CALIB).astype(np.int32)


def _models(kw, seed=0):
    """The JAX package's random float model (bf16) and the port's copy of
    its weights."""
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jparams = jax_init_float(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, tcfg, params_from_flat(jck.params_to_flat(jparams), tcfg, device="cpu")


def _assert_flat_equal(tflat, jflat):
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        t = tflat[k]
        b = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        a = np.asarray(a)
        a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k


# ------------------------------------------------------------ calibration

class _Tokenizer:
    def encode(self, text):
        return [ord(c) % 97 for c in text]


@pytest.mark.parametrize("case", ["array", "flat_array", "strings", "synthetic", "synthetic_seed"])
def test_calib_tokens_match_jax(case):
    """Every branch but ``dataset_path`` (it reads a local HF dataset):
    equal int32 blocks."""
    rng = np.random.default_rng(0)
    kw = {
        "array": dict(data=rng.integers(0, 500, (3, 700)), n_samples=3, block_size=512),
        "flat_array": dict(data=rng.integers(0, 500, 2100), n_samples=8, block_size=256),
        "strings": dict(data=["the quick brown fox " * 20, "jumps over " * 40], n_samples=2,
                        block_size=64, tokenizer=_Tokenizer()),
        "synthetic": dict(n_samples=4, block_size=128, vocab_size=1000),
        "synthetic_seed": dict(n_samples=2, block_size=512, vocab_size=32000, seed=3),
    }[case]
    out, ref = get_calib_tokens(**kw), jax_calib(**kw)
    assert out.dtype == np.int32 and np.array_equal(out, ref)


def test_calib_tokens_refusals_match_jax():
    with pytest.raises(ValueError, match="at least"):
        get_calib_tokens(np.zeros(10), block_size=64)
    with pytest.raises(ValueError, match="tokenizer"):
        get_calib_tokens(["text"])


# ------------------------------------------------------------ searches

def _salient(rng, T=256, K=128, N=64):
    """The canonical AWQ case (tests/test_awq.py): a few input channels
    carry 30x activations."""
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((T, K)).astype(np.float32)
    x[:, rng.choice(K, 8, replace=False)] *= 30.0
    return w, x


def test_w_mean_score_matches_jax():
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal((128, n)).astype(np.float32) for n in (64, 96)]
    ref = np.asarray(jawq._w_mean_score([jnp.asarray(w) for w in ws], G))
    out = tawq._w_mean_score([torch.from_numpy(w) for w in ws], G).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("zero_point,duo", [(True, True), (False, True), (True, False)])
def test_search_scale_matches_jax(zero_point, duo):
    """f32, y = x @ w: the same grid point, scales within 1e-6 relative;
    the loss grid kept on the device (no pick read back per candidate)."""
    w, x = _salient(np.random.default_rng(1))
    with jax.disable_jit():
        xj, wj = jnp.asarray(x), jnp.asarray(w)
        ref = np.asarray(jawq.search_scale(xj, [wj], lambda ws: xj @ ws[0], G,
                                           zero_point=zero_point, duo_scaling=duo))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with tawq.recorded_searches() as rec:
        out = tawq.search_scale(xt, [wt], lambda ws: xt @ ws[0], G, zero_point=zero_point,
                                duo_scaling=duo)
    pick = int(rec[0].picks())
    np.testing.assert_allclose(rec[0].grid[pick].numpy(), out.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("zero_point", [True, False])
def test_search_clip_matches_jax(zero_point):
    """f32 weights with injected outliers, 1100 tokens: the strided
    sample x[::2]; every (group, channel) bound equal."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((128, 48)) * 0.02).astype(np.float32)
    w.ravel()[rng.choice(w.size, 20, replace=False)] *= 50
    x = rng.standard_normal((1100, 128)).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jawq.search_clip(jnp.asarray(w), jnp.asarray(x), G, zero_point))
    out = tawq.search_clip(torch.from_numpy(w), torch.from_numpy(x), G, zero_point).numpy()
    assert np.array_equal(out, ref)
    assert (out < np.abs(w).reshape(4, G, 48).max(1)).any()  # some group was clipped


def test_apply_clip_matches_jax():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((128, 40)).astype(np.float32)).to(torch.bfloat16)
    m = torch.from_numpy(rng.random((4, 40)).astype(np.float32))
    ref = jawq.apply_clip(to_jax(w), jnp.asarray(m.numpy()), G)
    out = tawq.apply_clip(w, m, G)
    assert out.dtype == torch.bfloat16 and torch.equal(out, to_torch(ref))


# ------------------------------------------------------------ blocks

def _random_qkv_bias(jparams, seed):
    """The JAX params with random qkv biases (the initializers make zeros)."""
    rng = np.random.default_rng(seed)
    blocks = []
    for blk in jparams.blocks:
        b = blk.attn.qkv_proj.bias
        b = jnp.asarray(rng.standard_normal(b.shape) * 0.1, b.dtype)
        blocks.append(dataclasses.replace(blk, attn=dataclasses.replace(
            blk.attn, qkv_proj=dataclasses.replace(blk.attn.qkv_proj, bias=b))))
    return dataclasses.replace(jparams, blocks=blocks)


def test_awq_block_matches_jax(monkeypatch):
    """One GQA block (no o fold) with random qkv biases, o and down left
    float (``skip``), from the same input: every search by the rule; with
    the JAX grid choices imposed, the packed and float weights byte-equal
    and x_next, whose bf16 products sum in other orders, within one bf16
    step."""
    kw, skip = dict(TINY, num_key_value_heads=2, attention_bias=True), frozenset({"o", "down"})
    jcfg, jparams, tcfg, _ = _models(kw)
    jparams = _random_qkv_bias(jparams, 4)
    tparams = params_from_flat(jck.params_to_flat(jparams), tcfg, device="cpu")
    calib = _calib()
    x = jparams.embed[jnp.asarray(calib)].astype(jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(CALIB[1])[None], CALIB)
    with recorded(monkeypatch, impose=True) as (jrec, prec):
        with jax.disable_jit():
            ref = jawq.awq_quantize_block(jparams.blocks[0], jcfg, x, pos, jparams.rope_cos,
                                          jparams.rope_sin, JaxQuantConfig(q_group_size=G),
                                          skip=skip)
        out = tawq.awq_quantize_block(tparams.blocks[0], tcfg, to_torch(x),
                                      torch.from_numpy(np.array(pos)), tparams.rope_cos,
                                      tparams.rope_sin, QuantConfig(q_group_size=G), skip=skip)
    assert [r[0] for r in prec] == ["scale", "clip", "clip", "scale", "scale", "clip", "clip"]
    assert check_searches(jrec, prec) == {"scale": [], "clip": []}
    assert_close(out.x_next, ref.x_next, 2.0 ** -7, "x_next")
    for nm, lin in (("qkv", out.block.attn.qkv_proj), ("o", out.block.attn.o_proj),
                    ("gate_up", out.block.mlp.gate_up_proj), ("down", out.block.mlp.down_proj)):
        assert isinstance(lin, Linear if nm in skip else QuantLinear), nm
    assert_params_equal(out.block, ref.block)


def test_quantize_whole_model_matches_jax(monkeypatch, capsys):
    """AutoQuickModel.quantize(calib) with quantize_lm_head on a 2-layer MHA
    model (the o group folds into the v columns) with random qkv biases,
    against the JAX package's: every search by the rule; with its grid
    choices imposed (tests/_awq_parity.py), equal flat dicts (every code,
    scale, z*s, bias, norm and the RTN-packed head); the [awq] lines
    printed."""
    kw = dict(TINY, attention_bias=True)
    jm = JaxAuto.from_random(JaxConfig(**kw), seed=5)
    jm.params = _random_qkv_bias(jm.params, 7)
    tm = AutoQuickModel(params_from_flat(jck.params_to_flat(jm.params), ModelConfig(**kw),
                                         device="cpu"), ModelConfig(**kw))
    calib = _calib(seed=6)
    with recorded(monkeypatch, impose=True) as (jrec, prec):
        with jax.disable_jit():
            jm.quantize(jnp.asarray(calib), JaxQuantConfig(q_group_size=G, quantize_lm_head=True),
                        verbose=False)
        tm.quantize(calib, QuantConfig(q_group_size=G, quantize_lm_head=True))
    assert capsys.readouterr().out.splitlines() == [
        "[awq] block 1/2 quantized", "[awq] block 2/2 quantized"]
    assert len(prec) == 16
    check_searches(jrec, prec)
    assert isinstance(tm.params.lm_head, QuantLinear) and tm.qcfg.quantize_lm_head
    _assert_flat_equal(params_to_flat(tm.params), jck.params_to_flat(jm.params))


def test_quantize_without_search_is_rtn():
    """No calibration tokens, or use_awq_search=False: RTN."""
    _, _, tcfg, tparams = _models(TINY)
    rtn = params_to_flat(quantize_params(tparams, tcfg, G))
    for calib, search in ((None, True), (_calib(), False)):
        m = AutoQuickModel(tparams, tcfg)
        m.quantize(calib, QuantConfig(q_group_size=G), use_awq_search=search)
        flat = params_to_flat(m.params)
        assert list(flat) == list(rtn) and all(torch.equal(flat[k], rtn[k]) for k in rtn)


def _last_kl(ref_logits, logits):
    pf = torch.log_softmax(ref_logits[:, -1], -1)
    pa = torch.log_softmax(logits[:, -1], -1)
    return float((torch.exp(pf) * (pf - pa)).sum(-1).mean())


def test_awq_kl_stays_below_rtn_bound():
    """The port's own AWQ on a tiny MHA model (tests/test_awq.py:77-104):
    KL to the float model finite and below 2.5 x RTN's."""
    cfg = ModelConfig(**TINY)
    m = AutoQuickModel.from_random(cfg, seed=0, device="cpu", dtype=torch.float32)
    fp = m.params
    m.quantize(_calib(seed=1), QuantConfig(q_group_size=G), verbose=False)
    assert isinstance(m.params.blocks[0].attn.qkv_proj, QuantLinear)
    toks = torch.from_numpy(_calib(seed=2)[:, :16]).long()
    with torch.inference_mode():
        lf = model_forward(fp, cfg, toks)[0]
        kl_awq = _last_kl(lf, model_forward(m.params, cfg, toks)[0])
        kl_rtn = _last_kl(lf, model_forward(quantize_params(fp, cfg, G), cfg, toks)[0])
    assert np.isfinite(kl_awq) and kl_awq < 2.5 * kl_rtn, (kl_awq, kl_rtn)


A12 = dict(use_qk_norm=True, learned_pos=True, use_rope=False, layernorm="layernorm",
           embed_norm=True, parallel_residual=True, use_alibi=True, gated_mlp=False,
           act_fn="relu", qkv_clip=8.0)


#: set with a switch: cohere's LayerNorm qk-norm (the RMS qk-norms run,
#: tests/test_torch_qk_norm.py, tests/test_torch_gemma.py and
#: tests/test_torch_olmo2_granite.py)
WITH = {"use_qk_norm": dict(layernorm="layernorm")}


@pytest.mark.parametrize("switch", sorted(A12))
def test_awq_refuses_a12_switches(switch):
    """The JAX AWQ's branches for the LayerNorm families wait for A12."""
    m = AutoQuickModel.from_random(ModelConfig(**TINY), seed=0, device="cpu")
    m.cfg = dataclasses.replace(m.cfg, **{switch: A12[switch]}, **WITH.get(switch, {}))
    with pytest.raises(NotImplementedError, match="A12"):
        m.quantize(_calib(), QuantConfig(q_group_size=G))
