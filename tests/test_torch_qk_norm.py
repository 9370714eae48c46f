"""Port parity for qwen3's per-head q / k RMSNorm (qwen3 and qwen3_moe): a
tiny quantized model of each, built by quick_tpu with random norm weights
and carried over by name, gives the JAX package's prefill and decode logits
over the dense and the paged cache and its greedy tokens; the QTPU
checkpoint keeps ``q_norm`` / ``k_norm`` both ways; one qwen3 block's AWQ
search makes the JAX package's picks and packs its bytes.

The JAX package runs eagerly (``jax.disable_jit``): its jitted forward
rounds as XLA-CPU fuses it, which moves with the host (ROADMAP C, known
divergences); the port equals the eager one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _awq_parity import assert_close, assert_params_equal, check_searches, recorded, to_torch
from _torch_port import f32, least_route_gap

import quick_tpu.quantize.awq as jawq
import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.modules.blocks as tblocks
import quick_tpu_torch.quantize.awq as tawq
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import init_float_params as jax_init_float
from quick_tpu.models import init_quant_params as jax_init_quant, model_forward as jax_forward
from quick_tpu.modules.paged_cache import PagedKVCache as JPaged
from quick_tpu.runtime import generate as jax_generate, make_cache as jax_cache
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.modules.linear import QuantLinear
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.runtime import generate, make_cache
from quick_tpu_torch.utils.checkpoint import load_quantized, save_quantized

BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            max_position_embeddings=64, rms_norm_eps=1e-6)
MODELS = {
    "qwen3": dict(BASE, model_type="qwen3", use_qk_norm=True),
    # qwen3_moe: softmax over all experts, renormalized top-k, no shared
    # expert
    "qwen3_moe": dict(BASE, model_type="qwen3_moe", use_qk_norm=True, num_local_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=128,
                      moe_router="softmax_all", moe_freq_shifted=True, norm_topk_prob=True),
}
#: logits, as tests/test_torch_model.py
TOL = dict(atol=3e-2, rtol=3e-2)
#: least gap between the k-th and (k+1)-th router logit of a routed token
GAP = 1e-4
B, PROMPT, STEPS, MAX_SEQ = 2, 10, 3, 32
TABLE = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # 8-token pages


def _random_norms(flat: dict, kw: dict, seed: int) -> dict:
    """Random q / k norm weights (bf16, 1 + 0.3 N(0, 1)), so that the norm
    weights move the logits and not only the normalization."""
    rng = np.random.default_rng(seed)
    for i in range(kw["num_hidden_layers"]):
        for nm in ("q_norm", "k_norm"):
            v = 1.0 + 0.3 * rng.standard_normal(kw["head_dim"])
            flat[f"blocks.{i}.attn.{nm}"] = np.asarray(jnp.asarray(v, jnp.bfloat16))
    return flat


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """quick_tpu's random quantized model (seed 0) with random norm weights,
    and the port's copy of it. The attention linears' scales are 16x the
    initializer's and the MLPs' 4x, so that the blocks move the residual
    stream and the qk-norm moves the logits by more than ten times their
    tolerance."""
    kw = MODELS[request.param]
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    flat = _random_norms(jck.params_to_flat(jax_init_quant(jcfg, jax.random.PRNGKey(0))), kw, 1)
    for k in flat:
        if k.startswith("blocks.") and k.endswith(("scales", "zeros_x_scales")):
            flat[k] = flat[k] * (16 if ".attn." in k else 4)
    return (request.param, jcfg, jck.flat_to_params(flat, jcfg), tcfg,
            params_from_flat(flat, tcfg, device="cpu"))


@pytest.fixture
def gaps(monkeypatch):
    """The least routing gap of every MoE call the port makes."""
    seen = []
    orig = tblocks.moe_forward

    def wrapped(p, cfg, x, token_mask=None):
        seen.append(least_route_gap(p, cfg, x, token_mask))
        return orig(p, cfg, x, token_mask)

    monkeypatch.setattr(tblocks, "moe_forward", wrapped)
    return seen


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (B, S)).astype(np.int32)


def _caches(jcfg, tcfg, paged: bool):
    L, hkv, hd = BASE["num_hidden_layers"], BASE["num_key_value_heads"], BASE["head_dim"]
    if paged:
        jc = JPaged.create(L, 9, 8, max_slots=B, max_seq=MAX_SEQ, n_kv=hkv, head_dim=hd,
                           dtype=jnp.bfloat16)
        jc = dataclasses.replace(jc, block_table=jnp.asarray(TABLE))
        tc = PagedKVCache.create(L, 9, 8, B, MAX_SEQ, hkv, hd, torch.bfloat16, device="cpu")
        tc.block_table.copy_(torch.from_numpy(TABLE))
        return jc, tc
    return jax_cache(jcfg, B, MAX_SEQ), make_cache(tcfg, B, MAX_SEQ, device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_logits_match_eager_jax(pair, gaps, paged):
    """A 10-token prefill and 3 decode steps over the cache: the port's
    logits within the model tolerance of quick_tpu's at every step; MoE
    routes only where the experts' ranking has a margin above ``GAP``."""
    name, jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(PROMPT + STEPS, 2)
    jc, tc = _caches(jcfg, tcfg, paged)
    for lo, hi in [(0, PROMPT)] + [(t, t + 1) for t in range(PROMPT, PROMPT + STEPS)]:
        with jax.disable_jit():
            jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    if name == "qwen3_moe":
        assert len(gaps) == 2 * (1 + STEPS) and min(gaps) > GAP, gaps
    if name == "qwen3" and not paged:
        # the norm is live: without it the logits leave the tolerance
        off, _ = model_forward(tparams, dataclasses.replace(tcfg, use_qk_norm=False),
                               torch.from_numpy(toks[:, :PROMPT]).long())
        on, _ = model_forward(tparams, tcfg, torch.from_numpy(toks[:, :PROMPT]).long())
        assert np.abs(f32(off) - f32(on)).max() > 10 * TOL["atol"]


def test_greedy_generate_matches_eager_jax(pair, gaps):
    """generate(): the same greedy tokens as quick_tpu's."""
    name, jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(8, 3)
    with jax.disable_jit():
        ref = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(toks), 5, max_seq=16))
    out = generate(tparams, tcfg, torch.from_numpy(toks), 5, max_seq=16)
    np.testing.assert_array_equal(out.numpy(), ref)
    if name == "qwen3_moe":
        assert min(gaps) > GAP, gaps


def test_qtpu_checkpoint_keeps_qk_norms(pair, tmp_path):
    """A QTPU checkpoint with q_norm / k_norm loads in either package with
    every tensor byte-equal (the JAX round trip: tests/test_checkpoint.py)."""
    name, jcfg, jparams, tcfg, tparams = pair
    save_quantized(tparams, tcfg, QuantConfig(), str(tmp_path / "port"))
    jp, jc, _ = jck.load_quantized(str(tmp_path / "port"))
    assert jc.use_qk_norm and jp.blocks[0].attn.q_norm is not None
    assert_params_equal(tparams, jp)
    jck.save_quantized(jparams, jcfg, JaxQuantConfig(), str(tmp_path / "jax"))
    tp, tc, _ = load_quantized(str(tmp_path / "jax"), device="cpu")
    assert tc == tcfg
    assert_params_equal(tp, jparams)
    assert "blocks.1.attn.k_norm" in params_to_flat(tp)


AWQ = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=32,
           max_position_embeddings=64, rms_norm_eps=1e-6, model_type="qwen3",
           use_qk_norm=True)
G = 32
CALIB = (2, 32)


def test_awq_qwen3_block_matches_eager_jax(monkeypatch):
    """One qwen3 block (GQA, random q / k norm weights) from the same input:
    every search by ``_awq_parity.check_searches``' rule; with the JAX grid
    choices imposed, every packed code, scale and norm byte-equal, the norms
    carried, and x_next within one bf16 step."""
    jcfg, tcfg = JaxConfig(**AWQ), ModelConfig(**AWQ)
    flat = _random_norms(jck.params_to_flat(jax_init_float(jcfg, jax.random.PRNGKey(4))), AWQ, 5)
    jparams = jck.flat_to_params(flat, jcfg)
    tparams = params_from_flat(flat, tcfg, device="cpu")
    calib = np.random.default_rng(6).integers(0, AWQ["vocab_size"], CALIB).astype(np.int32)
    x = jparams.embed[jnp.asarray(calib)].astype(jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(CALIB[1])[None], CALIB)
    with recorded(monkeypatch, impose=True) as (jrec, prec):
        with jax.disable_jit():
            ref = jawq.awq_quantize_block(jparams.blocks[0], jcfg, x, pos, jparams.rope_cos,
                                          jparams.rope_sin, JaxQuantConfig(q_group_size=G))
        out = tawq.awq_quantize_block(tparams.blocks[0], tcfg, to_torch(x),
                                      torch.from_numpy(np.array(pos)), tparams.rope_cos,
                                      tparams.rope_sin, QuantConfig(q_group_size=G))
    assert [r[0] for r in prec] == ["scale", "clip", "clip", "scale", "scale", "clip", "clip"]
    check_searches(jrec, prec)
    assert_close(out.x_next, ref.x_next, 2.0 ** -7, "x_next")
    assert torch.equal(out.block.attn.q_norm, tparams.blocks[0].attn.q_norm)
    assert_params_equal(out.block, ref.block)


def test_quantize_accepts_qwen3_moe():
    """AutoQuickModel.quantize(calib) runs on a 1-layer qwen3_moe (the
    attention's qk-norm branch beside the MoE search) and packs every
    expert; the result runs model_forward."""
    kw = dict(MODELS["qwen3_moe"], num_hidden_layers=1, vocab_size=128)
    m = AutoQuickModel.from_random(ModelConfig(**kw), seed=0, device="cpu")
    calib = np.random.default_rng(7).integers(0, 128, (1, 16)).astype(np.int32)
    m.quantize(calib, QuantConfig(q_group_size=G), verbose=False)
    blk = m.params.blocks[0]
    assert blk.attn.q_norm is not None and isinstance(blk.mlp.gate_up_proj, QuantLinear)
    logits, _ = model_forward(m.params, m.cfg, torch.from_numpy(calib).long())
    assert bool(torch.isfinite(logits).all())
