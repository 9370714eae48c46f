"""Port parity for DeepSeek-V2 / V3 models (MLA attention with DeepSeekMoE) at
g=64, the group DeepSeek-V2-Lite quantizes at: tiny deepseek_v2 (full q
projection, a dense first layer, softmax routing, two ungated shared
experts, yarn rope) and deepseek_v3 (q-LoRA, sigmoid routing with a
selection bias over expert groups) models with random QTPU weights built by
the port and carried over to ``quick_tpu`` by name. Prefill (the expanded
branch) and decode logits, greedy generate(), the Engine over bf16 and INT8
latent pages, native checkpoints both ways, RTN quantization, and the HF
import (``_import_deepseek``) of checkpoints the test writes, each against
the JAX package on the CPU.

Routing is discrete: every test that routes asserts that each routed
token's least routing margin (``_torch_port.least_route_gap``) is above
``GAP``, far above the few f32 ulps by which the two packages' router
inputs differ, so a comparison cannot flake on a tie."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_greedy_match, f32, least_route_gap

import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.modules.blocks as tblocks
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import init_float_params as jax_init_float
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.models.model import quantize_params as jax_quantize
from quick_tpu.runtime import generate as jax_generate, make_cache as jax_cache
from quick_tpu.runtime.serving import Engine as JaxEngine
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant
from quick_tpu_torch.models.model import model_forward, quantize_params
from quick_tpu_torch.modules.linear import Linear, QuantLinear
from quick_tpu_torch.modules.mla import MLAParams
from quick_tpu_torch.runtime import Engine, generate, make_cache

G = 64
YARN = dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=192, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
            kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            head_dim=48, rotary_dim=16, rope_scaling=YARN, num_local_experts=8,
            num_experts_per_tok=2, moe_router="deepseek", moe_intermediate_size=64,
            first_k_dense_replace=1, rms_norm_eps=1e-6)
MODELS = {
    "deepseek_v2": dict(BASE, model_type="deepseek_v2", n_shared_experts=2,
                        norm_topk_prob=False),
    "deepseek_v3": dict(BASE, model_type="deepseek_v3", q_lora_rank=64, n_shared_experts=1,
                        scoring_func="sigmoid", n_group=4, topk_group=2, norm_topk_prob=True,
                        routed_scaling_factor=2.5),
}
#: logits, as tests/test_torch_model.py; MoE layers add an f32 combine
TOL = dict(atol=3e-2, rtol=3e-2)
GAP = 1e-4


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def models():
    """Each tiny model with random g=64 QTPU weights (seed 0) built by the
    port; v3's selection bias drawn from a numpy seed; carried over to
    quick_tpu with flat_to_params."""
    out = {}
    for name, kw in MODELS.items():
        jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
        tparams = t_init_quant(tcfg, seed=0, group_size=G, device="cpu")
        rng = np.random.default_rng(1)
        for blk in tparams.blocks:
            if blk.mlp.__class__.__name__ == "MoEParams" and blk.mlp.score_bias is not None:
                blk.mlp.score_bias.copy_(torch.from_numpy(
                    (0.05 * rng.standard_normal(kw["num_local_experts"])).astype(np.float32)))
        flat = {k: _numpy(v) for k, v in params_to_flat(tparams).items()}
        out[name] = (jcfg, jck.flat_to_params(flat, jcfg, group_size=G), tcfg, tparams)
    return out


@pytest.fixture
def gaps(monkeypatch):
    """Wraps the port's moe_forward to record each call's least routing
    margin over its routed tokens."""
    seen = []
    orig = tblocks.moe_forward

    def wrapped(p, cfg, x, token_mask=None):
        seen.append(least_route_gap(p, cfg, x, token_mask))
        return orig(p, cfg, x, token_mask)

    monkeypatch.setattr(tblocks, "moe_forward", wrapped)
    return seen


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", list(MODELS))
def test_deepseek_logits_match_jax(models, gaps, name):
    """40 prompt tokens through the dense latent cache (the expanded
    prefill: causal attention at q / k 48, v 32), then four decode steps
    (the absorbed einsums): logits within the model tests' tolerance."""
    jcfg, jparams, tcfg, tparams = models[name]
    assert isinstance(tparams.blocks[0].attn, MLAParams)
    B, S, steps = 2, 40, 4
    toks = _tokens(B, S + steps)
    jc, tc = jax_cache(jcfg, B, 48), make_cache(tcfg, B, 48, device="cpu")
    assert tuple(tc.k.shape) == tuple(jc.k.shape) and tuple(tc.v.shape) == tuple(jc.v.shape)
    jforward = jax.jit(jax_forward, static_argnums=1)
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + steps)]:
        jl, jc = jforward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert len(gaps) == 2 * (1 + steps) and min(gaps) > GAP, gaps


@pytest.mark.parametrize("name", list(MODELS))
def test_deepseek_greedy_generate_matches_jax(models, gaps, name):
    """generate(): 36 prompt tokens (the expanded prefill) and 6 greedy
    tokens; a row may part only at a bf16 tie of the reference's logits.
    The prompt seed is one whose routing margins all clear GAP."""
    jcfg, jparams, tcfg, tparams = models[name]
    toks = _tokens(2, 36, seed=5)
    ref = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(toks), 6, max_seq=48))
    out = generate(tparams, tcfg, torch.from_numpy(toks), 6, max_seq=48)
    ref_logits = jax_forward(jparams, jcfg, jnp.asarray(ref[:, :-1]))[0]
    assert assert_greedy_match(out.numpy(), ref, ref_logits, 36) >= 6
    assert min(gaps) > GAP, gaps


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_deepseek_engine_streams_match_jax(models, gaps, dtype):
    """The Engine over bf16 and INT8 latent pages (one kv head, k plane 16
    wide, v plane 64) on the tiny deepseek_v2: decode windows and prefill
    sub-batches over five requests sharing a one-page prefix, greedy
    streams token-equal to the JAX Engine's and the same schedule."""
    jcfg, jparams, tcfg, tparams = models["deepseek_v2"]
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, 256, 16)]
    reqs = [(prefix + [int(t) for t in rng.integers(0, 256, int(rng.integers(2, 20)))],
             int(rng.integers(6, 14))) for _ in range(5)]
    geometry = dict(max_slots=4, max_seq=64, page_size=16, chunk=8, decode_window=4)
    outs = []
    for cls, params, cfg, extra in (
            (JaxEngine, jparams, jcfg, dict(dtype=getattr(jnp, dtype))),
            (Engine, tparams, tcfg, dict(device="cpu", dtype=getattr(torch, dtype)))):
        eng = cls(params, cfg, **geometry, **extra)
        uids = [eng.submit(p, n) for p, n in reqs]
        done = eng.run()
        outs.append(([done[u] for u in uids], eng.stats, eng))
    (jout, jstats, jeng), (tout, tstats, teng) = outs
    assert tuple(teng.cache.k_pages.shape) == tuple(jeng.cache.k_pages.shape)
    assert tuple(teng.cache.v_pages.shape[-3:]) == (1, 16, 64)
    assert tout == jout
    assert [len(o) for o in tout] == [n for _, n in reqs]
    for key, value in jstats.items():
        assert tstats[key] == value, key
    assert min(gaps) > GAP, gaps


def _assert_flat_equal(tflat, jflat):
    """Same keys in the same order, dtypes, shapes and bytes."""
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        t = tflat[k].contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert tuple(t.shape) == tuple(a.shape), k
        assert t.numpy().tobytes() == np.ascontiguousarray(a).tobytes(), k


@pytest.mark.parametrize("name", list(MODELS))
def test_deepseek_checkpoints_load_both_ways(models, tmp_path, name):
    """quick_tpu.save_quantized -> the port's from_quantized, and the port's
    save_quantized -> quick_tpu.load_quantized: equal flat dicts (the MLA
    keys, kv_b float, shared experts, v3's score_bias) and configs."""
    jcfg, jparams, tcfg, _ = models[name]
    jck.save_quantized(jparams, jcfg, JaxQuantConfig(q_group_size=G), str(tmp_path / "jax"))
    m = AutoQuickModel.from_quantized(str(tmp_path / "jax"), device="cpu")
    assert m.cfg == tcfg and m.qcfg.q_group_size == G
    _assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jparams))
    assert isinstance(m.params.blocks[1].attn.kv_b_proj, Linear)
    m.save_quantized(str(tmp_path / "port"))
    jp2, jcfg2, _ = jck.load_quantized(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    _assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jp2))


def test_deepseek_rtn_quantize_matches_jax():
    """quantize_params on a float 2-layer deepseek_v3 model (a dense and an
    MoE layer of 4 experts) at g=64: q_a / q_b, kv_a, o, the dense MLP, the
    stacked experts and the shared expert pack to the JAX package's bytes;
    kv_b, the router, the norms and the selection bias stay float."""
    kw = dict(MODELS["deepseek_v3"], num_hidden_layers=2, num_local_experts=4, n_group=2,
              topk_group=1)
    jcfg = JaxConfig(**kw)
    jfloat = jax_init_float(jcfg, jax.random.PRNGKey(2))
    tcfg = ModelConfig(**kw)
    tfloat = params_from_flat(jck.params_to_flat(jfloat), tcfg, device="cpu")
    tq = quantize_params(tfloat, tcfg, group_size=G)
    jq = jax_quantize(jfloat, jcfg, group_size=G)
    _assert_flat_equal(params_to_flat(tq), jck.params_to_flat(jq))
    a = tq.blocks[1].attn
    assert all(isinstance(x, QuantLinear) for x in (a.q_proj, a.q_b_proj, a.kv_a_proj, a.o_proj))
    assert isinstance(a.kv_b_proj, Linear) and tq.blocks[1].mlp.score_bias is not None


def test_deepseek_autoawq_refused(models, tmp_path):
    """AutoAWQ export of an MLA model raises (the JAX package maps no MLA
    or MoE keys there, ROADMAP A10)."""
    _, _, tcfg, tparams = models["deepseek_v2"]
    m = AutoQuickModel(tparams, tcfg, QuantConfig(q_group_size=G))
    with pytest.raises(NotImplementedError, match="A10"):
        m.save_quantized(str(tmp_path / "awq"), awq_format=True)


def _write_hf_deepseek(d, name, seed=0):
    """A tiny DeepSeek checkpoint in HF layout ([out, in] float32; rope
    channels in HF's interleaved order): V2-Lite style (full q_proj, a
    dense layer 0, MoE layers with shared experts) or V3 style (q-LoRA,
    e_score_correction_bias)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    kw = MODELS[name]
    D, V, L = kw["hidden_size"], kw["vocab_size"], kw["num_hidden_layers"]
    hq, R, E = kw["num_attention_heads"], kw["kv_lora_rank"], kw["num_local_experts"]
    dn, dr, dv = kw["qk_nope_head_dim"], kw["qk_rope_head_dim"], kw["v_head_dim"]
    F, Fe = kw["intermediate_size"], kw["moe_intermediate_size"]
    Fs = Fe * kw["n_shared_experts"]

    def w(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    def norm(n):
        return (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    t = {"model.embed_tokens.weight": (rng.standard_normal((V, D)) * 0.02).astype(np.float32),
         "model.norm.weight": norm(D), "lm_head.weight": w(V, D)}
    for i in range(L):
        p, a = f"model.layers.{i}", f"model.layers.{i}.self_attn"
        t.update({f"{p}.input_layernorm.weight": norm(D),
                  f"{p}.post_attention_layernorm.weight": norm(D),
                  f"{a}.kv_a_proj_with_mqa.weight": w(R + dr, D),
                  f"{a}.kv_a_layernorm.weight": norm(R),
                  f"{a}.kv_b_proj.weight": w(hq * (dn + dv), R),
                  f"{a}.o_proj.weight": w(D, hq * dv)})
        if kw.get("q_lora_rank"):
            ql = kw["q_lora_rank"]
            t.update({f"{a}.q_a_proj.weight": w(ql, D), f"{a}.q_a_layernorm.weight": norm(ql),
                      f"{a}.q_b_proj.weight": w(hq * (dn + dr), ql)})
        else:
            t[f"{a}.q_proj.weight"] = w(hq * (dn + dr), D)
        if i < kw["first_k_dense_replace"]:
            t.update({f"{p}.mlp.gate_proj.weight": w(F, D), f"{p}.mlp.up_proj.weight": w(F, D),
                      f"{p}.mlp.down_proj.weight": w(D, F)})
            continue
        t[f"{p}.mlp.gate.weight"] = w(E, D)
        for e in range(E):
            q = f"{p}.mlp.experts.{e}"
            t.update({f"{q}.gate_proj.weight": w(Fe, D), f"{q}.up_proj.weight": w(Fe, D),
                      f"{q}.down_proj.weight": w(D, Fe)})
        q = f"{p}.mlp.shared_experts"
        t.update({f"{q}.gate_proj.weight": w(Fs, D), f"{q}.up_proj.weight": w(Fs, D),
                  f"{q}.down_proj.weight": w(D, Fs)})
        if name == "deepseek_v3":
            t[f"{p}.mlp.gate.e_score_correction_bias"] = (
                0.1 * rng.standard_normal(E)).astype(np.float32)
    d.mkdir(parents=True, exist_ok=True)
    save_file(t, str(d / "model.safetensors"))
    hf = dict(model_type=name, vocab_size=V, hidden_size=D, intermediate_size=F,
              moe_intermediate_size=Fe, num_hidden_layers=L, num_attention_heads=hq,
              num_key_value_heads=hq, n_shared_experts=kw["n_shared_experts"], n_routed_experts=E,
              num_experts_per_tok=kw["num_experts_per_tok"], kv_lora_rank=R,
              q_lora_rank=kw.get("q_lora_rank"), qk_nope_head_dim=dn, qk_rope_head_dim=dr,
              v_head_dim=dv, first_k_dense_replace=kw["first_k_dense_replace"], moe_layer_freq=1,
              max_position_embeddings=128, rope_theta=10000.0, rope_scaling=YARN,
              rms_norm_eps=1e-6, norm_topk_prob=kw["norm_topk_prob"],
              scoring_func=kw.get("scoring_func", "softmax"),
              routed_scaling_factor=kw.get("routed_scaling_factor", 1.0),
              topk_method="noaux_tc" if name == "deepseek_v3" else "greedy",
              n_group=kw.get("n_group", 1), topk_group=kw.get("topk_group", 1),
              tie_word_embeddings=False)
    (d / "config.json").write_text(json.dumps(hf))
    return d


@pytest.mark.parametrize("name", list(MODELS))
def test_import_deepseek_matches_jax(tmp_path, name):
    """The HF float importer's deepseek branch on a checkpoint the test
    writes: config and params byte-equal to quick_tpu's ``_import_deepseek``
    (the interleaved rope channels of q / q_b and kv_a permuted to
    rotate-half, experts stacked, shared experts, v3's bias in f32)."""
    d = _write_hf_deepseek(tmp_path / "hf", name)
    jparams, jcfg = jck.load_hf_float(str(d))
    m = AutoQuickModel.from_pretrained(str(d), device="cpu")
    assert m.cfg.to_dict() == jcfg.to_dict() and m.cfg.is_mla
    _assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jparams))
    if name == "deepseek_v3":
        assert m.params.blocks[1].mlp.score_bias.dtype == torch.float32


def test_deepseek_v2_lite_geometry():
    """The DeepSeek-V2-Lite preset's latent caches: a dense cache and an
    Engine pool of one kv head with k_pe 64 and latent 512 wide; the INT8
    pool's bytes are 608 / 1152 of the bf16 pool's (576 code bytes plus an
    8 x 64 f32 scale tile per 64-token page, against 1152 bytes a token)."""
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.modules.mla import make_mla_cache
    from quick_tpu_torch.modules.paged_cache import PagedKVCache

    cfg = dataclasses.replace(PRESETS["deepseek-v2-lite"], num_hidden_layers=1)
    c = make_mla_cache(cfg, 2, 128, device="cpu")
    assert tuple(c.k.shape) == (1, 2, 1, 128, 64) and tuple(c.v.shape) == (1, 2, 1, 128, 512)
    pools = {}
    for dt in (torch.bfloat16, torch.int8):
        pc = PagedKVCache.create(1, 5, 64, 2, 128, 1, 64, dt, device="cpu", v_head_dim=512)
        pools[dt] = sum(t.numel() * t.element_size()
                        for t in (pc.k_pages, pc.v_pages, pc.kv_scales) if t is not None)
    assert pools[torch.int8] / pools[torch.bfloat16] == pytest.approx(608 / 1152)
