"""Port parity for the MoE slice: routing, the grouped expert GEMM's plain
version, ``moe_forward``, tiny Mixtral and qwen2_moe models (prefill and
decode logits, greedy generate, the Engine), MoE checkpoints and the HF
float import, each against ``quick_tpu`` on the CPU on inputs made from a
numpy seed.

Routing is discrete: a token whose k-th and (k+1)-th router scores nearly
tie could pick other experts in the two packages and change its output by
far more than any tolerance. Each test that routes asserts that the
smallest such gap on its inputs is above ``GAP``, far above the few f32
ulps by which the two packages' router inputs differ here, so the
comparisons cannot flake on a tie."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.modules.blocks as tblocks
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.modules.blocks import moe_forward as jax_moe_forward
from quick_tpu.ops import grouped_matmul as jgm
from quick_tpu.runtime import generate as jax_generate, make_cache as jax_cache
from quick_tpu.runtime.serving import Engine as JaxEngine
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant, model_forward
from quick_tpu_torch.ops import grouped_matmul as tgm
from quick_tpu_torch.runtime import Engine, generate, make_cache

BASE = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
MODELS = {
    "mixtral": dict(BASE, num_local_experts=4, num_experts_per_tok=2, model_type="mixtral"),
    # qwen2_moe: softmax over all experts, no renormalization, qkv biases,
    # a shared expert gated by sigmoid(shared_expert_gate(x))
    "qwen2_moe": dict(BASE, num_key_value_heads=4, num_local_experts=8, num_experts_per_tok=4,
                      moe_intermediate_size=128, shared_intermediate_size=256,
                      model_type="qwen2_moe", moe_router="softmax_all", moe_freq_shifted=True,
                      attention_bias=True, shared_expert_gate=True, n_shared_experts=1,
                      norm_topk_prob=False),
}
#: logits, as tests/test_torch_model.py; MoE layers add an f32 combine
TOL = dict(atol=3e-2, rtol=3e-2)
#: bf16 outputs of f32 sums taken in other orders: one bf16 step (2^-7
#: relative) and a little
TOL_BF16 = dict(atol=1e-2, rtol=1e-2)
#: least gap between the k-th and (k+1)-th router logit of every routed
#: token
GAP = 1e-4


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _min_gap(scores: torch.Tensor, k: int) -> float:
    v = torch.sort(scores.to(torch.float32), dim=-1, descending=True).values
    return float((v[..., k - 1] - v[..., k]).min())


def _logits(p, x: torch.Tensor) -> torch.Tensor:
    """Router logits; both routers pick the top-k of them (softmax_all's
    softmax keeps their order)."""
    return p.router(x.to(torch.float32))


@pytest.fixture
def gaps(monkeypatch):
    """Wraps the port's moe_forward to record the least routing gap of the
    tokens each call routes (masked tokens carry no weight)."""
    seen = []
    orig = tblocks.moe_forward

    def wrapped(p, cfg, x, token_mask=None):
        s = _logits(p, x)
        if token_mask is not None:
            s = s[token_mask]
        if s.numel():
            seen.append(_min_gap(s, cfg.num_experts_per_tok))
        return orig(p, cfg, x, token_mask)

    monkeypatch.setattr(tblocks, "moe_forward", wrapped)
    return seen


@pytest.fixture(scope="module")
def float_models():
    """One MoE layer of each tiny model with float (bf16) experts, router
    and shared expert, made with numpy and handed to both packages."""
    from quick_tpu.modules.blocks import MoEParams as JaxMoE
    from quick_tpu.modules.linear import Linear as JaxLinear
    from quick_tpu_torch.modules.blocks import MoEParams
    from quick_tpu_torch.modules.linear import Linear

    rng = np.random.default_rng(4)
    out = {}
    for name, kw in MODELS.items():
        D, E = kw["hidden_size"], kw["num_local_experts"]
        F = kw.get("moe_intermediate_size") or kw["intermediate_size"]
        Fs = kw.get("shared_intermediate_size")

        def w(*shape):
            return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

        arrays = dict(router=w(D, E), gate_up_proj=w(E, D, 2 * F), down_proj=w(E, F, D))
        if Fs:
            arrays.update(shared_gate_up=w(D, 2 * Fs), shared_down=w(Fs, D), shared_gate=w(D, 1))
        jp = JaxMoE(**{k: JaxLinear(jnp.asarray(a, jnp.bfloat16)) for k, a in arrays.items()})
        tp = MoEParams(**{k: Linear(torch.from_numpy(a).to(torch.bfloat16))
                          for k, a in arrays.items()})
        out[name] = (JaxConfig(**kw), jp, ModelConfig(**kw), tp)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def quant_models():
    """Each tiny MoE model with random QTPU weights (seed 0), built by the
    port and carried over to quick_tpu by name (flat_to_params)."""
    out = {}
    for name, kw in MODELS.items():
        jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
        tparams = t_init_quant(tcfg, seed=0, device="cpu")
        flat = {k: _numpy(v) for k, v in params_to_flat(tparams).items()}
        out[name] = (jcfg, jck.flat_to_params(flat, jcfg), tcfg, tparams)
    return out


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (B, S)).astype(np.int32)


# ------------------------------------------------------------------ routing

ROUTING = {  # (T, kk, E, bm, seed)
    "sort": (13, 2, 5, 8, 0),
    "sort_bm32_many_experts": (40, 4, 60, 32, 1),
    "sort_free_decode": (2, 2, 16, 8, 5),
    "sort_free_mixtral_b4": (4, 2, 8, 32, 2),
}


@pytest.mark.parametrize("case", list(ROUTING))
def test_build_routing_equals_jax(case):
    """Both branches (sort-free at T * kk <= E): every integer output equal."""
    T, kk, E, bm, seed = ROUTING[case]
    rng = np.random.default_rng(seed)
    sel = np.stack([rng.choice(E, kk, replace=False) for _ in range(T)]).astype(np.int32)
    ref = jgm.build_routing(jnp.asarray(sel), E, bm)
    out = tgm.build_routing(torch.from_numpy(sel), E, bm)
    for name, r, o in zip(("tok_rows", "pos", "tile_expert", "tile_live", "valid"), ref, out):
        assert o.dtype == (torch.bool if name == "valid" else torch.int32), name
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)


def test_build_routing_empty_experts_and_budgets():
    """Everything routed to one expert: the others own no tile; the row
    budget and tile height match quick_tpu's."""
    sel = np.full((5, 2), 3, np.int32)
    ref = jgm.build_routing(jnp.asarray(sel), 8, 8)
    out = tgm.build_routing(torch.from_numpy(sel), 8, 8)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert int(out[3].sum()) == 2
    for tk, e in [(4, 60), (8, 8), (32, 8), (256, 8), (1024, 8), (512, 60), (2000, 8)]:
        assert tgm.pick_grouped_bm(tk, e) == jgm.pick_grouped_bm(tk, e)
        for bm in (16, 32, 64, 128):
            assert tgm.grouped_row_budget(tk, e, bm) == jgm.grouped_row_budget(tk, e, bm)


def test_top_k_ties_take_the_lower_index_as_lax():
    """The port's top_k orders ties as lax.top_k does (the all-zero rows of
    masked tokens in _grouped_moe are all ties)."""
    x = np.asarray([[0.0, 0.0, 0.0, 0.0], [1.0, 3.0, 3.0, 1.0], [2.0, 2.0, 5.0, 2.0]],
                   np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tblocks.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------- the grouped GEMM

def _grouped_inputs(bm, seed=3):
    """E=4 experts, K=N=256, six tiles: expert 1 gets none, the last tile
    is dead."""
    rng = np.random.default_rng(seed)
    E, K, N = 4, 256, 256
    qw = rng.integers(-2**31, 2**31, (E, K // 8, N), dtype=np.int64).astype(np.int32)
    s = ((rng.uniform(size=(E, K // 128, N)) * 0.004 + 0.001) / 16).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // 128, N)) * 15) * s).astype(np.float32)
    te = np.asarray([0, 0, 2, 3, 3, 3], np.int32)
    live = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
    x = rng.standard_normal((len(te) * bm, K)).astype(np.float32)
    return x, qw, s, zs, te, live


@pytest.mark.parametrize("bm", [16, 32])
@pytest.mark.parametrize("ref", ["fallback", "pallas_interpret"])
def test_grouped_plain_matches_jax(monkeypatch, bm, ref):
    """The plain version against quick_tpu's XLA fallback and against its
    Pallas kernel in interpret mode: dead tiles zero, within one bf16
    step."""
    x, qw, s, zs, te, live = _grouped_inputs(bm)
    xj, xt = _bf16(x)
    if ref == "fallback":
        want = jgm._grouped_fallback(xj, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs),
                                     jnp.asarray(te), jnp.asarray(live), bm, 128, jnp.bfloat16)
    else:
        monkeypatch.setenv("QUICK_TPU_PALLAS_INTERPRET", "1")
        want = jgm.quantized_matmul_grouped(
            xj, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs), jnp.asarray(te), bm,
            tile_live=jnp.asarray(live))
    got = tgm.quantized_matmul_grouped(
        xt, torch.from_numpy(qw), torch.from_numpy(s), torch.from_numpy(zs),
        torch.from_numpy(te), torch.from_numpy(live), bm)
    assert got.dtype == torch.bfloat16 and got.shape == (len(te) * bm, 256)
    np.testing.assert_allclose(f32(got), f32(want), **TOL_BF16)
    assert not f32(got)[5 * bm:].any()


def test_grouped_a8_is_refused():
    """``a8`` was refused until the grouped W4A8 kernel (K12) was ported;
    now it is taken: on CPU tensors the plain version of K12 matches
    quick_tpu's ``_grouped_fallback(a8=True)`` within one bf16 step."""
    x, qw, s, zs, te, live = _grouped_inputs(32)
    xj, xt = _bf16(x)
    got = tgm.quantized_matmul_grouped(xt, torch.from_numpy(qw), torch.from_numpy(s),
                                       torch.from_numpy(zs), torch.from_numpy(te),
                                       torch.from_numpy(live), 32, a8=True)
    want = jgm._grouped_fallback(xj, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs),
                                 jnp.asarray(te), jnp.asarray(live), 32, 128, jnp.bfloat16,
                                 a8=True)
    np.testing.assert_allclose(f32(got), f32(want), **TOL_BF16)


# ------------------------------------------------------------ moe_forward

MOE_CASES = {  # (model, quantized, x shape, masked tail)
    "mixtral_grouped": ("mixtral", True, (2, 24), 0),
    "mixtral_sort_free_decode": ("mixtral", True, (1, 2), 0),
    "mixtral_token_mask": ("mixtral", True, (2, 20), 6),
    "softmax_all_shared_gate": ("qwen2_moe", True, (2, 20), 0),
    "float_experts_per_expert": ("mixtral", False, (1, 4), 0),
    "float_experts_einsum": ("qwen2_moe", False, (2, 24), 0),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_jax(quant_models, float_models, case):
    """One MoE layer on the same bf16 input: quantized experts through the
    grouped path (sort and sort-free), a token mask, the softmax_all router
    with its gated shared expert, and float experts on both of their
    dispatches (per expert at B*S <= 32, the einsum above)."""
    name, quantized, (B, S), masked = MOE_CASES[case]
    if quantized:
        jcfg, jparams, tcfg, tparams = quant_models[name]
        jp, tp = jparams.blocks[0].mlp, tparams.blocks[0].mlp
    else:
        jcfg, jp, tcfg, tp = float_models[name]
    x = np.random.default_rng(7).standard_normal((B, S, BASE["hidden_size"])).astype(np.float32)
    xj, xt = _bf16(x)
    mask = np.ones((B, S), bool)
    if masked:
        mask[:, S - masked:] = False
    assert _min_gap(_logits(tp, xt)[torch.from_numpy(mask)],
                    tcfg.num_experts_per_tok) > GAP
    want = jax_moe_forward(jp, jcfg, xj, token_mask=jnp.asarray(mask) if masked else None)
    got = tblocks.moe_forward(tp, tcfg, xt, torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **TOL_BF16)


def test_moe_router_and_model_type_refusals(tmp_path):
    """A router the port does not run and cohere's LayerNorm qk-norm (A12;
    qwen3_moe's per-head RMS form runs, tests/test_torch_qk_norm.py) raise;
    so do AutoAWQ import and export of MoE models (the JAX package maps
    none either, A10)."""
    with pytest.raises(NotImplementedError, match="router"):
        t_init_quant(ModelConfig(**dict(MODELS["mixtral"], moe_router="expert_choice")),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        t_init_quant(ModelConfig(**dict(MODELS["qwen2_moe"], model_type="qwen3_moe",
                                        use_qk_norm=True, layernorm="layernorm",
                                        norm_topk_prob=True)), device="cpu")
    m = AutoQuickModel(t_init_quant(ModelConfig(**MODELS["mixtral"]), device="cpu"),
                       ModelConfig(**MODELS["mixtral"]), QuantConfig())
    with pytest.raises(NotImplementedError, match="A10"):
        m.save_quantized(str(tmp_path / "awq"), awq_format=True)
    d = tmp_path / "awq_in"
    d.mkdir()
    hf = dict(model_type="mixtral", vocab_size=512, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              num_local_experts=4, num_experts_per_tok=2)
    (d / "config.json").write_text(json.dumps(hf))
    QuantConfig(version="gemm").save_pretrained(str(d))
    with pytest.raises(NotImplementedError, match="A10"):
        AutoQuickModel.from_quantized(str(d), device="cpu")


# ---------------------------------------------------------- tiny models

@pytest.mark.parametrize("name", list(MODELS))
def test_moe_model_logits_match(quant_models, gaps, name):
    """Prefill logits over 36 tokens (the sort branch), then four decode
    steps (the sort-free branch at B=2)."""
    jcfg, jparams, tcfg, tparams = quant_models[name]
    B, S, steps = 2, 36, 4
    toks = _tokens(B, S + steps)
    jc, tc = jax_cache(jcfg, B, 48), make_cache(tcfg, B, 48, device="cpu")
    jforward = jax.jit(jax_forward, static_argnums=1)  # one compile, not op by op
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + steps)]:
        jl, jc = jforward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert len(gaps) == 2 * (1 + steps) and min(gaps) > GAP, gaps


@pytest.mark.parametrize("name", list(MODELS))
def test_moe_greedy_generate_token_identical(quant_models, gaps, name):
    jcfg, jparams, tcfg, tparams = quant_models[name]
    toks = _tokens(2, 8, seed=3)
    ref = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(toks), 6, max_seq=16))
    out = generate(tparams, tcfg, torch.from_numpy(toks), 6, max_seq=16)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert min(gaps) > GAP, gaps


def test_moe_engine_greedy_streams_match_jax(quant_models, gaps):
    """The Engine on the tiny Mixtral, decode windows and prefill
    sub-batches with masked padding rows: greedy streams token-equal to
    the JAX Engine's, and the same schedule."""
    jcfg, jparams, tcfg, tparams = quant_models["mixtral"]
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, 512, 16)]
    reqs = [(prefix + [int(t) for t in rng.integers(0, 512, int(rng.integers(2, 20)))],
             int(rng.integers(6, 14))) for _ in range(5)]
    geometry = dict(max_slots=4, max_seq=64, page_size=16, chunk=8, decode_window=4)
    outs = []
    for cls, params, cfg, extra in ((JaxEngine, jparams, jcfg, {}),
                                    (Engine, tparams, tcfg, dict(device="cpu"))):
        eng = cls(params, cfg, **geometry, **extra)
        uids = [eng.submit(p, n) for p, n in reqs]
        done = eng.run()
        outs.append(([done[u] for u in uids], eng.stats))
    (jout, jstats), (tout, tstats) = outs
    assert tout == jout
    assert [len(o) for o in tout] == [n for _, n in reqs]
    for key, value in jstats.items():
        assert tstats[key] == value, key
    assert min(gaps) > GAP, gaps


# ------------------------------------------------------------ checkpoints

def _assert_flat_equal(tflat, jflat):
    """Same keys in the same order, dtypes, shapes and bytes."""
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        t = tflat[k].contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert tuple(t.shape) == tuple(a.shape), k
        assert t.numpy().tobytes() == np.ascontiguousarray(a).tobytes(), k


@pytest.mark.parametrize("name", list(MODELS))
def test_moe_checkpoints_load_both_ways(quant_models, tmp_path, name):
    """quick_tpu.save_quantized -> the port's from_quantized, and the port's
    save_quantized -> quick_tpu.load_quantized: equal flat dicts (router,
    stacked experts, shared expert and gate included) and configs."""
    jcfg, jparams, tcfg, _ = quant_models[name]
    jck.save_quantized(jparams, jcfg, JaxQuantConfig(), str(tmp_path / "jax"))
    m = AutoQuickModel.from_quantized(str(tmp_path / "jax"), device="cpu")
    assert m.cfg == tcfg
    _assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jparams))
    m.save_quantized(str(tmp_path / "port"))
    jp2, jcfg2, _ = jck.load_quantized(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    _assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jp2))


def _write_hf_moe(d, name, seed=0):
    """A tiny Mixtral or qwen2_moe in HF layout ([out, in] float32)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    kw = MODELS[name]
    D, V, L = kw["hidden_size"], kw["vocab_size"], kw["num_hidden_layers"]
    hq, hkv, E = kw["num_attention_heads"], kw["num_key_value_heads"], kw["num_local_experts"]
    hd = D // hq

    def w(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    t = {"model.embed_tokens.weight": (rng.standard_normal((V, D)) * 0.02).astype(np.float32),
         "model.norm.weight": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
         "lm_head.weight": w(V, D)}
    for i in range(L):
        p = f"model.layers.{i}"
        t.update({
            f"{p}.self_attn.q_proj.weight": w(hq * hd, D),
            f"{p}.self_attn.k_proj.weight": w(hkv * hd, D),
            f"{p}.self_attn.v_proj.weight": w(hkv * hd, D),
            f"{p}.self_attn.o_proj.weight": w(D, hq * hd),
            f"{p}.input_layernorm.weight": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            f"{p}.post_attention_layernorm.weight": np.ones(D, np.float32),
        })
        if name == "mixtral":
            F = kw["intermediate_size"]
            t[f"{p}.block_sparse_moe.gate.weight"] = w(E, D)
            for e in range(E):
                q = f"{p}.block_sparse_moe.experts.{e}"
                t.update({f"{q}.w1.weight": w(F, D), f"{q}.w3.weight": w(F, D),
                          f"{q}.w2.weight": w(D, F)})
        else:
            F, Fs = kw["moe_intermediate_size"], kw["shared_intermediate_size"]
            t[f"{p}.mlp.gate.weight"] = w(E, D)
            for e in range(E):
                q = f"{p}.mlp.experts.{e}"
                t.update({f"{q}.gate_proj.weight": w(F, D), f"{q}.up_proj.weight": w(F, D),
                          f"{q}.down_proj.weight": w(D, F)})
            q = f"{p}.mlp.shared_expert"
            t.update({f"{q}.gate_proj.weight": w(Fs, D), f"{q}.up_proj.weight": w(Fs, D),
                      f"{q}.down_proj.weight": w(D, Fs),
                      f"{p}.mlp.shared_expert_gate.weight": w(1, D)})
            for b, n in (("q", hq), ("k", hkv), ("v", hkv)):
                t[f"{p}.self_attn.{b}_proj.bias"] = (0.1 * rng.standard_normal(n * hd)).astype(
                    np.float32)
    d.mkdir(parents=True, exist_ok=True)
    save_file(t, str(d / "model.safetensors"))
    hf = dict(model_type=name, vocab_size=V, hidden_size=D, intermediate_size=kw["intermediate_size"],
              num_hidden_layers=L, num_attention_heads=hq, num_key_value_heads=hkv,
              max_position_embeddings=64, rms_norm_eps=1e-5, tie_word_embeddings=False)
    if name == "mixtral":
        hf.update(num_local_experts=E, num_experts_per_tok=kw["num_experts_per_tok"])
    else:
        hf.update(num_experts=E, num_experts_per_tok=kw["num_experts_per_tok"],
                  moe_intermediate_size=kw["moe_intermediate_size"],
                  shared_expert_intermediate_size=kw["shared_intermediate_size"],
                  decoder_sparse_step=1, norm_topk_prob=False)
    (d / "config.json").write_text(json.dumps(hf))
    return d


@pytest.mark.parametrize("name", list(MODELS))
def test_moe_hf_float_import_and_rtn_match(tmp_path, name):
    """The HF float importer's MoE branch (mixtral block_sparse_moe,
    qwen2_moe experts with the gated shared expert): identical params to
    quick_tpu's. Then RTN: each stacked expert packs to the bytes its own
    linear packs to (QuantLinear.from_float, held to quick_tpu's packer in
    tests/test_torch_quantize.py), the shared expert is quantized, and the
    router and shared gate stay float."""
    from quick_tpu_torch.modules.linear import Linear, QuantLinear

    d = _write_hf_moe(tmp_path / "hf", name)
    jparams, jcfg = jck.load_hf_float(str(d))
    m = AutoQuickModel.from_pretrained(str(d), device="cpu")
    assert m.cfg.to_dict() == jcfg.to_dict()
    _assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jparams))
    float_mlp = m.params.blocks[1].mlp
    m.quantize(quant_config=QuantConfig(), use_awq_search=False)
    mlp = m.params.blocks[1].mlp
    for proj in ("gate_up_proj", "down_proj"):
        stacked, ref = getattr(mlp, proj), getattr(float_mlp, proj).weight
        for e in range(ref.shape[0]):
            one = QuantLinear.from_float(ref[e])
            for field in ("qweight", "scales", "zeros_x_scales"):
                assert torch.equal(getattr(stacked, field)[e], getattr(one, field)), (proj, e)
    assert isinstance(mlp.router, Linear) and mlp.router is float_mlp.router
    if name == "qwen2_moe":
        assert isinstance(mlp.shared_gate_up, QuantLinear) and isinstance(mlp.shared_down, QuantLinear)
        assert mlp.shared_gate is float_mlp.shared_gate
