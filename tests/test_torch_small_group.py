"""Port parity for small-group W4A16 (G = 32, GGUF's group, and G = 64):
K9's plain version against the Pallas ``_make_kernel_dequant`` (interpret
mode) and the JAX package's jnp route, K8's plain version at small G
against ``_grouped_fallback``, tiny g=32 llama and g=64 qwen2_moe models
through greedy generate(), and SamplingParams' history penalties at every
entry point (the Engine's only under enable_penalties, ROADMAP A6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_greedy_match, f32

import quick_tpu.ops.grouped_matmul as jgm
import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.modules.blocks as tblocks
import quick_tpu_torch.ops.grouped_matmul as tgm
import quick_tpu_torch.ops.quantized_matmul as tqm
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.ops.quantized_matmul import _quantized_matmul_2d, quantized_matmul as jax_qmm
from quick_tpu.quantize.numerics import quantize_tensor
from quick_tpu.quantize.packing import pack_qtpu
from quick_tpu.runtime import generate as jax_generate
from quick_tpu.runtime.generate import SamplingParams as JaxSamplingParams
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant
from quick_tpu_torch.runtime import Engine, SamplingParams, decode_loop, generate, make_cache

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
#: as tests/test_torch_quantized_matmul.py (the JAX GEMM tests' tolerance)
TOL = dict(atol=2e-2, rtol=2e-2)


def _case(rng, M, K, N, G):
    """The JAX GEMM tests' inputs (tests/test_quantized_matmul.py::_make_case):
    RTN-quantized weights, bf16 activations as a JAX array and a tensor."""
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    qt = quantize_tensor(jnp.asarray(w), group_size=G)
    qw = pack_qtpu(np.asarray(qt.q), G)
    s = np.asarray(qt.scales)
    zs = np.asarray(qt.zeros * qt.scales, np.float32)
    xj = jnp.asarray((rng.standard_normal((M, K)) * 0.5).astype(np.float32), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    return (xj, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs),
            xt, *(torch.from_numpy(np.array(a)) for a in (qw, s, zs)))


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels in interpret mode. The switch is read when a jitted
    function is traced, so the jit caches are cleared on the way in and out."""
    jax.clear_caches()
    monkeypatch.setenv("QUICK_TPU_PALLAS_INTERPRET", "1")
    yield
    monkeypatch.delenv("QUICK_TPU_PALLAS_INTERPRET")
    jax.clear_caches()


# ------------------------------------------------------------ K9's contract


@pytest.mark.parametrize("M,G,K", [(1, 32, 256), (16, 32, 256), (64, 32, 256), (16, 64, 256),
                                   (8, 32, 160)])  # 8 does not divide ng * slab = 20
def test_dequant_plain_matches_pallas_dequant_kernel(rng, interpret, M, G, K):
    """K9's plain version against ``_make_kernel_dequant`` itself (interpret
    mode) at the JAX tests' cases (tests/test_quantized_matmul.py:138) and
    one shape the TPU kernel leaves to its jnp route. Tolerance 2e-2 x
    max|ref|: interpret mode dots in f32 weights (:548-550), the plain
    version in bf16 weights."""
    xj, qwj, sj, zsj, xt, qwt, st, zst = _case(rng, M, K, 128, G)
    ref = f32(_quantized_matmul_2d(xj, qwj, sj, zsj, group_size=G))
    out = tqm.quantized_matmul_dequant_plain(xt, qwt, st, zst, G)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert np.abs(f32(out) - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("M,G,prologue", [(1, 32, None), (4, 64, "norm"), (8, 32, "glu"),
                                          (33, 64, None), (12, 32, "norm")])
def test_small_group_cpu_path_matches_jax_jnp(rng, M, G, prologue):
    """The port's CPU quantized_matmul at G = 32 / 64 (the output-side plain
    form, prologues applied first) against the JAX package's default CPU
    (jnp) route."""
    K, N = 512, 384
    xj, qwj, sj, zsj, xt, qwt, st, zst = _case(rng, M, K, N, G)
    kj, kt = {}, {}
    if prologue == "norm":
        w = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kj["fuse_norm"] = (jnp.asarray(w, jnp.bfloat16), 1e-5)
        kt["fuse_norm"] = (torch.from_numpy(np.asarray(kj["fuse_norm"][0], np.float32))
                           .to(torch.bfloat16), 1e-5)
    elif prologue == "glu":
        g = (rng.standard_normal((M, 2 * K)) * 0.5).astype(np.float32)
        xj = jnp.asarray(g, jnp.bfloat16)
        xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
        kj["fuse_glu"] = kt["fuse_glu"] = True
    ref = jax_qmm(xj, qwj, sj, zsj, group_size=G, **kj)
    out = tqm.quantized_matmul(xt, qwt, st, zst, group_size=G, **kt)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


# --------------------------------------------------------- K8 at small G


@pytest.mark.parametrize("G", [32, 64])
@pytest.mark.parametrize("bm", [16, 32])
def test_grouped_plain_small_group_matches_fallback(G, bm):
    """K8's plain version at G = 32 / 64 against ``_grouped_fallback`` (the
    JAX package's route for small-group experts): live tiles within one
    bf16 step, dead tiles zero."""
    rng = np.random.default_rng(3)
    E, K, N = 4, 256, 256
    qw = rng.integers(-2**31, 2**31, (E, K // 8, N), dtype=np.int64).astype(np.int32)
    s = ((rng.uniform(size=(E, K // G, N)) * 0.004 + 0.001) / 16).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // G, N)) * 15) * s).astype(np.float32)
    te = np.asarray([0, 0, 2, 3, 3, 3], np.int32)
    live = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
    xj = jnp.asarray(rng.standard_normal((len(te) * bm, K)).astype(np.float32), jnp.bfloat16)
    want = jgm._grouped_fallback(xj, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs),
                                 jnp.asarray(te), jnp.asarray(live), bm, G, jnp.bfloat16)
    got = tgm.quantized_matmul_grouped(
        torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16), torch.from_numpy(qw),
        torch.from_numpy(s), torch.from_numpy(zs), torch.from_numpy(te), torch.from_numpy(live),
        bm, group_size=G)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-2, rtol=1e-2)
    assert not f32(got)[5 * bm:].any()


# ---------------------------------------------------------- tiny models

MODELS = {
    "llama_g32": (dict(TINY), 32),
    # qwen2_moe as tests/test_torch_moe.py builds it, experts and shared
    # expert at g=64
    "qwen2_moe_g64": (dict(TINY, num_key_value_heads=4, num_local_experts=8,
                           num_experts_per_tok=4, moe_intermediate_size=128,
                           shared_intermediate_size=256, model_type="qwen2_moe",
                           moe_router="softmax_all", moe_freq_shifted=True, attention_bias=True,
                           shared_expert_gate=True, n_shared_experts=1, norm_topk_prob=False), 64),
}
#: least gap between the k-th and (k+1)-th router logit of a routed token,
#: as tests/test_torch_moe.py asserts it
GAP = 1e-4


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("name", list(MODELS))
def test_small_group_model_generates_jax_tokens(monkeypatch, name):
    """A tiny model with random QTPU weights at G = 32 (llama) or 64
    (qwen2_moe), built by the port and carried over to quick_tpu by name:
    prefill logits within the model tests' tolerance and the same greedy
    tokens (a row may part only at a bf16 tie of the reference's logits);
    every MoE token routed with a router gap above GAP."""
    kw, G = MODELS[name]
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    tparams = t_init_quant(tcfg, seed=0, group_size=G, device="cpu")
    assert tparams.blocks[0].attn.qkv_proj.group_size == G
    flat = {k: _numpy(v) for k, v in params_to_flat(tparams).items()}
    jparams = jck.flat_to_params(flat, jcfg, group_size=G)
    gaps = []
    orig = tblocks.moe_forward

    def recorded(p, cfg, x, token_mask=None):
        v = torch.sort(p.router(x.to(torch.float32)), dim=-1, descending=True).values
        k = cfg.num_experts_per_tok
        gaps.append(float((v[..., k - 1] - v[..., k]).min()))
        return orig(p, cfg, x, token_mask)

    monkeypatch.setattr(tblocks, "moe_forward", recorded)
    toks = np.random.default_rng(3).integers(0, TINY["vocab_size"], (2, 8)).astype(np.int32)
    from quick_tpu_torch.models.model import model_forward

    tl, _ = model_forward(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(f32(tl), f32(jax_forward(jparams, jcfg, jnp.asarray(toks))[0]),
                               atol=3e-2, rtol=3e-2)  # as tests/test_torch_model.py
    ref = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(toks), 6, max_seq=16))
    out = generate(tparams, tcfg, torch.from_numpy(toks), 6, max_seq=16)
    ref_logits = jax_forward(jparams, jcfg, jnp.asarray(ref[:, :-1]))[0]
    assert assert_greedy_match(out.numpy(), ref, ref_logits, 8) >= 6
    if tcfg.is_moe:
        assert gaps and min(gaps) > GAP, gaps


# ---------------------------------------------------------- SamplingParams


PENALTIES = [dict(repetition_penalty=1.1), dict(frequency_penalty=0.5),
             dict(presence_penalty=0.3)]


@pytest.mark.parametrize("kw", PENALTIES)
def test_penalty_fields_construct_and_every_entry_point_refuses_them(kw):
    """The JAX package's three penalty fields construct (no TypeError), carry
    the same defaults and ``has_penalties``; generate() and decode_loop()
    apply them (tests/test_torch_penalties.py holds their values). The
    Engine and Engine.submit raise the JAX Engine's ValueError naming
    ``enable_penalties`` without it, and with it serve the request
    (tests/test_torch_engine_penalties.py holds the streams)."""
    sp = SamplingParams(**kw)
    assert sp.has_penalties == JaxSamplingParams(**kw).has_penalties is True
    assert SamplingParams()._asdict() == JaxSamplingParams()._asdict()
    assert not SamplingParams(temperature=0.7, top_k=5).has_penalties
    cfg = ModelConfig(**TINY)
    params = t_init_quant(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    assert tuple(generate(params, cfg, toks, 2, sampling=sp).shape) == (1, 6)
    cache = make_cache(cfg, 1, 8, device="cpu")
    assert tuple(decode_loop(params, cfg, toks[:, 0], cache, 2, sp)[0].shape) == (1, 2)
    with pytest.raises(ValueError, match="enable_penalties"):
        Engine(params, cfg, max_slots=2, max_seq=16, page_size=16, sampling=sp, device="cpu")
    eng = Engine(params, cfg, max_slots=2, max_seq=16, page_size=16, chunk=4, device="cpu")
    with pytest.raises(ValueError, match="enable_penalties"):
        eng.submit([1, 2, 3], 2, sampling=sp)
    uid = eng.submit([1, 2, 3], 2, sampling=SamplingParams())
    assert len(eng.run()[uid]) == 2
    eng = Engine(params, cfg, max_slots=2, max_seq=16, page_size=16, chunk=4,
                 enable_penalties=True, device="cpu")
    uid = eng.submit([1, 2, 3], 2, sampling=sp)
    assert len(eng.run()[uid]) == 2
