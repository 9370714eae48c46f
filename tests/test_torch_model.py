"""Port parity for the whole slice: a tiny quantized llama built by
quick_tpu (init_quant_params), carried over by name (params_to_flat ->
params_from_flat), must give the same prefill and decode logits and the
same greedy tokens in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params, model_forward as jax_forward
from quick_tpu.runtime import generate as jax_generate, make_cache as jax_cache
from quick_tpu.utils.checkpoint import params_to_flat
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat as t_to_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.runtime import generate, make_cache

TINY = dict(
    vocab_size=512, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=64,
)
TOL = dict(atol=3e-2, rtol=3e-2)  # as tests/test_model.py


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_flat(params_to_flat(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)


def test_flat_round_trip(pair):
    _, jparams, _, tparams = pair
    jflat = params_to_flat(jparams)
    tflat = t_to_flat(tparams)
    assert set(tflat) == set(jflat)
    for name, arr in jflat.items():
        np.testing.assert_array_equal(f32(tflat[name]), np.asarray(arr, np.float32), err_msg=name)


def test_prefill_and_decode_logits_match(pair):
    jcfg, jparams, tcfg, tparams = pair
    B, S, steps = 2, 12, 4
    toks = _tokens(B, S + steps)
    jc = jax_cache(jcfg, B, 32)
    tc = make_cache(tcfg, B, 32, device="cpu")
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks[:, :S]), jc)
    tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks[:, :S]).long(), tc)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for t in range(S, S + steps):
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert tc.length == int(jc.length) == S + steps
    np.testing.assert_allclose(f32(tc.k), f32(jc.k), **TOL)


def test_greedy_generate_token_identical(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(2, 8, seed=3)
    ref = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(toks), 6, max_seq=16))
    out = generate(tparams, tcfg, torch.from_numpy(toks), 6, max_seq=16)
    np.testing.assert_array_equal(out.numpy(), ref)


VARIANTS = {
    # mistral: every layer slides; the window binds in the 32-slot cache
    "window_binds": dict(sliding_window=8, model_type="mistral"),
    # a window on every other layer and an attention-logit softcap
    "window_pattern_softcap": dict(
        sliding_window=8, sliding_window_pattern=2, attn_logit_softcap=20.0,
    ),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_window_and_softcap_match(variant):
    """The sliding window and the attention softcap take the same numerics
    in both packages, at prefill and at decode."""
    kw = dict(TINY, **VARIANTS[variant])
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_flat(params_to_flat(jparams), tcfg, device="cpu")
    B, S, steps = 2, 10, 3
    toks = _tokens(B, S + steps, seed=5)
    jc, tc = jax_cache(jcfg, B, 32), make_cache(tcfg, B, 32, device="cpu")
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + steps)]:
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


@pytest.mark.parametrize("switch", [
    dict(use_alibi=True, use_rope=False), dict(learned_pos=True),
    dict(embed_norm=True), dict(parallel_residual=True),
    dict(layernorm="layernorm"), dict(gated_mlp=False, act_fn="gelu"),
    dict(qkv_clip=8.0), dict(num_local_experts=4, moe_router="expert_choice"),
])
def test_other_families_are_refused(switch):
    """Configs off the RMSNorm families' path raise instead of running a
    path the port has not taken over yet (the LayerNorm families' switches:
    the RMSNorm families' run, tests/test_torch_gemma.py and
    tests/test_torch_olmo2_granite.py)."""
    from quick_tpu_torch.models.model import init_quant_params as t_init

    cfg = ModelConfig(**dict(TINY, **switch))
    with pytest.raises(NotImplementedError, match="not ported"):
        t_init(cfg, device="cpu")


def test_forward_without_cache_matches(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(2, 9, seed=7)
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(toks))
    tl, _ = model_forward(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


@pytest.mark.parametrize(
    "params", [dict(temperature=0.7, top_k=5), dict(temperature=1.3, top_p=0.8),
               dict(temperature=1.0, min_p=0.1)],
)
def test_filter_logits_match(params):
    from quick_tpu.runtime.generate import SamplingParams as JSP, filter_logits as jfilter
    from quick_tpu_torch.runtime import SamplingParams, filter_logits

    logits = np.random.default_rng(4).standard_normal((3, 50)).astype(np.float32) * 3
    ref = jfilter(jnp.asarray(logits), JSP(**params))
    out = filter_logits(torch.from_numpy(logits), SamplingParams(**params))
    np.testing.assert_allclose(f32(out), f32(ref), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("B,Smax,Hkv,D", [(4, 256, 8, 128), (8, 1536, 8, 128),
                                          (8, 1600, 8, 128), (9, 256, 8, 128),
                                          (4, 4096, 8, 128), (64, 4096, 8, 128)])
def test_decode_gates_match_the_accelerator_branch(monkeypatch, B, Smax, Hkv, D):
    """On the card the port takes the branch the JAX package takes on the
    TPU: the fused decode step gate (forced to its TPU decision with
    QUICK_TPU_FUSED_STEP=1) and the dense-decode kernel's shape support."""
    import types

    from quick_tpu.modules import blocks as jblocks
    from quick_tpu.ops import decode_attention as jdda
    from quick_tpu_torch.modules import blocks as tblocks

    monkeypatch.setenv("QUICK_TPU_FUSED_STEP", "1")
    shape = (1, B, Hkv, Smax, D)
    jcache = types.SimpleNamespace(k=jax.ShapeDtypeStruct(shape, jnp.bfloat16))
    tcache = types.SimpleNamespace(k=torch.empty(shape, dtype=torch.bfloat16, device="meta"))
    cos = np.zeros((64, D // 2), np.float32)
    cuda = torch.device("cuda")
    assert tblocks._use_fused_decode_step(tcache, B, D, torch.from_numpy(cos), cuda) == \
        jblocks._use_fused_decode_step(jcache, B, D, jnp.asarray(cos))
    assert not tblocks._use_fused_decode_step(
        tcache, B, D, torch.from_numpy(cos), torch.device("cpu"))
    from quick_tpu_torch.ops import decode_attention as tdda

    assert tdda.supports(B, 4 * Hkv, Hkv, Smax, D) == jdda.supports(B, 4 * Hkv, Hkv, Smax, D)
    assert tdda._pick_tiles(B, Hkv, Smax, D) == jdda._pick_tiles(B, Hkv, Smax, D)


@pytest.mark.parametrize("where", ["decode_loop", "update_at_length_dev"])
def test_dense_cache_refuses_overrun(pair, where):
    """A one-token step writes at the cache's device length, which no kernel
    can check, and a replayed step cannot raise: the host length is checked
    before any write (``KVCache.check_room``), in the decode loop for all
    of its steps at once."""
    from quick_tpu_torch.runtime import decode_loop, prefill

    _, _, tcfg, tparams = pair
    cache = make_cache(tcfg, 2, 24, device="cpu")
    logits, cache = prefill(tparams, tcfg, torch.from_numpy(_tokens(2, 16)).long(), cache)
    assert int(cache.length_dev) == cache.length == 16
    if where == "decode_loop":
        first = torch.argmax(logits, dim=-1)
        decode_loop(tparams, tcfg, first, cache, 24 - 16)  # fills the cache exactly
        with pytest.raises(ValueError, match="overruns max_seq"):
            decode_loop(tparams, tcfg, first, cache, 24 - 16 + 1)
    else:
        full = cache.with_length(24)
        kv = torch.zeros((2, 1, tcfg.num_key_value_heads, tcfg.head_dim), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="overruns max_seq"):
            full.update(0, kv, kv, full.length_dev)
