"""Port parity for beam search: the port's ``beam_generate`` against
``quick_tpu.runtime.beam_generate`` on tiny llama, Mixtral-style MoE and
DeepSeek-V2 (MLA) models with random QTPU weights carried across by name,
at 2 and 4 beams, length penalties 0.6, 1.0 and 2.0, with and without an
EOS token (one that the search emits, so frozen beams are exercised):
tokens equal, scores within 2e-3 x (1 + |s|). Also the cache's
``take_rows`` against JAX's ``take(src, axis=1)``, the ranking's tie order
against ``lax.top_k``'s, and a model whose logits all tie (every
candidate's score equal) token-equal to the JAX search."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu.utils.checkpoint as jck
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.runtime import beam_generate as jax_beam
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant
from quick_tpu_torch.modules.blocks import top_k
from quick_tpu_torch.runtime import beam_generate, make_cache

LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
MODELS = {
    "llama": (LLAMA, 128),
    "mixtral": (dict(LLAMA, num_local_experts=4, num_experts_per_tok=2, model_type="mixtral"),
                128),
    "deepseek_v2": (dict(LLAMA, num_key_value_heads=4, kv_lora_rank=64, qk_nope_head_dim=32,
                         qk_rope_head_dim=16, v_head_dim=32, head_dim=48, rotary_dim=16,
                         num_local_experts=8, num_experts_per_tok=2, moe_router="deepseek",
                         moe_intermediate_size=64, first_k_dense_replace=1,
                         model_type="deepseek_v2", n_shared_experts=2, norm_topk_prob=False),
                    64),
}
#: (model, num_beams, length_penalty, eos): every model with and without
#: EOS, both beam counts and all three penalties spread over them
CASES = [("llama", 4, 1.0, False), ("llama", 2, 0.6, True), ("llama", 4, 2.0, True),
         ("mixtral", 4, 0.6, False), ("mixtral", 2, 1.0, True),
         ("deepseek_v2", 2, 2.0, False), ("deepseek_v2", 4, 1.0, True)]
B, S, NEW = 2, 8, 6


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def models():
    """Each tiny model with random QTPU weights (seed 0) built by the port
    and carried over to quick_tpu with flat_to_params."""
    out = {}
    for name, (kw, G) in MODELS.items():
        jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
        tparams = t_init_quant(tcfg, seed=0, group_size=G, device="cpu")
        flat = {k: _numpy(v) for k, v in params_to_flat(tparams).items()}
        out[name] = (jcfg, jck.flat_to_params(flat, jcfg, group_size=G), tcfg, tparams)
    return out


def _prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, vocab, (B, S)).astype(np.int32)


def _compare(got, ref):
    (tok, sc), (jtok, jsc) = got, ref
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    jsc = np.asarray(jsc, np.float32)
    assert np.all(np.abs(sc.numpy() - jsc) <= 2e-3 * (1 + np.abs(jsc))), (sc, jsc)


@pytest.mark.parametrize("name,nb,lp,eos", CASES)
def test_beam_generate_matches_jax(models, name, nb, lp, eos):
    jcfg, jparams, tcfg, tparams = models[name]
    prompts = _prompts(tcfg.vocab_size)
    eos_id = None
    if eos:  # a token the search emits: the best beam's third new token
        free = np.asarray(jax_beam(jparams, jcfg, jnp.asarray(prompts), NEW, nb, lp)[0])
        eos_id = int(free[0, S + 2])
    ref = jax_beam(jparams, jcfg, jnp.asarray(prompts), NEW, nb, lp, eos_token_id=eos_id)
    got = beam_generate(tparams, tcfg, torch.from_numpy(prompts), NEW, nb, lp,
                        eos_token_id=eos_id)
    assert tuple(got[0].shape) == (B, S + NEW) and got[0].dtype == torch.int64
    _compare(got, ref)
    if eos:  # the frozen beam keeps emitting EOS
        row = got[0][0, S:].tolist()
        if eos_id in row:
            assert all(t == eos_id for t in row[row.index(eos_id):])


def test_take_rows_matches_jax_take(rng):
    """The dense cache's in-place row gather against ``take(src, axis=1)``,
    a row repeated and a row dropped; the lengths stay."""
    cfg = ModelConfig(**LLAMA)
    cache = make_cache(cfg, 4, 8, device="cpu").with_length(5)
    for t in (cache.k, cache.v):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    want = [np.asarray(jnp.asarray(f32(t)).take(jnp.asarray([2, 2, 0, 3]), axis=1))
            for t in (cache.k, cache.v)]
    out = cache.take_rows(torch.tensor([2, 2, 0, 3]))
    assert out is cache and cache.length == 5 and int(cache.length_dev) == 5
    for t, w in zip((cache.k, cache.v), want):
        np.testing.assert_array_equal(f32(t), w)


def test_top_k_tie_order_matches_lax(rng):
    """Candidates with many exact ties: the port's ranking returns
    ``lax.top_k``'s values and indices (the lower index first)."""
    cand = rng.integers(-3, 3, (3, 4 * 50)).astype(np.float32)
    for k in (2, 4, 7):
        v, i = top_k(torch.from_numpy(cand), k)
        jv, ji = jax.lax.top_k(jnp.asarray(cand), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_beam_generate_all_tied_matches_jax(models):
    """A zero final norm makes every logit 0: every candidate of every step
    ties, and the search must break the ties as the JAX one does."""
    jcfg, jparams, tcfg, tparams = models["llama"]
    tparams.final_norm.zero_()
    try:
        jz = jparams.__class__(**{**jparams.__dict__,
                                  "final_norm": jnp.zeros_like(jparams.final_norm)})
        prompts = _prompts(tcfg.vocab_size)
        ref = jax_beam(jz, jcfg, jnp.asarray(prompts), 4, 4, 1.0, eos_token_id=2)
        got = beam_generate(tparams, tcfg, torch.from_numpy(prompts), 4, 4, 1.0, eos_token_id=2)
        _compare(got, ref)
    finally:
        tparams.final_norm.copy_(torch.from_numpy(np.asarray(jparams.final_norm, np.float32)))
