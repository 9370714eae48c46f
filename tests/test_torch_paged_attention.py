"""Port parity for paged attention: the plain versions of K5 (decode) and
K6 (chunk) against the JAX Pallas kernels in interpret mode, in f32 (atol
as tests/test_paged_attention.py), with ragged lengths, GQA / MQA, a
sliding window, a softcap and ALiBi; the chunk gate; and the paged branch
of the model forward (advance / last_valid) against the JAX model.
(K5 and K6 themselves are held against these plain versions on a card in
test_torch_kernels.py.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params, model_forward as jax_forward
from quick_tpu.modules.paged_cache import PagedKVCache as JCache
from quick_tpu.ops.alibi import alibi_slopes
from quick_tpu.ops.paged_attention import (
    paged_chunk_attention as jax_chunk,
    paged_decode_attention as jax_decode,
    supports_chunk as jax_supports_chunk,
)
from quick_tpu.utils.checkpoint import params_to_flat
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_decode_attention,
    supports_chunk,
)
from quick_tpu_torch.ops.paged_write import quantize_kv

ATOL = 2e-3  # tests/test_paged_attention.py: f32, online vs one-pass softmax

CASES = {
    "mha_ragged": dict(Hq=4, Hkv=4, D=64, page=8, lengths=[13, 27]),
    "gqa_page_aligned": dict(Hq=8, Hkv=2, D=64, page=8, lengths=[32, 5]),
    "mqa_single_token": dict(Hq=4, Hkv=1, D=32, page=4, lengths=[1, 9]),
    "window": dict(Hq=4, Hkv=2, D=32, page=8, lengths=[13, 30], window=12),
    "softcap": dict(Hq=4, Hkv=2, D=32, page=8, lengths=[19, 23], logit_softcap=30.0),
    "window_softcap": dict(Hq=4, Hkv=2, D=32, page=8, lengths=[19, 31], window=8,
                           logit_softcap=30.0),
    "alibi": dict(Hq=4, Hkv=2, D=32, page=8, lengths=[19, 6], alibi=True),
}
N_PT = 4


def _inputs(rng, case, S=None):
    c = dict(CASES[case])
    B, Hq, Hkv, D, page = 2, c.pop("Hq"), c.pop("Hkv"), c.pop("D"), c.pop("page")
    n_pages = 1 + B * N_PT
    pages = [rng.standard_normal((2, n_pages, Hkv, page, D)).astype(np.float32) for _ in range(2)]
    bt = rng.permutation(np.arange(1, n_pages))[: B * N_PT].reshape(B, N_PT).astype(np.int32)
    q = rng.standard_normal((B, Hq, D) if S is None else (B, S, Hq, D)).astype(np.float32)
    per_slot = np.asarray(c.pop("lengths"), np.int32)
    if c.pop("alibi", False):
        c["alibi_slopes"] = alibi_slopes(Hq)
    return (q, *pages, bt, per_slot), c


def _both(fn_jax, fn_torch, args, kw):
    ref = fn_jax(*(jnp.asarray(a) for a in args), layer=1, interpret=True,
                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    out = fn_torch(*(torch.from_numpy(a) for a in args), layer=1,
                   **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                      for k, v in kw.items()})
    return f32(out), f32(ref)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_plain_matches_pallas_interpret(rng, case):
    args, kw = _inputs(rng, case)
    out, ref = _both(jax_decode, paged_decode_attention, args, kw)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_plain_matches_pallas_interpret(rng, case):
    """Chunk queries at starts + i; chunks cross page boundaries, and one
    (start 32 of a 32-token table) runs past the table's edge."""
    args, kw = _inputs(rng, case, S=4)
    out, ref = _both(jax_chunk, paged_chunk_attention, args, kw)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_single_layer_pages_and_int8_refused(rng):
    """One layer's pages ([P, Hkv, page, D], float or INT8 with one layer's
    [P, 8, Hkv*page] scale tiles) as the JAX kernel takes them; an INT8
    scale tile of the wrong shape is refused."""
    (q, kp, vp, bt, ln), _ = _inputs(rng, "gqa_page_aligned")
    t = [torch.from_numpy(a) for a in (q, kp[1], vp[1], bt, ln)]
    ref = jax_decode(*(jnp.asarray(a) for a in (q, kp[1], vp[1], bt, ln)), interpret=True)
    np.testing.assert_allclose(f32(paged_decode_attention(*t)), f32(ref), atol=ATOL)
    (kc, ks), (vc, vs) = quantize_kv(t[1]), quantize_kv(t[2])
    P = kc.shape[0]
    tiles = torch.stack([ks.reshape(P, -1), vs.reshape(P, -1)], 1)
    tiles = torch.cat([tiles, torch.zeros((P, 6, tiles.shape[-1]))], 1)
    ref = jax_decode(*(jnp.asarray(a.numpy()) for a in (t[0], kc, vc, t[3], t[4])),
                     kv_scales=jnp.asarray(tiles.numpy()), interpret=True)
    np.testing.assert_allclose(f32(paged_decode_attention(t[0], kc, vc, *t[3:], kv_scales=tiles)),
                               f32(ref), atol=ATOL)
    with pytest.raises(ValueError, match="kv_scales"):
        paged_decode_attention(t[0], kc, vc, *t[3:], kv_scales=torch.zeros(1))


@pytest.mark.parametrize("S,Hq,Hkv,page", [(16, 32, 8, 64), (64, 32, 8, 64), (8, 4, 2, 16),
                                           (1, 4, 4, 8), (128, 32, 8, 16), (32, 64, 8, 128)])
def test_chunk_gate_is_the_jax_rule(S, Hq, Hkv, page):
    assert supports_chunk(S, Hq, Hkv, page) == jax_supports_chunk(S, Hq, Hkv, page)


TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


def test_paged_model_forward_matches_jax(rng):
    """model_forward over a PagedKVCache with per-slot starts: one ragged
    chunk (advance / last_valid) then decode steps, against the JAX model
    on its paged cache (XLA gather path, as on the CPU)."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_flat(params_to_flat(jparams), tcfg, device="cpu")
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    jc = JCache.create(2, 9, 8, 3, 32, 2, 32, jnp.bfloat16)
    jc = dataclasses.replace(jc, block_table=jnp.asarray(bt), length=jnp.asarray([0, 5, 0], jnp.int32))
    tc = PagedKVCache.create(2, 9, 8, 3, 32, 2, 32, device="cpu")
    tc.block_table.copy_(torch.from_numpy(bt))
    tc = tc.with_length(torch.tensor([0, 5, 0]))
    toks = rng.integers(0, 512, (3, 6)).astype(np.int32)
    valid = np.asarray([6, 4, 0], np.int32)  # a padding row of length 0
    kw_j = dict(advance=jnp.asarray(valid), last_valid=jnp.asarray(valid))
    kw_t = dict(advance=torch.from_numpy(valid), last_valid=torch.from_numpy(valid))
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks), jc, **kw_j)
    tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks).long(), tc, **kw_t)
    tol = dict(atol=3e-2, rtol=3e-2)  # as tests/test_torch_model.py
    assert tl.shape == (3, 1, 512)
    np.testing.assert_allclose(f32(tl)[:2], f32(jl)[:2], **tol)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        one = np.asarray([1, 1, 0], np.int32)
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(nxt), jc, advance=jnp.asarray(one),
                             last_valid=jnp.asarray(one))
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(nxt).long(), tc,
                               advance=torch.from_numpy(one), last_valid=torch.from_numpy(one))
        np.testing.assert_allclose(f32(tl)[:2], f32(jl)[:2], **tol)
    np.testing.assert_array_equal(tc.length.numpy(), [9, 12, 0])
    np.testing.assert_allclose(f32(tc.k_pages)[:, 1:], f32(jc.k_pages)[:, 1:], **tol)
