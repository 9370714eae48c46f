"""K10q's key split on the CPU: the split plan (``split_plan``) gives every
token of a slot to exactly one split, and the plain model of the kernel's
arithmetic (``mla_paged_decode_attention_split_plain``: 64-token tiles, p
rounded against each split's running max, the splits merged in split
order) against the Pallas MLA paged decode kernel in interpret mode, over
INT8 and bf16 latent pages, with empty and full slots and several splits.
(K10q itself is held against its plain version on a card in
test_torch_kernels.py and chip_smoke.py's phase 11a.)"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.mla_paged_attention as tmla
from quick_tpu.modules.paged_cache import PagedKVCache as JCache
from quick_tpu.ops.mla_paged_attention import mla_paged_decode_attention as jax_mla_paged

H100_SMS = 132
#: test_torch_mla.py's tolerances for the plain version against Pallas:
#: INT8 pages (codes, scales folded into scores and p, p in bf16); bf16
#: pages and queries within one bf16 step and p's rounding
TOL = {"int8": dict(rtol=2e-2, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("B,n_pt,page", [(16, 16, 64), (1, 16, 64), (4, 6, 16), (64, 4, 64)])
def test_mla_split_plan_covers_every_token_once(B, n_pt, page):
    """K10q's plan: whole 64-token tiles, at most the kernel's 1,024 tokens
    a split, enough splits to cover the table and no empty one past it; at
    every length each token lies in exactly one of the splits the kernel
    counts as live ((length - 1) // chunk + 1 of them)."""
    splits, chunk = tmla.split_plan(B, n_pt, page, H100_SMS)
    T = n_pt * page
    assert chunk % tmla.TILE == 0 and splits * chunk >= T and (splits - 1) * chunk < T
    assert chunk <= tmla.MAX_CHUNK
    for length in range(T + 1):
        live = (length - 1) // chunk + 1 if length else 0
        seen = np.zeros(T, np.int64)
        for sp in range(live):
            seen[sp * chunk:min(length, sp * chunk + chunk)] += 1
        assert (seen[:length] == 1).all() and not seen[length:].any()


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("chunk", [64, 128, 1024])
@pytest.mark.parametrize("pages", ["int8", "bfloat16"])
def test_mla_split_model_matches_pallas_interpret(pages, chunk):
    """The split-and-merge arithmetic against the Pallas MLA kernel
    (interpret mode) on the same latent pages written by the JAX cache: 16
    heads, lengths 0 (zeros), 1, mid-table and the full table, at 16, 8 and
    1 splits of a 1,024-token table (pages of 64)."""
    B, HQ, R, DR, page, n_pt = 4, 16, 64, 16, 64, 16
    T = page * n_pt
    rng = np.random.default_rng(17)
    jdt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}[pages]
    P = 1 + B * n_pt
    cache = JCache.create(1, P, page, max_slots=B, max_seq=T, n_kv=1, head_dim=DR, dtype=jdt,
                          v_head_dim=R)
    bt = rng.permutation(np.arange(1, P)).reshape(B, n_pt).astype(np.int32)
    cache = dataclasses.replace(cache, block_table=jnp.asarray(bt))
    qdt = jnp.bfloat16 if pages == "bfloat16" else jnp.float32
    kpe = rng.standard_normal((B, T, 1, DR)).astype(np.float32)
    c = rng.standard_normal((B, T, 1, R)).astype(np.float32)
    cache = cache.update(0, jnp.asarray(kpe, qdt), jnp.asarray(c, qdt), jnp.zeros((B,), jnp.int32))
    q_c = rng.standard_normal((B, HQ, R)).astype(np.float32)
    q_pe = rng.standard_normal((B, HQ, DR)).astype(np.float32)
    lengths = np.asarray([0, 1, 449, T], np.int32)
    scale = (R + DR) ** -0.5
    quant = pages == "int8"
    want = jax_mla_paged(jnp.asarray(q_c, qdt), jnp.asarray(q_pe, qdt), cache.k_pages,
                         cache.v_pages, jnp.asarray(bt), jnp.asarray(lengths), layer=0,
                         scale=scale, kv_scales=cache.kv_scales if quant else None,
                         interpret=True)
    tq = torch.bfloat16 if pages == "bfloat16" else torch.float32
    got = tmla.mla_paged_decode_attention_split_plain(
        torch.from_numpy(q_c).to(tq), torch.from_numpy(q_pe).to(tq), _torch(cache.k_pages),
        _torch(cache.v_pages), torch.from_numpy(bt), torch.from_numpy(lengths), 0, scale,
        _torch(cache.kv_scales) if quant else None, chunk=chunk, splits=-(-T // chunk))
    assert got.shape == (B, HQ, R) and got.dtype == tq
    np.testing.assert_allclose(f32(got), f32(want), **TOL[pages])
    assert not f32(got)[0].any()
