"""Port parity for the paged KV cache: PagedKVCache.update against the JAX
cache with its Pallas page-write kernels (interpret mode), the page-write
ops' addressing, select / merge, the dense layer gather, PageAllocator and
the prefix cache's page hashes. Pages are compared outside page 0, the
trash page, which takes colliding junk writes in both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu.modules.paged_cache import PageAllocator as JAlloc, PagedKVCache as JCache
from quick_tpu.ops.paged_write import paged_write_chunk as jchunk
from quick_tpu.runtime.prefix_cache import PrefixCache as JPrefix, page_hashes as jhashes
from quick_tpu_torch.modules.paged_cache import TRASH_PAGE, PageAllocator, PagedKVCache
from quick_tpu_torch.ops.paged_write import paged_write_chunk
from quick_tpu_torch.runtime.prefix_cache import PrefixCache, page_hashes

L, P, PAGE, H, D = 2, 9, 16, 2, 8
BT = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # max_seq 64

#: (tokens per write, per-slot starts) for each write of a case
UPDATES = {
    "decode": [(1, [0, 9]), (1, [15, 16]), (1, [16, 31])],
    "chunk_inside_page": [(8, [0, 4]), (8, [8, 20])],
    "chunk_crossing_page": [(8, [12, 9]), (6, [29, 45])],
    "past_max_seq": [(1, [63, 64]), (8, [60, 100]), (1, [200, 70])],
}


def _pair(dtype_np):
    jc = JCache.create(L, P, PAGE, max_slots=2, max_seq=64, n_kv=H, head_dim=D,
                       dtype=jnp.dtype(dtype_np))
    jc = dataclasses.replace(jc, block_table=jnp.asarray(BT))
    tc = PagedKVCache.create(L, P, PAGE, 2, 64, H, D, getattr(torch, dtype_np), device="cpu")
    tc.block_table.copy_(torch.from_numpy(BT))
    return jc, tc


@pytest.mark.parametrize("case", list(UPDATES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_jax_write_kernels(rng, monkeypatch, case, dtype):
    """The port's update (on the CPU: the scatter) leaves the pages exactly
    as the JAX update through its Pallas decode / chunk write kernels."""
    monkeypatch.setenv("QUICK_TPU_PAGED_WRITE", "1")
    jc, tc = _pair(dtype)
    for S, starts in UPDATES[case]:
        k = rng.standard_normal((2, S, H, D)).astype(np.float32)
        v = rng.standard_normal((2, S, H, D)).astype(np.float32)
        jc = jc.update(1, jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts, jnp.int32))
        tc = tc.update(1, torch.from_numpy(k), torch.from_numpy(v),
                       torch.tensor(starts, dtype=torch.int32))
    for a, b in ((tc.k_pages, jc.k_pages), (tc.v_pages, jc.v_pages)):
        np.testing.assert_array_equal(f32(a)[:, 1:], f32(b)[:, 1:])
    # the dense gather reads the same context (trash rows included)
    for i in range(L):
        for a, b in zip(tc.layer(i), jc.layer(i)):
            np.testing.assert_array_equal(f32(a)[f32(a) != 0], f32(b)[f32(a) != 0])


@pytest.mark.parametrize("offs,valid", [([3, 12, 0], [8, 8, 8]), ([14, 9, 6], [2, 8, 5])])
def test_chunk_write_addressing_matches_pallas(rng, offs, valid):
    """paged_write_chunk's plain version takes the Pallas chunk kernel's
    span pages, in-page offsets and valid counts (interpret mode)."""
    pages = rng.standard_normal((L, P, H, PAGE, D)).astype(np.float32)
    k = rng.standard_normal((3, 8, H, D)).astype(np.float32)
    v = rng.standard_normal((3, 8, H, D)).astype(np.float32)
    pg = np.asarray([[1, 2], [3, 4], [5, 0]], np.int32)
    jk, jv = jchunk(jnp.asarray(pages), jnp.asarray(pages), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(pg), jnp.asarray(offs, jnp.int32),
                    jnp.asarray(valid, jnp.int32), 1, interpret=True)
    tk, tv = torch.from_numpy(pages.copy()), torch.from_numpy(pages.copy())
    paged_write_chunk(tk, tv, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pg),
                      torch.tensor(offs), torch.tensor(valid), 1)
    np.testing.assert_array_equal(f32(tk)[:, 1:], f32(jk)[:, 1:])
    np.testing.assert_array_equal(f32(tv)[:, 1:], f32(jv)[:, 1:])


def test_select_and_merge_match_jax():
    jc, tc = _pair("float32")
    lengths = np.asarray([17, 40], np.int32)
    jc = jc.with_length(jnp.asarray(lengths))
    tc = tc.with_length(torch.from_numpy(lengths))
    ids = np.asarray([1, 0], np.int32)
    row_valid = np.asarray([True, False])
    jsub = jc.select(jnp.asarray(ids), jnp.asarray(row_valid))
    tsub = tc.select(torch.from_numpy(ids), torch.from_numpy(row_valid))
    np.testing.assert_array_equal(tsub.block_table.numpy(), np.asarray(jsub.block_table))
    np.testing.assert_array_equal(tsub.length.numpy(), np.asarray(jsub.length))
    assert tsub.k_pages is tc.k_pages  # a view over the same pool
    grown = np.asarray([48, 9], np.int32)  # the padding row's length is ignored
    jm = jc.merge(jsub.with_length(jnp.asarray(grown)), jnp.asarray(ids), jnp.asarray(row_valid))
    tm = tc.merge(tsub.with_length(torch.from_numpy(grown)), torch.from_numpy(ids),
                  torch.from_numpy(row_valid))
    np.testing.assert_array_equal(tm.length.numpy(), np.asarray(jm.length))
    assert tm.length.dtype == torch.int32 and tm.length.tolist() == [17, 48]


def test_page_allocator_matches_jax():
    ja, ta = JAlloc(12), PageAllocator(12)
    for op, n in [("alloc", 3), ("alloc", 5), ("release", [2, 7]), ("alloc", 4),
                  ("alloc", 9), ("release", [1]), ("alloc", 1)]:
        if op == "alloc":
            assert ta.alloc(n) == ja.alloc(n)
        else:
            ta.release(n)
            ja.release(n)
        assert ta.n_free == ja.n_free
    with pytest.raises(ValueError, match="trash"):
        ta.release([TRASH_PAGE])
    with pytest.raises(ValueError):
        PageAllocator(1)


def test_page_hashes_and_prefix_cache_match_jax(rng):
    base = [int(t) for t in rng.integers(0, 32000, 40)]
    prompts = [base, base[:33], base[:20] + [1, 2, 3] * 5, [int(t) for t in rng.integers(0, 9, 17)]]
    for p in prompts:
        assert page_hashes(p, 8) == jhashes(p, 8)  # byte-equal SHA-256 chains
    jp, tp = JPrefix(JAlloc(10)), PrefixCache(PageAllocator(10))
    log = []
    for pc in (jp, tp):
        trace = []
        for p in prompts:
            hs = page_hashes(p, 8)
            got = pc.match(hs)
            fresh = pc.alloc(len(hs) + 1 - len(got))
            trace.append((got, fresh))
            if fresh is None:
                pc.release(got)
                continue
            pages = got + fresh
            for h, pg in zip(hs[len(got):], pages[len(got):]):
                pc.register(h, pg)
            pc.release(pages)
        trace.append((pc.hits, pc.misses, sorted(pc.lru), pc.n_reusable))
        log.append(trace)
    assert log[0] == log[1]
