"""K6's key split on the CPU: the split plan gives every (row, visible key)
pair to exactly one split, for every start of the page table, with and
without a window, inside the tiles its block walks; and the plain model of
the split-and-merge arithmetic (``paged_chunk_attention_split_plain``)
against the Pallas paged chunk kernel in interpret mode. (K6 itself is held
against its plain version in test_torch_kernels.py, on a card.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.decode_attention as tdda
import quick_tpu_torch.ops.paged_attention as tpa
from quick_tpu.ops.alibi import alibi_slopes
from quick_tpu.ops.paged_attention import paged_chunk_attention as jax_chunk

H100_SMS = 132


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("B,S,gq,page,n_pt", [(8, 16, 4, 64, 4), (2, 16, 32, 16, 8),
                                              (1, 24, 2, 16, 6)])
def test_chunk_split_plan_gives_each_pair_to_one_split(B, S, gq, page, n_pt, window):
    """For every start in [0, n_pt * page - S] each (row, visible key) pair
    of the chunk falls in exactly one split's row range, which lies inside
    its row block's walked keys ([lo, hi) of ``chunk_block_range``, from
    whole 64-key tiles inside the split's chunk); the plan is K7's over the
    B x Hkv x row-block blocks, from the shapes alone."""
    Hkv, T = 2, n_pt * page
    chunk, splits = tpa.chunk_split_plan(B, Hkv, S, gq, T, H100_SMS)
    n_rb = -(-S * gq // tpa.CHUNK_ROWS)
    assert (chunk, splits) == tdda.split_plan(B, Hkv * n_rb, T, H100_SMS)
    assert chunk % 64 == 0 and splits * chunk >= T and (splits - 1) * chunk < T
    rows = np.arange(S * gq)
    for start in range(T - S + 1):
        seen = np.zeros((S * gq, T + 1), np.int64)
        for sp in range(splits):
            for rb in range(n_rb):
                r0, r1 = rb * tpa.CHUNK_ROWS, min((rb + 1) * tpa.CHUNK_ROWS, S * gq)
                blo, bhi = tpa.chunk_block_range(sp, chunk, start, (r0, r1), gq, window, T)
                for r in range(r0, r1):
                    lo, hi = tpa.split_range(sp, chunk, start + r // gq + 1, window, T)
                    if lo >= hi:
                        continue
                    assert blo <= lo and hi <= bhi  # inside the block's walk
                    assert sp * chunk <= blo // 64 * 64 and bhi <= (sp + 1) * chunk
                    seen[r, lo:hi] += 1
        qpos = start + rows // gq
        first = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
        want = np.zeros_like(seen)
        for r in rows:
            want[r, first[r]:min(qpos[r] + 1, T)] = 1
        assert np.array_equal(seen, want), start


SPLIT_CASES = {  # (D, gq, kwargs)
    "plain": (64, 4, {}),
    "alibi_softcap_window": (64, 4, dict(alibi=True, logit_softcap=30.0, window=40)),
    "window_d256": (256, 2, dict(window=24)),
    "alibi_gq32": (64, 32, dict(alibi=True)),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_chunk_split_model_matches_pallas_interpret(rng, case):
    """The split-and-merge arithmetic (per-split, per-row partials over
    64-key tiles of the gathered pages, merged row by row in split order)
    against the Pallas paged chunk kernel in interpret mode, in f32, at 2
    splits of 64 keys over 8 pages of 16: starts 0, mid-page, crossing a
    page, a tile less one and ending at the table; within the decode split
    model's tolerance. The gather + einsum route (K6's plain version)
    agrees too."""
    D, gq, kw = SPLIT_CASES[case]
    B, S, Hkv, page, n_pt = 5, 16, 2, 16, 8
    Hq, T = gq * Hkv, n_pt * page
    P = 1 + B * n_pt
    kp, vp = (rng.standard_normal((2, P, Hkv, page, D)).astype(np.float32) for _ in range(2))
    bt = rng.permutation(np.arange(1, P))[: B * n_pt].reshape(B, n_pt).astype(np.int32)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    starts = np.asarray([0, 5, 24, 63, T - S], np.int32)
    kw = dict(kw)
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = alibi_slopes(Hq)
    ref = jax_chunk(*(jnp.asarray(a) for a in (q, kp, vp, bt, starts)), layer=1,
                    interpret=True, **{k: jnp.asarray(v) if k == "alibi_slopes" else v
                                       for k, v in kw.items()})
    chunk, splits = 64, 2
    targs = [torch.from_numpy(a) for a in (q, kp, vp, bt, starts)]
    tkw = {k: torch.from_numpy(v) if k == "alibi_slopes" else v for k, v in kw.items()}
    out = tpa.paged_chunk_attention_split_plain(*targs, 1, D ** -0.5, chunk=chunk,
                                                splits=splits, **tkw)
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-4, rtol=2e-4)
    plain = tpa.paged_chunk_attention_plain(*targs, 1, D ** -0.5, **tkw)
    np.testing.assert_allclose(f32(plain), f32(out), atol=2e-4, rtol=2e-4)
