"""K12's launch on the CPU: K12 runs K8's skeleton, so its tile scan
(``grouped_passes`` over ``grouped_a8_tiles``' layout) must hand every live
row of every expert to exactly one pass of that expert's blocks, and every
dead row to exactly one block to zero, at bm 32, 64, 96 and 128 on the
routings of test_torch_grouped_plan.py; its split plan (``grouped_plan`` at
the skeleton's tile height) covers K once; and the plain model of its
split fold (``quantized_matmul_grouped_a8_split_plain``) agrees with the
JAX package's ``quantized_matmul_grouped(..., a8=True)``, the Pallas
kernel run in interpret mode as its own tests run it. (K12 itself is held
against its plain version in test_torch_kernels.py, on a card.)"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32
from test_torch_grouped_plan import ROUTES

import quick_tpu.ops.grouped_matmul as jgm
import quick_tpu_torch.ops.grouped_matmul as tgm

H100_SMS = 132


@pytest.mark.parametrize("bm", ["own", 96])
@pytest.mark.parametrize("name", list(ROUTES))
def test_every_live_row_in_one_pass_of_its_expert(name, bm):
    """On build_routing's layout at the route's own bm and at bm = 96 (a
    height K8's passes do not take, cut into 32-row sub-tiles): each live
    row of tile i is in exactly one pass of expert tile_expert[i], no pass
    holds more than the skeleton's pass rows, and each dead row is zeroed
    by exactly one expert's blocks."""
    sel, E, own = ROUTES[name]
    bm = own if bm == "own" else bm
    _, _, te, live, _ = tgm.build_routing(sel, E, bm)
    u, te_u, live_u = tgm.grouped_a8_tiles(te, live, bm)
    assert u in tgm.GROUPED_PASS_ROWS and bm % u == 0
    assert u == bm if bm in tgm.GROUPED_PASS_ROWS else u < bm
    plan = tgm.grouped_passes(te_u.tolist(), live_u.tolist(), E, u)
    Mp = te.shape[0] * bm
    row_tile = np.arange(Mp) // bm
    te_n, live_n = te.numpy(), live.numpy()
    seen = np.zeros(Mp, np.int64)
    for e, passes in plan.items():
        if e < 0:
            continue
        for p in passes:
            rows = np.concatenate([np.arange(i * u, (i + 1) * u) for i in p])
            assert len(rows) <= tgm.GROUPED_PASS_ROWS[u]
            assert (te_n[row_tile[rows]] == e).all() and live_n[row_tile[rows]].all()
            seen[rows] += 1
    assert np.array_equal(seen, np.repeat(live_n != 0, bm).astype(np.int64))
    zeroed = np.zeros(Mp, np.int64)
    for e, dead in plan[-1].items():
        for i in dead:
            zeroed[i * u:(i + 1) * u] += 1
    assert np.array_equal(zeroed, np.repeat(live_n == 0, bm).astype(np.int64))
    if name == "decode_duplicates_e8" and bm == 32:
        # expert 0, chosen by three tokens, streamed in two 64-row passes
        assert plan[0] == [[0, 2], [6]]


@pytest.mark.parametrize("E,n_tiles,K,N,bm", [
    (8, 8, 4096, 28672, 32), (8, 8, 14336, 4096, 32),     # Mixtral decode (Mp = 256)
    (8, 16, 4096, 28672, 128), (8, 16, 14336, 4096, 128),  # prefill (Mp = 2048)
    (8, 24, 14336, 4096, 96), (4, 3, 512, 256, 96),        # bm = 96 (QUICK_TPU_MOE_BM)
])
def test_split_plan_covers_k_once(E, n_tiles, K, N, bm):
    """K12's split plan is K8's at the skeleton's tile height (bm's own, or
    the sub-tiles' at bm = 96, whose tiles count three times): the splits'
    stage ranges cover K's stages of 128 once, none empty."""
    te = torch.arange(n_tiles, dtype=torch.int32) % E
    u, te_u, _ = tgm.grouped_a8_tiles(te, torch.ones_like(te), bm)
    splits, cps = tgm.grouped_plan(E, te_u.numel(), K, N, u, H100_SMS)
    assert te_u.numel() == n_tiles * bm // u
    nst = math.ceil(K / 128)
    assert splits * cps >= nst and (splits - 1) * cps < nst
    cover = np.zeros(nst, np.int64)
    for z in range(splits):
        cover[z * cps:min(nst, (z + 1) * cps)] += 1
    assert (cover == 1).all()


def _inputs(bm, seed=3):
    """tests/test_torch_a8.py's grouped inputs at K = 512 (four groups of
    128, so the plan can split K): RTN-like codes and scales."""
    rng = np.random.default_rng(seed)
    E, K, N = 4, 512, 256
    qw = rng.integers(-2**31, 2**31, (E, K // 8, N), dtype=np.int64).astype(np.int32)
    s = ((rng.uniform(size=(E, K // 128, N)) * 0.004 + 0.001) / 16).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // 128, N)) * 15) * s).astype(np.float32)
    te = np.asarray([0, 0, 2, 3, 3, 1], np.int32)
    live = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
    x = rng.standard_normal((len(te) * bm, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    return ((xj, *(jnp.asarray(a) for a in (qw, s, zs, te, live))),
            (xt, *(torch.from_numpy(a) for a in (qw, s, zs, te, live))))


@pytest.mark.parametrize("splits,cps", [(1, 4), (2, 2), (4, 1)])
@pytest.mark.parametrize("bm", [32, 96])
def test_split_fold_matches_pallas_interpret(monkeypatch, bm, splits, cps):
    """K12's fold on its split plan (each group's exact int32 dot folded in
    order, the splits' f32 partials summed in split order, the row scale
    once before the bf16 rounding) against ``_make_grouped_kernel_a8`` in
    interpret mode within TOL (one bf16 step and the Pallas route's in-jit
    code rounding, as tests/test_torch_a8.py), against K12's plain version
    within one bf16 step of the output (1e-2 x (1 + |ref|)); dead tiles zero."""
    (xj, qwj, sj, zsj, tej, lvj), args = _inputs(bm)
    jax.clear_caches()
    monkeypatch.setenv("QUICK_TPU_PALLAS_INTERPRET", "1")
    want = jgm.quantized_matmul_grouped(xj, qwj, sj, zsj, tej, bm, tile_live=lvj, a8=True)
    monkeypatch.delenv("QUICK_TPU_PALLAS_INTERPRET")
    jax.clear_caches()
    got = tgm.quantized_matmul_grouped_a8_split_plain(*args, bm, splits, cps)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (6 * bm, 256)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)
    ref = f32(tgm.quantized_matmul_grouped_a8_plain(*args, bm))
    assert (np.abs(f32(got) - ref) <= 1e-2 * (1 + np.abs(ref))).all()
    assert not f32(got)[5 * bm:].any()
