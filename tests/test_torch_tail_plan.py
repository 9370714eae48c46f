"""K14's work list and weight stream on the CPU (``ops/fused_layer_tail.py``:
``tail_plan``, ``block_items``, ``ring_events``, as the kernel runs them):
every (GEMM, column tile, group) stage streamed by exactly one block, each
tile's K splits disjoint and summed in split order, the ring's slot and
mbarrier phase following one running stage count per block across its
items and both grid barriers (with the next GEMM's stages issued before the
block arrives at a barrier), the stages a block streams in a GEMM within
one item of every other block's, and the grid never above the resident
count. Then the kernel's sum order (``fused_layer_tail_split_plain``: each
group folded in turn within a split, the splits summed in split order)
against the JAX package's Pallas tail in interpret mode at
tests/test_layer_tail.py's shapes and M = 1-8, within 8e-3 x max|ref| (the
bound K14 is held to against its plain version). (K14 itself is held to its
plain version on a card in test_torch_kernels.py and chip_smoke.py's phase
13a.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.fused_layer_tail as tft
from quick_tpu.ops.fused_layer_tail import fused_layer_tail as jax_tail
from quick_tpu.quantize.packing import pack_qtpu

RING = tft.RING_STAGES
#: (K1, D, I): Mistral-7B's tail, tests/test_layer_tail.py's, a narrow one
SHAPES = {"mistral": (4096, 4096, 14336), "test_layer_tail": (512, 384, 768),
          "narrow": (256, 256, 384)}
#: resident blocks: the H100's two an SM, one an SM, a few
RESIDENT = (264, 132, 5)


def _all_streams(plan):
    return [[(p, tile, g) for p, tile, _, g0, g1 in tft.block_items(plan, b)
             for g in range(g0, g1)] for b in range(plan.grid)]


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_stage_streamed_once(shape, resident):
    """Each (GEMM, tile, group) of the three GEMMs is in exactly one
    block's stream, and no stage lies outside a GEMM."""
    K1, D, I = SHAPES[shape]
    plan = tft.tail_plan(K1, D, I, resident)
    seen = [s for stream in _all_streams(plan) for s in stream]
    want = [(p, tile, g) for p, (K, N) in enumerate(((K1, D), (D, 2 * I), (I, D)))
            for tile in range(N // 128) for g in range(K // 128)]
    assert len(seen) == len(set(seen)) == len(want)
    assert set(seen) == set(want)


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_splits_disjoint_and_merged_in_order(shape, resident):
    """Every tile of a GEMM has each split 0 .. splits - 1 once, split z
    holding the groups z * gps onward in order; and the model's merge is the
    sum of the splits' folds in split order from zero, bit for bit."""
    plan = tft.tail_plan(*SHAPES[shape], resident)
    items = [it for b in range(plan.grid) for it in tft.block_items(plan, b)]
    for p, (tiles, ng, splits, gps) in enumerate(plan.gemms):
        assert (splits - 1) * gps < ng <= splits * gps
        for tile in range(tiles):
            mine = sorted((sp, g0, g1) for q, t, sp, g0, g1 in items if (q, t) == (p, tile))
            assert [sp for sp, _, _ in mine] == list(range(splits))
            assert [(g0, g1) for _, g0, g1 in mine] == [
                (z * gps, min(ng, z * gps + gps)) for z in range(splits)]
    rng = np.random.default_rng(1)
    K, N, M, splits, gps = 512, 128, 3, 3, 2
    qw = torch.from_numpy(pack_qtpu(rng.integers(0, 16, (K, N), dtype=np.uint8)))
    s = torch.from_numpy(rng.random((K // 128, N), dtype=np.float32) * 0.02)
    zs = torch.from_numpy(rng.random((K // 128, N), dtype=np.float32) * 0.01)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    total = tft._gemm_split(x, qw, s, zs, splits, gps)
    folds = [tft._gemm_split(x[:, z * gps * 128:(z + 1) * gps * 128], qw[z * gps * 16:(z + 1) * gps * 16],
                             s[z * gps:(z + 1) * gps], zs[z * gps:(z + 1) * gps], 1, gps)
             for z in range(splits)]
    want = torch.zeros_like(total)
    for f in folds:
        want = want + f
    assert torch.equal(total, want)
    assert torch.equal(total, tft._gemm_split(x, qw, s, zs, splits, gps))


@pytest.mark.parametrize("ahead", [2, 0])
@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ring_follows_one_running_count(shape, resident, ahead):
    """Per block: stages issued 0, 1, 2, ... in the work list's order and
    consumed in the same order; stage j issued before it is consumed and
    only after stage j - RING_STAGES (the slot's last user) was consumed;
    each slot's stages RING_STAGES apart, so its mbarrier phase parity
    alternates with the running count across items and both barriers. With
    the kernel's kAhead of 2 the ring is full at each barrier (every free
    slot holds a stage of what follows); with 0 it drains."""
    plan = tft.tail_plan(*SHAPES[shape], resident)
    streams = _all_streams(plan)
    for b in sorted({0, plan.grid // 2, plan.grid - 1}):
        events = tft.ring_events(plan, b, ahead)
        issue = [e for e in events if e[0] == "issue"]
        consume = [e for e in events if e[0] == "consume"]
        assert [e[1] for e in issue] == list(range(len(streams[b])))
        assert [e[1:] for e in consume] == [e[1:] for e in issue]
        assert [tuple(e[2:]) for e in issue] == streams[b]
        at = {(e[0], e[1]): i for i, e in enumerate(events) if e[0] != "barrier"}
        for j in range(len(issue)):
            assert at[("issue", j)] < at[("consume", j)]
            if j >= RING:
                assert at[("consume", j - RING)] < at[("issue", j)]
        for slot in range(RING):
            js = [j for j in range(len(issue)) if j % RING == slot]
            assert js == list(range(slot, len(issue), RING))
            assert [(j // RING) & 1 for j in js] == [i & 1 for i in range(len(js))]
        for i, e in enumerate(events):
            if e[0] != "barrier":
                continue
            done = sum(1 for x in events[:i] if x[0] == "consume")
            out = sum(1 for x in events[:i] if x[0] == "issue")
            assert out == (min(done + RING, len(issue)) if ahead else done)


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stages_balanced_within_one_item(shape, resident):
    """In each GEMM (the grid barriers separate them) the stages a block
    streams differ from any other block's by at most one item's groups, and
    the busiest block streams what split_plan minimised."""
    plan = tft.tail_plan(*SHAPES[shape], resident)
    for p, (tiles, ng, splits, gps) in enumerate(plan.gemms):
        per = [sum(g1 - g0 for q, *_, g0, g1 in tft.block_items(plan, b) if q == p)
               for b in range(plan.grid)]
        assert max(per) - min(per) <= gps
        assert max(per) <= -(-tiles * splits // plan.grid) * gps


def test_mistral_plan():
    """Mistral-7B's tail at 264 resident blocks: o 32 tiles x 32 groups in
    8 splits of 4, gate_up's 224 tiles unsplit (32 groups: one item a
    block beats seven of 4 groups once an item costs ITEM_STAGES more),
    down 32 x 112 in 8 splits of 14; 11,776 stages on 256 blocks, the
    busiest streaming 50 (4 + 32 + 14) in three items."""
    plan = tft.tail_plan(4096, 4096, 14336, 264)
    assert plan == tft.TailPlan(256, ((32, 32, 8, 4), (224, 32, 1, 32), (32, 112, 8, 14)))
    per = [len(s) for s in _all_streams(plan)]
    assert sum(per) == 11776 and max(per) == 50
    assert max(len(tft.block_items(plan, b)) for b in range(plan.grid)) == 3


@pytest.mark.parametrize("resident", [1, 2, 5, 7, 131, 132, 263, 264, 528])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_grid_within_resident(shape, resident):
    """The grid never exceeds the resident count given, nor the most items
    a GEMM has."""
    plan = tft.tail_plan(*SHAPES[shape], resident)
    assert 1 <= plan.grid <= resident
    assert plan.grid <= max(t * s for t, _, s, _ in plan.gemms)
    if resident >= 131:  # a card's resident count: the kernel's item table holds every list
        assert max(len(tft.block_items(plan, b)) for b in range(plan.grid)) <= tft.MAX_ITEMS


def _mk(rng, K, N, s=0.02):
    q = rng.integers(0, 16, (K, N), dtype=np.uint8)
    return (pack_qtpu(q, 128), rng.random((K // 128, N), dtype=np.float32) * s,
            rng.random((K // 128, N), dtype=np.float32) * s * 0.5)


@pytest.mark.parametrize("M", list(range(1, 9)))
def test_split_model_matches_pallas_interpret(M):
    """The kernel's sum order under the plans at 264 and at 5 resident
    blocks (one group a split, then several) against the Pallas tail in
    interpret mode on tests/test_layer_tail.py's shapes and inputs: within
    8e-3 x max|ref|, the bound K14 is held to (two orders of the f32 group
    sums, about two bf16 steps)."""
    rng = np.random.default_rng(M)
    K1, D, I = SHAPES["test_layer_tail"]
    ws = [_mk(rng, K1, D), _mk(rng, D, 2 * I), _mk(rng, I, D)]
    nw = (rng.standard_normal(D) * 0.1 + 1.0).astype(np.float32)
    ao = jnp.asarray(rng.standard_normal((M, K1)) * 0.1, jnp.bfloat16)
    xr = jnp.asarray(rng.standard_normal((M, D)) * 0.1, jnp.bfloat16)
    ref = f32(jax_tail(ao, xr, jnp.asarray(nw), *[jnp.asarray(a) for w in ws for a in w],
                       interpret=True))
    args = [torch.from_numpy(f32(ao)).to(torch.bfloat16), torch.from_numpy(f32(xr)).to(torch.bfloat16),
            torch.from_numpy(nw)] + [torch.from_numpy(np.asarray(a)) for w in ws for a in w]
    for resident in (264, 5):
        plan = tft.tail_plan(K1, D, I, resident)
        out = tft.fused_layer_tail_split_plain(*args, plan=plan)
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, D)
        assert np.abs(f32(out) - ref).max() <= 8e-3 * np.abs(ref).max()
