"""K8's launch on the CPU: the register operand its lanes build from the
QTPU words at G = 128, 64 and 32 (``a_fragments`` in csrc/grouped_matmul.cu,
modelled in numpy with K1's code_pair), the plain model of its tile scan
(``grouped_passes``) hands every live tile to exactly one pass of its own
expert's blocks, and every dead tile to exactly one expert's blocks to zero,
on the routings ``build_routing`` makes (the decode branch with experts
chosen by several tokens, the sorted branch with dead tiles; E = 8, 60, 64;
bm = 32, 64, 128); its split plan (``grouped_plan``) covers K once. (K8
itself is held against its plain version in test_torch_kernels.py, on a
card.)"""
import math

import numpy as np
import pytest
import torch
from test_torch_qmm_fragments import code_pair

import quick_tpu_torch.ops.grouped_matmul as tgm
from quick_tpu.quantize.packing import pack_qtpu

H100_SMS = 132


def k8_a_tiles(qw: np.ndarray, stage: int, c0: int, G: int) -> np.ndarray:
    """The 8 A operands [8 steps, 64 channels, 16 depths] of 128-deep stage
    ``stage`` that a warpgroup of channels c0 .. c0 + 63 feeds wgmma, each
    lane's registers built as ``qgm::a_fragments`` builds them. Lane (g, t)
    of warp w holds channels c = c0 + 16w + g and c + 8; register h: (c +
    8h, depths 2t, 2t+1), register 2 + h: (c + 8h, depths 2t+8, 2t+9)."""
    tiles = np.full((8, 64, 16), np.nan, np.float32)
    cg, slab = 128 // G, G // 8
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            regs = {}  # (step, register) -> [2] codes
            for h in range(2):
                ch = c0 + 16 * w + g + 8 * h
                if G == 128:
                    ws = [qw[stage * 16 + 2 * t + (i & 1) + (i >> 1) * 8, ch] for i in range(4)]
                    for j in range(8):
                        regs[j, h] = code_pair(ws[0], ws[1], j)
                        regs[j, 2 + h] = code_pair(ws[2], ws[3], j)
                    continue
                for q in range(cg):
                    row = (stage * cg + q) * slab
                    if G == 64:
                        lo, hi = qw[row + 2 * t, ch], qw[row + 2 * t + 1, ch]
                        for st in range(4):
                            regs[q * 4 + st, h] = code_pair(lo, hi, 2 * st)
                            regs[q * 4 + st, 2 + h] = code_pair(lo, hi, 2 * st + 1)
                    else:
                        sh = np.uint32(4 * (t >> 1))
                        lo = qw[row + 2 * (t & 1), ch] >> sh
                        hi = qw[row + 2 * (t & 1) + 1, ch] >> sh
                        for st in range(2):
                            regs[q * 2 + st, h] = code_pair(lo, hi, 4 * st)
                            regs[q * 2 + st, 2 + h] = code_pair(lo, hi, 4 * st + 2)
            for (j, r), v in regs.items():
                k = 2 * t + 8 * (r >> 1)
                tiles[j, 16 * w + g + 8 * (r & 1), k:k + 2] = v
    return tiles


@pytest.mark.parametrize("G", [128, 64, 32])
@pytest.mark.parametrize("stage,c0", [(0, 0), (1, 64)])
def test_register_a_fragments_equal_codes(G, stage, c0):
    """Step j of a stage is codes [stage*128 + 16j + k, c] at every group:
    the words as packed, no repack; step j reads B 32 bytes along the
    stage's 128-byte rows, half j // 4."""
    rng = np.random.default_rng(G + stage)
    K, N = 256, 128
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    qw = pack_qtpu(q, G).view(np.uint32)
    tiles = k8_a_tiles(qw, stage, c0, G)
    for j in range(8):
        want = q[stage * 128 + 16 * j: stage * 128 + 16 * j + 16, c0:c0 + 64].T
        assert np.array_equal(tiles[j], want.astype(np.float32)), f"G={G} step {j}"


def _sel(T, kk, E, seed):
    """Each token's kk distinct experts, random."""
    g = torch.Generator().manual_seed(seed)
    return torch.argsort(torch.rand((T, E), generator=g), dim=1)[:, :kk]


ROUTES = {  # (sel, E, bm)
    "decode_duplicates_e8": (torch.tensor([[0, 1], [0, 2], [3, 1], [0, 5]]), 8, 32),
    "decode_e60_top4": (_sel(4, 4, 60, 1), 60, 32),
    "decode_e64_top6": (_sel(4, 6, 64, 2), 64, 32),
    "sorted_e8_bm32": (_sel(16, 2, 8, 3), 8, 32),
    "sorted_e60_bm32": (_sel(40, 4, 60, 4), 60, 32),
    "sorted_e64_bm32": (_sel(128, 6, 64, 5), 64, 32),
    "sorted_e8_bm64": (_sel(160, 2, 8, 6), 8, 64),
    "sorted_e8_bm128": (_sel(512, 2, 8, 7), 8, 128),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_every_tile_in_one_pass_of_its_expert(name):
    sel, E, bm = ROUTES[name]
    _, _, te, live, _ = tgm.build_routing(sel, E, bm)
    te, live = te.tolist(), live.tolist()
    plan = tgm.grouped_passes(te, live, E, bm)
    per = tgm.GROUPED_PASS_ROWS[bm] // bm
    seen = []
    for e, passes in plan.items():
        if e < 0:
            continue
        for p in passes:
            assert 1 <= len(p) <= per and p == sorted(p)
            assert all(live[i] and te[i] == e for i in p)
            seen += p
        # every pass but the last is full: the scan takes tiles in order
        assert all(len(p) == per for p in passes[:-1])
    assert sorted(seen) == [i for i, lv in enumerate(live) if lv]
    zeroed = [i for e, dead in plan[-1].items() for i in dead
              if i % E == e]
    assert sorted(zeroed) == [i for i, lv in enumerate(live) if not lv]
    if name.startswith("decode"):
        assert all(live) and len(te) == sel.numel()  # a tile a (token, expert) pair
    if name == "decode_duplicates_e8":
        # expert 0, chosen by three tokens, is streamed in two passes of
        # 64 rows, not three; expert 1 (two tokens) in one
        assert plan[0] == [[0, 2], [6]] and plan[1] == [[1, 5]]
    if name.startswith("sorted"):
        assert plan[-1], "the row budget leaves dead tiles"


@pytest.mark.parametrize("E,n_tiles,K,N,bm", [
    (8, 8, 4096, 28672, 32), (8, 8, 14336, 4096, 32),      # Mixtral decode
    (8, 9, 14336, 4096, 32), (8, 16, 4096, 28672, 128),    # Engine step, prefill
    (8, 16, 14336, 4096, 128), (60, 16, 1408, 2048, 32),   # prefill down, Qwen decode
    (64, 24, 2048, 2816, 32), (64, 158, 1408, 2048, 32),   # DeepSeek decode, prefill
    (4, 3, 320, 256, 64), (2, 1, 128, 8, 128),
])
def test_split_plan_covers_k_once(E, n_tiles, K, N, bm):
    """The splits' stage ranges [z * cps, (z + 1) * cps) cover K's stages
    of 128 once, none empty; K is split only where the (column tile,
    expert) blocks fill fewer than twice the blocks the card holds, into
    slices of at least MIN_SPLIT_STAGES stages."""
    splits, cps = tgm.grouped_plan(E, n_tiles, K, N, bm, H100_SMS)
    nst = math.ceil(K / 128)
    assert splits >= 1 and cps >= 1
    assert splits * cps >= nst and (splits - 1) * cps < nst
    cover = np.zeros(nst, np.int64)
    for z in range(splits):
        cover[z * cps:min(nst, (z + 1) * cps)] += 1
    assert (cover == 1).all()
    blocks = math.ceil(N / 128) * min(E, n_tiles)
    slots = 2 * H100_SMS * (2 if tgm.GROUPED_PASS_ROWS[bm] == 64 else 1)
    assert (splits == 1) == (blocks >= slots or nst < 2 * tgm.MIN_SPLIT_STAGES)
    assert splits == 1 or nst // splits >= tgm.MIN_SPLIT_STAGES
