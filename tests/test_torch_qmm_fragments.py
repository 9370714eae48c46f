"""K1's wgmma body above 8 rows (``csrc/qmm_wgmma.cuh``), modelled in numpy
on the CPU: the per-lane word -> tensor-core fragment mapping over the
QTPU words as they are, the nibble -> bf16 bit trick, and the launch plan
(``launch_plan``, ``wgmma_smem_bytes``). No Pallas and no card: the kernel
itself is held against its plain version in test_torch_kernels.py.

The QTPU layout puts code ``q[g*128 + j*16 + k8, n]`` in nibble ``j`` of
word ``[g*16 + k8, n]``. A k16 tensor-core fragment gives lane (g, t) the
depths 2t, 2t+1, 2t+8, 2t+9, which in step j of a group are nibble j of the
words at k8 = 2t, 2t+1, 2t+8, 2t+9, so a lane builds all 8 steps' fragments
from its own words. The model rebuilds every lane's fragments with the
kernel's bit operations and reassembles each step's operand tile from the
documented fragment layouts; it must equal the JAX package's
``unpack_qtpu`` codes."""
import math

import numpy as np
import pytest

from quick_tpu.quantize.packing import pack_qtpu, unpack_qtpu
import quick_tpu_torch.ops.quantized_matmul as tqmm

G = 128
H100_SMS = 132
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may use on the H100


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: result byte i is byte (sel >> 4i) & 7 of the
    eight bytes {x0..x3, y0..y3}."""
    x, y = np.broadcast_arrays(x, y)
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)] +
                   [(y >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def bf16_bits_to_f32(h: np.ndarray) -> np.ndarray:
    return (h.astype(np.uint32) << 16).view(np.float32)


def code_pair(lo: np.ndarray, hi: np.ndarray, j: int) -> np.ndarray:
    """``qwg::code_pair``: the bf16x2 register {code j of lo, code j of hi}
    as float32 [..., 2], through the kernel's operations: prmt of byte j/2
    of both words into the two halves, a shift for odd j, the nibble mask
    under 0x4300 (128 + code, exact), then a bf16 subtraction of 128."""
    b = j >> 1
    v = byte_perm(lo, hi, b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12))
    if j & 1:
        v = v >> 4
    v = (v & 0x000F000F) | 0x43004300
    halves = np.stack([v & 0xFFFF, v >> 16], axis=-1)
    val = bf16_bits_to_f32(halves) - np.float32(128.0)
    # the difference of two bf16 values 128 apart is exact and a bf16 value
    assert np.array_equal(val, bf16_bits_to_f32(
        (val.view(np.uint32) >> 16).astype(np.uint32)))
    return val


def lane_words(qw: np.ndarray, grp: int, n: np.ndarray, t: np.ndarray) -> list:
    """A lane's four words of group ``grp`` at column(s) n: packed rows
    k8 = 2t, 2t+1, 2t+8, 2t+9."""
    return [qw[grp * 16 + 2 * t + (i & 1) + (i >> 1) * 8, n] for i in range(4)]


def wgmma_a_tiles(qw: np.ndarray, grp: int, c0: int) -> np.ndarray:
    """The 8 A operands [8, 64 channels, 16 depths] a warpgroup feeds wgmma
    for channels c0 .. c0 + 63 of group ``grp``, reassembled from every
    lane's fragments. Lane (g, t) of warp w holds channels c = c0 + 16w + g
    and c + 8; register 0: (c, depths 2t, 2t+1), 1: (c + 8, 2t, 2t+1),
    2: (c, 2t+8, 2t+9), 3: (c + 8, 2t+8, 2t+9)."""
    tiles = np.full((8, 64, 16), np.nan, np.float32)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            c = c0 + 16 * w + g
            w0 = lane_words(qw, grp, np.array(c), np.array(t))
            w1 = lane_words(qw, grp, np.array(c + 8), np.array(t))
            for j in range(8):
                regs = [code_pair(w0[0], w0[1], j), code_pair(w1[0], w1[1], j),
                        code_pair(w0[2], w0[3], j), code_pair(w1[2], w1[3], j)]
                for r, v in enumerate(regs):
                    row = 16 * w + g + 8 * (r & 1)
                    k = 2 * t + 8 * (r >> 1)
                    tiles[j, row, k:k + 2] = v
    return tiles


def mma_b_tiles(qw: np.ndarray, grp: int, n0: int) -> np.ndarray:
    """The 8 B operands [8, 16 depths, 8 columns] of mma.sync m16n8k16 for
    columns n0 .. n0 + 7, from each lane's four words of its column n0 + g:
    register 0: depths 2t, 2t+1, register 1: depths 2t+8, 2t+9."""
    tiles = np.full((8, 16, 8), np.nan, np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        ws = lane_words(qw, grp, np.array(n0 + g), np.array(t))
        for j in range(8):
            for r, v in enumerate((code_pair(ws[0], ws[1], j), code_pair(ws[2], ws[3], j))):
                k = 2 * t + 8 * r
                tiles[j, k:k + 2, g] = v
    return tiles


@pytest.fixture
def codes_and_words():
    rng = np.random.default_rng(10)
    K, N = 2 * G, 128
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    qw = pack_qtpu(q, G).view(np.uint32)
    ref = unpack_qtpu(pack_qtpu(q, G), G).astype(np.float32)
    assert np.array_equal(ref, q.astype(np.float32))
    return ref, qw


def test_code_pair_every_nibble_and_pair():
    """Every code in every nibble position of both words comes out exact."""
    lo = np.array([sum(((a + j) % 16) << (4 * j) for j in range(8))
                   for a in range(16)], np.uint32)
    hi = np.array([sum(((b * 3 + j) % 16) << (4 * j) for j in range(8))
                   for b in range(16)], np.uint32)
    for j in range(8):
        v = code_pair(lo[:, None], hi[None, :], j)
        assert np.array_equal(v[..., 0], np.broadcast_to(((np.arange(16) + j) % 16)[:, None],
                                                         (16, 16)))
        assert np.array_equal(v[..., 1], np.broadcast_to(((np.arange(16) * 3 + j) % 16)[None, :],
                                                         (16, 16)))


@pytest.mark.parametrize("grp", [0, 1])
@pytest.mark.parametrize("c0", [0, 64])
def test_wgmma_register_a_fragments_equal_codes(codes_and_words, grp, c0):
    """Swap layout: A = W^T, 64 channels x 16 depths per step, from the
    words as packed; step j of group grp is codes [grp*128 + 16j + k, c]."""
    ref, qw = codes_and_words
    tiles = wgmma_a_tiles(qw, grp, c0)
    for j in range(8):
        want = ref[grp * G + 16 * j: grp * G + 16 * j + 16, c0:c0 + 64].T
        assert np.array_equal(tiles[j], want), f"step {j}"


@pytest.mark.parametrize("grp", [0, 1])
@pytest.mark.parametrize("n0", [0, 8, 120])
def test_mma_sync_b_fragments_equal_codes(codes_and_words, grp, n0):
    """The mma.sync B layout over the same words (the same per-lane
    mapping, one column a lane): step j is codes [grp*128 + 16j + k, n]."""
    ref, qw = codes_and_words
    tiles = mma_b_tiles(qw, grp, n0)
    for j in range(8):
        want = ref[grp * G + 16 * j: grp * G + 16 * j + 16, n0:n0 + 8]
        assert np.array_equal(tiles[j], want), f"step {j}"


# (K, N) of the G = 128 projections that reach K1 above 8 rows: Mistral-7B
# and Mixtral-8x7B's attention (qkv, o) and Mistral's MLP (gate_up, down);
# DeepSeek-V2-Lite's q, kv_a, o, dense gate_up and shared-expert widths
# (its dense down, K = 10944, is no multiple of 128)
PLAN_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
               (2048, 3072), (2048, 576), (2048, 2048), (2048, 21888),
               (2048, 5632), (2816, 2048), (512, 200)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES)
def test_wgmma_launch_plan(K, N):
    """For every M in 9..8192: the token width is the least of 16, 32, 64,
    128 that holds M (128 beyond), the tiles cover M and N, the splits take
    every group exactly once, K is split only where the tiles fill at most
    half of the blocks the card holds and then into no more than fill it,
    and the block's shared memory (and its epilogue tile) fit the H100."""
    ng = K // G
    for M in range(9, 8193):
        bt, splits, gps = tqmm.launch_plan(M, K, N, H100_SMS)
        assert bt in tqmm.WGMMA_TOKENS
        assert bt >= M or bt == tqmm.WGMMA_TOKENS[-1]
        assert bt == 16 or bt // 2 < M
        assert math.ceil(M / bt) * bt >= M and math.ceil(N / 128) * 128 >= N
        assert splits * gps >= ng and (splits - 1) * gps < ng
        tiles = math.ceil(N / 128) * math.ceil(M / bt)
        slots = H100_SMS * tqmm.wgmma_blocks_per_sm(bt)
        if 2 * tiles > slots:
            assert splits == 1
        else:
            assert min(slots // 2, tiles * ng) <= tiles * splits <= slots
        smem = tqmm.wgmma_smem_bytes(bt)
        assert smem <= SMEM_LIMIT
        assert bt * (128 + 8) * 2 <= smem - 1024  # the epilogue's bf16 tile
        assert tqmm.wgmma_blocks_per_sm(bt) * smem <= 228 * 1024


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8])
def test_decode_rows_keep_their_plan(M):
    """Up to 8 rows K1 keeps the CUDA-core decode plan (K9 and K11's)."""
    for K, N in PLAN_SHAPES:
        assert tqmm.launch_plan(M, K, N, H100_SMS) == tqmm.mma_launch_plan(
            M, K, N, H100_SMS)


@pytest.mark.parametrize("group", [128, 64, 32])
@pytest.mark.parametrize("N", [130, 202, 7])
def test_pad_columns_gives_the_plain_result(group, N):
    """An N that is no multiple of 4, padded by ``pad_columns`` as the
    wgmma wrappers pad it on the card: zero columns, multiple of 4, and the
    plain GEMMs over the padded weight, sliced back to N, equal the plain
    GEMMs over the weight as given."""
    import torch

    rng = np.random.default_rng(N + group)
    K, M = 2 * G, 5
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    s = (rng.uniform(size=(K // group, N)) * 0.01 + 0.001).astype(np.float32)
    zs = np.round(rng.uniform(size=(K // group, N)) * 15).astype(np.float32) * s
    w = [torch.from_numpy(a) for a in (pack_qtpu(q, group), s, zs)]
    padded = tqmm.pad_columns(*w)
    assert all(p.shape[-1] % 4 == 0 and p.shape[-1] - N < 4 for p in padded)
    assert all(torch.equal(p[..., :N], a) and not p[..., N:].any() for p, a in zip(padded, w))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    plain = tqmm.quantized_matmul_plain if group == G else tqmm.quantized_matmul_dequant_plain
    assert torch.equal(plain(x, *padded, group)[:, :N], plain(x, *w, group))
