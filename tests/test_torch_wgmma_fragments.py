"""K9's and K11 / K11f's wgmma bodies above 8 rows (``csrc/qmm_wgmma_dq.cuh``,
``csrc/qmm_wgmma_a8.cuh``), modelled in numpy on the CPU: the per-lane word
-> register-operand fragment maps over the QTPU words as they are, the
kernels' exact arithmetic tricks, the plain version of K11f's quantization
kernel, and the launch plans with their shared memory. No card: the
kernels themselves are held against their plain versions in
test_torch_kernels.py.

At group G the QTPU layout puts code ``k = g*G + j*(G/8) + r`` in nibble
``j`` of word ``[g*G/8 + r, n]``. Each model rebuilds every lane's
fragments with the kernel's bit operations and reassembles each step's
operand tile [64 channels, depths] from the documented fragment layouts;
it must equal the JAX package's ``unpack_qtpu`` codes (and, for K9, the
bf16 weights of its plain version)."""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quick_tpu_torch.ops.quantized_matmul as tqmm
from quick_tpu.quantize.packing import pack_qtpu, unpack_qtpu

jqm = importlib.import_module("quick_tpu.ops.quantized_matmul")  # the package re-exports a function of that name

H100_SMS = 132
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may use on the H100
SM_SMEM = 228 * 1024     # shared memory of one SM for its resident blocks


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: result byte i is byte (sel >> 4i) & 7 of the
    eight bytes {x0..x3, y0..y3}."""
    x, y = np.broadcast_arrays(np.asarray(x, np.uint32), np.asarray(y, np.uint32))
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)] +
                   [(y >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def bf16_round(v: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) -> f32."""
    return np.asarray(np.asarray(v, np.float32).astype(jnp.bfloat16), np.float32)


def fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fmaf for the operands the kernels give it: the f64 product of two
    f32 values is exact, and here the exact sum (a multiple of the
    product's ulp below 2^28 of them) is exact in f64 too, so one rounding
    to f32 is the FMA's."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def magic_f32(nibble: np.ndarray) -> np.ndarray:
    """``__uint_as_float(nibble | 0x4B000000)`` = 2^23 + nibble, exact."""
    return (np.asarray(nibble, np.uint32) | np.uint32(0x4B000000)).view(np.float32)


# ------------------------------------------------------------------ K9

def dq_pair(lo, hi, sh, s, c, zs) -> np.ndarray:
    """``qwd::dq_pair``: [..., 2] f32 of the bf16x2 register {w(lo), w(hi)},
    w = bf16(fma(2^23 + code, s, c) - zs) with c = -2^23 * s."""
    out = []
    for w in (lo, hi):
        f = magic_f32((np.asarray(w, np.uint32) >> np.uint32(sh)) & np.uint32(0xF))
        out.append(bf16_round(np.float32(fma_f32(f, s, c) - np.float32(zs))))
    return np.stack(out, axis=-1)


def dq_a_tiles(qw, scales, zs, stage: int, c0: int, G: int):
    """The 8 A operands [8, 64 channels, 16 depths] a warpgroup feeds wgmma
    for channels c0 .. c0 + 63 of 128-deep stage ``stage``, each lane's
    fragments built as ``dq_wgmma_kernel`` builds them, then placed by the
    k16 A layout: lane (g, t) of warp w holds channels c = c0 + 16w + g and
    c + 8; register h: (c + 8h, depths 2t, 2t+1), register 2 + h:
    (c + 8h, depths 2t+8, 2t+9)."""
    cg, slab = 128 // G, G // 8
    tiles = np.full((8, 64, 16), np.nan, np.float32)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for q in range(cg):
                grp = stage * cg + q
                for h in range(2):
                    ch = c0 + 16 * w + g + 8 * h
                    s = np.float32(scales[grp, ch])
                    z = np.float32(zs[grp, ch])
                    c = np.float32(-8388608.0) * s
                    if G == 64:
                        r0 = grp * slab + 2 * t
                        lo, hi = qw[r0, ch], qw[r0 + 1, ch]
                        regs = [(q * 4 + st, 8 * st, 8 * st + 4) for st in range(4)]
                    else:
                        r0 = grp * slab + 2 * (t & 1)
                        sh = 4 * (t >> 1)
                        lo, hi = qw[r0, ch] >> np.uint32(sh), qw[r0 + 1, ch] >> np.uint32(sh)
                        regs = [(q * 2 + st, 16 * st, 16 * st + 8) for st in range(2)]
                    for step, sh_a, sh_b in regs:
                        row = 16 * w + g + 8 * h
                        tiles[step, row, 2 * t:2 * t + 2] = dq_pair(lo, hi, sh_a, s, c, z)
                        tiles[step, row, 2 * t + 8:2 * t + 10] = dq_pair(lo, hi, sh_b, s, c, z)
    return tiles


@pytest.fixture(scope="module", params=[32, 64])
def small_group(request):
    """Random codes at G (two stages of K), their QTPU words, scales and
    zeros_x_scales, and the plain version's bf16 weights."""
    G = request.param
    rng = np.random.default_rng(G)
    K, N = 256, 128
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    s = (rng.uniform(size=(K // G, N)) * 0.01 + 0.001).astype(np.float32)
    zs = (np.round(rng.uniform(size=(K // G, N)) * 15) * s).astype(np.float32)
    qw = pack_qtpu(q, G)
    codes = unpack_qtpu(qw, G).astype(np.float32)
    assert np.array_equal(codes, q.astype(np.float32))
    w = tqmm.quantized_matmul_dequant_plain(  # the plain weights: x = identity
        torch.eye(K), torch.from_numpy(qw), torch.from_numpy(s), torch.from_numpy(zs), G,
        torch.float32).numpy()
    return G, qw.view(np.uint32), s, zs, codes, w


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("c0", [0, 64])
def test_dequant_register_fragments_equal_plain_weights(small_group, stage, c0):
    """At G = 32 and 64, step j of stage ``stage`` is the plain version's
    bf16 weights [stage*128 + 16j + k, c] (and each nonzero one's code): the
    fragment map needs no repack, and the FMA form of the product rounds as
    the plain product does."""
    G, qw, s, zs, codes, w = small_group
    tiles = dq_a_tiles(qw, s, zs, stage, c0, G)
    for j in range(8):
        k0 = stage * 128 + 16 * j
        assert np.array_equal(tiles[j], w[k0:k0 + 16, c0:c0 + 64].T), f"step {j}"
    # the same tiles with s = 1, zs = 0 are the codes themselves
    ones = dq_a_tiles(qw, np.ones_like(s), np.zeros_like(zs), stage, c0, G)
    for j in range(8):
        k0 = stage * 128 + 16 * j
        assert np.array_equal(ones[j], codes[k0:k0 + 16, c0:c0 + 64].T), f"codes, step {j}"


def test_fma_product_equals_the_rounded_product():
    """fma(2^23 + q, s, -2^23 * s) rounds the exact q * s once, so it is
    the f32 product q * s for every code and scales across the f32 range
    (subnormal to large); -2^23 * s is exact."""
    rng = np.random.default_rng(1)
    s = np.concatenate([
        (rng.uniform(size=4000) * 0.02).astype(np.float32),
        np.float32(2.0) ** rng.integers(-140, 100, size=2000).astype(np.float32)
        * rng.uniform(1, 2, size=2000).astype(np.float32),
    ]).astype(np.float32)
    s = np.concatenate([s, -s])
    c = np.float32(-8388608.0) * s
    assert np.array_equal(np.float64(c), -8388608.0 * np.float64(s))
    for q in range(16):
        got = fma_f32(magic_f32(np.full(s.shape, q)), s, c)
        want = np.float32(q) * s
        assert np.array_equal(got, want), q  # == counts -0 as 0 (q = 0, s < 0)


# ------------------------------------------------------------------ K11f

def byte_transpose(v):
    """``qwa::byte_transpose``: out[b] = {v0.b, v1.b, v2.b, v3.b}."""
    lo01 = byte_perm(v[0], v[1], 0x5140)
    lo23 = byte_perm(v[2], v[3], 0x5140)
    hi01 = byte_perm(v[0], v[1], 0x7362)
    hi23 = byte_perm(v[2], v[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def s8_bytes(reg) -> np.ndarray:
    return np.array([(int(reg) >> (8 * i)) & 0xFF for i in range(4)], np.int64).astype(np.int8)


def a8_a_tiles(qw, grp: int, c0: int) -> np.ndarray:
    """The 4 s8 A operands [4, 64 channels, 32 depths] of group ``grp`` for
    channels c0 .. c0 + 63, each lane's registers built as
    ``a8_wgmma_kernel`` builds them, placed by the k32 8-bit A layout: lane
    (g, t) of warp w, register h: (c + 8h, depths 4t .. 4t+3), register 2 +
    h: (c + 8h, depths 16 + 4t .. 16 + 4t+3), one depth a byte."""
    tiles = np.full((4, 64, 32), -1, np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for h in range(2):
                ch = c0 + 16 * w + g + 8 * h
                words = [qw[grp * 16 + 4 * t + i, ch] for i in range(4)]
                b = byte_transpose([np.uint32(x) for x in words])
                for s in range(4):
                    lo = np.uint32(b[s]) & np.uint32(0x0F0F0F0F)
                    hi = (np.uint32(b[s]) >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
                    row = 16 * w + g + 8 * h
                    tiles[s, row, 4 * t:4 * t + 4] = s8_bytes(lo)
                    tiles[s, row, 16 + 4 * t:16 + 4 * t + 4] = s8_bytes(hi)
    return tiles


@pytest.mark.parametrize("grp", [0, 1])
@pytest.mark.parametrize("c0", [0, 64])
def test_a8_register_fragments_equal_codes(grp, c0):
    """At G = 128, s8 step s of group grp is codes [grp*128 + 32s + k, c],
    read from the words as packed."""
    rng = np.random.default_rng(11)
    K, N = 256, 128
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    qw = pack_qtpu(q, 128)
    ref = unpack_qtpu(qw, 128).astype(np.int64)
    tiles = a8_a_tiles(qw.view(np.uint32), grp, c0)
    for s in range(4):
        k0 = grp * 128 + 32 * s
        assert np.array_equal(tiles[s], ref[k0:k0 + 32, c0:c0 + 64].T), f"step {s}"


def a8_a_tiles_small(qw, G: int, stage: int, c0: int) -> np.ndarray:
    """The s8 A operands [4 steps, 64 channels, 32 depths] of 128-deep
    stage ``stage`` at G = 64 or 32 for channels c0 .. c0 + 63, each lane's
    registers built as ``qwa::a_fragments`` builds them (group c of the
    stage: G / 32 steps, global step c * G / 32 + s)."""
    steps = G // 32
    tiles = np.full((4, 64, 32), -1, np.int64)
    mask = np.uint32(0x0F0F0F0F)
    for c in range(128 // G):
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    ch = c0 + 16 * w + g + 8 * h
                    base = stage * 16 + c * (G // 8)
                    if G == 64:
                        words = [np.uint32(qw[base + 4 * (t & 1) + i, ch]) >> np.uint32(4 * (t >> 1))
                                 for i in range(4)]
                    else:
                        words = [np.uint32(qw[base + i, ch]) >> np.uint32(4 * t) for i in range(4)]
                    b = byte_transpose(words)
                    for s in range(steps):
                        lo = np.uint32(b[2 * s]) & mask
                        hi = np.uint32(b[2 * s + 1 + (G == 32)]) & mask
                        row = 16 * w + g + 8 * h
                        tiles[c * steps + s, row, 4 * t:4 * t + 4] = s8_bytes(lo)
                        tiles[c * steps + s, row, 16 + 4 * t:16 + 4 * t + 4] = s8_bytes(hi)
    return tiles


@pytest.mark.parametrize("G", [64, 32])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("c0", [0, 64])
def test_a8_small_group_fragments_equal_codes(G, stage, c0):
    """At G = 64 and 32, s8 step j of a 128-deep stage is codes
    [stage*128 + 32j + k, c] (each group's steps in order), read from the
    words as packed by the JAX package."""
    rng = np.random.default_rng(G + stage)
    K, N = 256, 128
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    qw = pack_qtpu(q, G)
    ref = unpack_qtpu(qw, G).astype(np.int64)
    tiles = a8_a_tiles_small(qw.view(np.uint32), G, stage, c0)
    for j in range(4):
        k0 = stage * 128 + 32 * j
        assert np.array_equal(tiles[j], ref[k0:k0 + 32, c0:c0 + 64].T), f"step {j}"


@pytest.mark.parametrize("G", [128, 64, 32])
@pytest.mark.parametrize("M", [1, 97, 200])
def test_a8_rowsum_plain_equals_jax_group_sums(M, G):
    """K11's first kernel, plain: the row sums [K / G, M] of the codes that
    quantize_activations gives equal the integer group sums of the JAX
    package's codes."""
    rng = np.random.default_rng(M + G)
    K = 640 if G < 128 else 512
    x = (rng.standard_normal((M, K)) * rng.uniform(0.01, 10, size=(M, 1))).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xq, _ = tqmm.quantize_activations(xt)
    rowsum = tqmm.a8_rowsum_plain(xq, G)
    qj, _ = jqm.quantize_activations(jnp.asarray(np.asarray(xt.float()), jnp.bfloat16))
    want = np.asarray(qj).astype(np.int64).reshape(M, K // G, G).sum(-1).T
    assert rowsum.shape == (K // G, M) and rowsum.dtype == torch.float32
    assert np.array_equal(rowsum.numpy(), want.astype(np.float32))


def test_small_int_to_float_is_exact():
    """``qwa::small_i2f``: an int32 below 2^22 in magnitude (a group's dot
    is at most 128 * 127 * 15) under the exponent of 1.5 * 2^23, minus
    1.5 * 2^23, is its f32 value."""
    v = np.concatenate([np.arange(-2**22, -2**22 + 4096), np.arange(-4096, 4096),
                        np.arange(2**22 - 4096, 2**22),
                        np.random.default_rng(2).integers(-2**22, 2**22, 100000)]).astype(np.int64)
    f = ((v + 0x4B400000).astype(np.uint32).view(np.float32) - np.float32(12582912.0))
    assert np.array_equal(f, v.astype(np.float32))
    assert 128 * 127 * 15 < 2**22


@pytest.mark.parametrize("M,K", [(3, 256), (97, 512), (200, 1024)])
def test_a8_row_quant_plain_equals_quantize_activations_and_jax(M, K):
    """The plain model of K11f's first kernel: its codes and row scales are
    quantize_activations', byte for byte, and the eager JAX function's;
    its row sums [K / 128, M] are the integer sums of each group's codes."""
    rng = np.random.default_rng(M + K)
    x = (rng.standard_normal((M, K)) * rng.uniform(0.01, 10, size=(M, 1))).astype(np.float32)
    x[0, :7] = [0.0, 127.0, -127.0, 63.5, -0.5, 1.5, 2.5]  # ties round to even
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xq, sx, rowsum = tqmm.a8_row_quant_plain(xt)
    q2, s2 = tqmm.quantize_activations(xt)
    assert torch.equal(xq, q2) and torch.equal(sx, s2)
    qj, sj = jqm.quantize_activations(jnp.asarray(np.asarray(xt.float()), jnp.bfloat16))
    assert np.array_equal(xq.numpy(), np.asarray(qj)) and np.array_equal(sx.numpy(), np.asarray(sj))
    want = np.asarray(qj).astype(np.int64).reshape(M, K // 128, 128).sum(-1).T
    assert rowsum.dtype == torch.float32 and np.array_equal(rowsum.numpy(), want.astype(np.float32))


# ------------------------------------------------------------------ plans

#: (K, N) of the shapes K9 takes above 8 rows: Mistral-7B width at G = 32
#: (GGUF), Qwen1.5-MoE's attention and shared expert at G = 64, and
#: DeepSeek-V2-Lite's seven (q, kv_a, o, dense gate_up / down, shared
#: gate_up / down; its dense down K = 10944 is 85.5 stages)
DQ_PLAN_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                  (2048, 6144), (2048, 2048), (2048, 11264), (5632, 2048),
                  (2048, 3072), (2048, 576), (2048, 21888), (10944, 2048),
                  (2048, 5632), (2816, 2048), (160, 200)]


def _check_wgmma_plan(plan, M, chunks, N):
    bt, splits, per = plan
    assert bt in tqmm.WGMMA_TOKENS
    assert bt >= M or bt == tqmm.WGMMA_TOKENS[-1]
    assert bt == 16 or bt // 2 < M
    assert splits * per >= chunks and (splits - 1) * per < chunks
    tiles = math.ceil(N / 128) * math.ceil(M / bt)
    slots = H100_SMS * tqmm.wgmma_blocks_per_sm(bt)
    if 2 * tiles > slots:
        assert splits == 1
    else:
        assert min(slots // 2, tiles * chunks) <= tiles * splits <= slots
    return bt


@pytest.mark.parametrize("K,N", DQ_PLAN_SHAPES)
def test_dequant_launch_plan(K, N):
    """K9 for M in 1..4096: the decode rows keep the CUDA-core plan; above
    8 rows the wgmma plan over the 128-deep stages (a partial last one
    counts), and each block's shared memory (with its epilogue tile) fits
    the H100 at both groups."""
    chunks = math.ceil(K / 128)
    for M in range(1, 4097):
        plan = tqmm.dequant_launch_plan(M, K, N, H100_SMS)
        if M <= 8:
            assert plan == tqmm.mma_launch_plan(M, chunks * 128, N, H100_SMS)
            continue
        bt = _check_wgmma_plan(plan, M, chunks, N)
        for G in (32, 64):
            smem = tqmm.dequant_smem_bytes(bt, G)
            assert smem <= SMEM_LIMIT and bt * (128 + 8) * 2 <= smem - 1024
            assert tqmm.wgmma_blocks_per_sm(bt) * smem <= SM_SMEM


@pytest.mark.parametrize("K,N", [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                                 (512, 130)])
def test_a8_fused_launch_plan(K, N):
    """K11 / K11f for M in 97..8192 (the a8 gate): the wgmma body's token
    width, the split of K of the 64-row tiles (one plan for both, so that
    they sum alike), and each block's 6-stage ring within the H100's shared
    memory at every group."""
    for M in range(tqmm.A8_MIN_ROWS, 8193):
        bt, splits, gps = tqmm.a8_plan(M, K, N, H100_SMS)
        assert bt == tqmm.wgmma_plan(M, K // 128, N, H100_SMS)[0]
        assert (splits, gps) == tqmm.mma_launch_plan(M, K, N, H100_SMS)[1:]
        assert splits * gps >= K // 128 and (splits - 1) * gps < K // 128
        for G in tqmm.A8_GROUPS:
            smem = tqmm.a8_smem_bytes(bt, G)
            assert smem <= SMEM_LIMIT and bt * (128 + 8) * 2 <= smem - 1024
            assert tqmm.wgmma_blocks_per_sm(bt) * smem <= SM_SMEM
    for bt in tqmm.WGMMA_TOKENS:  # every width fits, for direct calls with fewer rows
        for G in tqmm.A8_GROUPS:
            assert tqmm.wgmma_blocks_per_sm(bt) * tqmm.a8_smem_bytes(bt, G) <= SM_SMEM


#: (K, G) of K11's shapes: Mistral-7B width at G = 128 and DeepSeek-V2-Lite's
#: at G = 64 (its dense down K = 10944 is 85.5 stages), and ragged last
#: stages at G = 32 and 64
A8_PLAN_SHAPES = [(4096, 128), (14336, 128), (2048, 64), (10944, 64), (1408, 64), (320, 64),
                  (160, 32), (4096, 32)]


@pytest.mark.parametrize("K,G", A8_PLAN_SHAPES)
@pytest.mark.parametrize("N", [130, 2048, 4096])
def test_a8_plan_covers_k_at_every_group(K, G, N):
    """K11's splits of the 128-deep stages cover every group of K exactly
    once at every row count the gate passes: stage j of split z holds
    groups (z * cps + j) * 128 / G .. + 128 / G - 1, those past K / G
    skipped (the kernel's ``ngs``)."""
    ng, cg = K // G, 128 // G
    for M in (97, 128, 200, 512, 4096):
        _, splits, cps = tqmm.a8_plan(M, K, N, H100_SMS)
        nst = -(-K // 128)
        seen = np.zeros(ng, np.int64)
        for z in range(splits):
            for it in range(min(nst, z * cps + cps) - z * cps):
                st = z * cps + it
                ngs = min(cg, ng - st * cg)
                assert ngs > 0
                seen[st * cg:st * cg + ngs] += 1
        assert np.array_equal(seen, np.ones(ng, np.int64)), (M, K, G)
