"""K1's decode rows (M <= 8) on the 8-token ``wgmma`` body
(``csrc/quantized_matmul.cu``, ``qwk::decode_kernel``), modelled in numpy
on the CPU, in tests/test_torch_wgmma_fragments.py's style.

Each stage (one group of 128 depths) the block's threads stage the 8-row B
tile themselves: warp r takes row r, lane l the depths 4l .. 4l + 3 (8
bytes), applies the prologue (none, RMSNorm with the row's rstd, SiLU-GLU
over gate and up), rounds to bf16 and stores at ``half * 1024 + r * 128 +
((chunk ^ r) << 4) + (l & 1) * 8`` (half = l / 16, chunk = (l % 16) / 2:
the 128-byte swizzle the tensor copy would write); the warp's sum of its
row is the row's xsum. The model writes every lane's bytes, reads each k16
step back through the descriptor's swizzle (``swizzle128``), multiplies
with the register A operand of K1's wgmma body (``wgmma_a_tiles``), and
folds each group's dot as the kernel does (``acc += s * dot - xsum * zs``,
register e: channel c0 + 8 * (e >> 1), token 2t + (e & 1)); it must equal
``quantized_matmul_plain`` over the prologue-applied x, in f32 within
1e-5 x (1 + |ref|) (both sum exact products in f32, in other orders). No
card: the kernel is held against its plain version in
test_torch_kernels.py."""
import numpy as np
import pytest
import torch
from test_torch_qmm_fragments import wgmma_a_tiles
from test_torch_wgmma_fragments import swizzle128

import quick_tpu_torch.ops.quantized_matmul as tqmm
from quick_tpu.quantize.packing import pack_qtpu
from quick_tpu_torch.ops.norms import rms_norm_plain

G, N = 128, 128


def bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).float().numpy()


def stage_b_tile(xp: np.ndarray, grp: int, M: int):
    """Every lane's stores of group ``grp``'s prologue-applied bf16 values
    xp [M, K] into the 2048-byte tile (as bf16 words, NaN where nothing was
    written), and the rows' xsums [8] (rows >= M zero)."""
    tile = np.full(1024, np.nan, np.float32)
    writes = np.zeros(1024, np.int64)
    xsum = np.zeros(8, np.float32)
    for r in range(8):
        parts = []
        for lane in range(32):
            v = xp[r, grp * G + 4 * lane: grp * G + 4 * lane + 4] if r < M else np.zeros(4)
            parts.append((v[0] + v[1]) + (v[2] + v[3]))
            half, chunk = lane >> 4, (lane & 15) >> 1
            addr = half * 1024 + r * 128 + ((chunk ^ r) << 4) + (lane & 1) * 8
            tile[addr // 2: addr // 2 + 4] = v
            writes[addr // 2: addr // 2 + 4] += 1
        xsum[r] = np.sum(np.asarray(parts, np.float32), dtype=np.float32)
    assert np.array_equal(writes, np.ones(1024, np.int64))  # each word once
    return tile, xsum


def b_steps(tile: np.ndarray) -> np.ndarray:
    """The 8 B operands [8, 8 tokens, 16 depths] of one stage, read through
    the descriptor: step j starts at (j >> 2) * 1024 + (j & 3) * 32."""
    out = np.zeros((8, 8, 16), np.float32)
    n, k = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    for j in range(8):
        logical = (j >> 2) * 1024 + (j & 3) * 32 + n * 128 + k * 2
        out[j] = tile[swizzle128(logical) // 2]
    return out


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("prologue", [None, "rmsnorm", "glu"])
def test_decode_tile_and_fold_equal_plain(M, prologue):
    rng = np.random.default_rng(M * 7 + len(prologue or ""))
    K = 3 * G
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    qw = pack_qtpu(q, G)
    s = (rng.uniform(size=(K // G, N)) * 0.01 + 0.001).astype(np.float32)
    zs = (np.round(rng.uniform(size=(K // G, N)) * 15) * s).astype(np.float32)
    x = bf16(rng.standard_normal((M, 2 * K if prologue == "glu" else K)))
    nw = bf16(1 + 0.1 * rng.standard_normal(K))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if prologue == "rmsnorm":
        # the kernel: bf16(x * rstd * w), rstd from its first kernel
        rstd = 1.0 / np.sqrt((x.astype(np.float64) ** 2).mean(-1) + 1e-5)
        xp = bf16(x * rstd.astype(np.float32)[:, None] * nw[None, :])
        ref_in = rms_norm_plain(xt, torch.from_numpy(nw).to(torch.bfloat16), 1e-5)
        assert np.abs(ref_in.float().numpy() - xp).max() <= 2 ** -7 * np.abs(xp).max()
        ref_in = torch.from_numpy(xp)  # the fold is held to the kernel's own prologue values
    elif prologue == "glu":
        g, u = x[:, :K], x[:, K:]
        xp = bf16(g * (1.0 / (1.0 + np.exp(-g))) * u)
        assert np.array_equal(tqmm.glu_plain(xt).float().numpy(), xp)
        ref_in = torch.from_numpy(xp)
    else:
        xp, ref_in = x, xt
    acc = np.zeros((N, 8), np.float32)  # [channels, tokens], as the accumulators
    for grp in range(K // G):
        tile, xsum = stage_b_tile(xp, grp, M)
        steps = b_steps(tile)
        for c0 in (0, 64):  # the two warpgroups
            a = wgmma_a_tiles(qw.view(np.uint32), grp, c0)  # [8, 64, 16]
            dot = np.zeros((64, 8), np.float32)
            for j in range(8):
                dot += a[j] @ steps[j].T
            ch = slice(c0, c0 + 64)
            acc[ch] = acc[ch] + dot * s[grp, ch, None] - xsum[None, :] * zs[grp, ch, None]
    assert not acc[:, M:].any()  # rows >= M are zeros
    ref = tqmm.quantized_matmul_plain(ref_in, torch.from_numpy(qw), torch.from_numpy(s),
                                      torch.from_numpy(zs), out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(acc[:, :M].T, ref, atol=1e-5, rtol=1e-5)
