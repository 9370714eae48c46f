"""Port parity for the W4A16 GEMM: the plain PyTorch version of K1 against
quick_tpu's quantized_matmul, with and without the RMSNorm / SiLU-GLU
prologues. (K1 itself is held against the plain version in
test_torch_kernels.py, on a card.)"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu.ops.quantized_matmul import quantized_matmul as jax_qmm
from quick_tpu.quantize.packing import pack_qtpu
import quick_tpu_torch.ops.quantized_matmul as tqmm

TOL = dict(atol=2e-2, rtol=2e-2)  # as tests/test_quantized_matmul.py


def bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _case(rng, M, K, N, G=128, glu=False):
    x = rng.standard_normal((M, 2 * K if glu else K)).astype(np.float32)
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    s = (rng.uniform(size=(K // G, N)) * 0.01 + 0.001).astype(np.float32)
    z = np.round(rng.uniform(size=(K // G, N)) * 15).astype(np.float32)
    return x, pack_qtpu(q, G), s, (z * s).astype(np.float32)


def _norm_weight(rng, K):
    return (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)


def _both(rng, M, K, N, G, prologue):
    """(jax output, port output) on the same inputs."""
    x, qw, s, zs = _case(rng, M, K, N, G, glu=prologue == "glu")
    jx, tx = bf16_pair(x)
    kw_j, kw_t = {}, {}
    if prologue == "norm":
        jw, tw = bf16_pair(_norm_weight(rng, K))
        kw_j["fuse_norm"], kw_t["fuse_norm"] = (jw, 1e-5), (tw, 1e-5)
    elif prologue == "glu":
        kw_j["fuse_glu"] = kw_t["fuse_glu"] = True
    ref = jax_qmm(jx, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs),
                  group_size=G, **kw_j)
    out = tqmm.quantized_matmul(
        tx, torch.from_numpy(qw), torch.from_numpy(s), torch.from_numpy(zs),
        group_size=G, **kw_t,
    )
    return ref, out


@pytest.mark.parametrize(
    "M,K,N,G,prologue",
    [
        (1, 256, 128, 128, None),
        (4, 512, 384, 128, None),
        (16, 256, 256, 128, None),   # prefill-shaped rows
        (5, 256, 128, 64, None),     # small group: plain path only
        (1, 256, 256, 128, "norm"),
        (8, 512, 128, 128, "norm"),
        (12, 256, 128, 128, "norm"),  # rows > 8: norm applied first
        (2, 256, 256, 128, "glu"),
        (8, 384, 128, 128, "glu"),
        (10, 256, 128, 128, "glu"),   # rows > 8: gate applied first
    ],
)
def test_plain_gemm_matches_jax(rng, M, K, N, G, prologue):
    ref, out = _both(rng, M, K, N, G, prologue)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.parametrize(
    "M,K,N,prologue",
    # shapes no other test here traces: jit caches by shape, and the
    # interpret switch is read at trace time
    [(3, 640, 384, None), (6, 384, 640, "norm"), (7, 640, 256, "glu")],
)
def test_plain_gemm_matches_pallas_interpret(rng, monkeypatch, M, K, N, prologue):
    """The Pallas kernels themselves (interpret mode), prologues included."""
    monkeypatch.setenv("QUICK_TPU_PALLAS_INTERPRET", "1")
    ref, out = _both(rng, M, K, N, 128, prologue)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


def test_bias_and_leading_dims(rng):
    x, qw, s, zs = _case(rng, 6, 256, 128)
    bias = rng.standard_normal(128).astype(np.float32)
    jx, tx = bf16_pair(x.reshape(2, 3, 256))
    ref = jax_qmm(jx, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs),
                  bias=jnp.asarray(bias))
    out = tqmm.quantized_matmul(
        tx, torch.from_numpy(qw), torch.from_numpy(s), torch.from_numpy(zs),
        bias=torch.from_numpy(bias),
    )
    assert tuple(out.shape) == (2, 3, 128)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.parametrize(
    "M,K,N",
    [(1, 4096, 6144), (4, 4096, 4096), (4, 14336, 4096), (8, 4096, 28672),
     (512, 4096, 6144), (3, 256, 100)],
)
def test_launch_plan_covers_k(M, K, N):
    """Every group is covered exactly once by the split-K plan, and small
    output grids are split to fill the card (132 SMs): up to 8 rows (one
    8-token tile, at most 16 splits) to a block an SM where the groups and
    that cap allow, above (the wgmma body, up to 128 tokens a block) to at
    least half the blocks the card holds when the tiles fill no more."""
    rows, splits, gps = tqmm.launch_plan(M, K, N, 132)
    ng = K // 128
    assert rows >= M or rows == 128
    assert splits * gps >= ng and (splits - 1) * gps < ng
    tiles = math.ceil(N / 128) * math.ceil(M / rows)
    if M <= 8:
        assert rows == 8 and splits <= 16
        assert tiles * splits >= min(132, tiles * min(ng, 16))
    else:
        slots = 132 * tqmm.wgmma_blocks_per_sm(rows)
        assert 2 * tiles > slots or tiles * splits >= min(slots // 2, tiles * ng)
