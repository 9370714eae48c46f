"""The port's CUDA kernels (K1 GEMM with its prologues, K2 flash prefill,
also at DeepSeek's q / k 192, v 128, K3 fused decode step, K4 paged writes,
also of MLA's latent planes, K5 / K6 paged attention, K7 dense decode
attention, K8 grouped MoE GEMM at G = 128, 64 and 32, K4q INT8 paged writes,
K5q / K6q INT8 paged attention (K6q split, graphed), K9 small-group GEMM
(every decode row count, graphed), K10 / K10q paged MLA
decode attention, K11 / K11f W4A8 GEMM, K11f's quantization kernel, K12
grouped W4A8 MoE GEMM (on build_routing's layouts, at bm = 96, split,
graphed), K13 RMSNorm, K14 the decode layer tail) against
their plain PyTorch versions,
and the decode step replayed from a CUDA graph (generate() and the Engine)
against the eager step, on a card. Skipped without one. Imports no
JAX; on the card run:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``."""
import numpy as np
import pytest
import torch
from _torch_port import cuda_device, f32  # noqa: F401

import quick_tpu_torch.ops.decode_attention as tdda
import quick_tpu_torch.ops.flash_attention as tflash
import quick_tpu_torch.ops.fused_decode_step as tfused
import quick_tpu_torch.ops.mla_paged_attention as tmla
import quick_tpu_torch.ops.paged_attention as tpa
import quick_tpu_torch.ops.paged_write as tpw
import quick_tpu_torch.ops.quantized_matmul as tqmm
from quick_tpu_torch.modules.paged_cache import TRASH_PAGE, PagedKVCache
from quick_tpu_torch.ops.norms import rms_norm
from quick_tpu_torch.quantize.packing import pack_qtpu

# both sum in f32 in other orders and round the output to bf16; the
# attention kernels also round p against a running, not final, max
TOL = dict(atol=2e-2, rtol=2e-2)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi slopes 2^(-8 (i + 1) / n) for a power-of-two head count."""
    return 2.0 ** (-8.0 * np.arange(1, n_heads + 1, dtype=np.float32) / n_heads)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _gemm_case(rng, dev, M, K, N, prologue):
    x = rng.standard_normal((M, 2 * K if prologue == "glu" else K)).astype(np.float32)
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    s = (rng.uniform(size=(K // 128, N)) * 0.01 + 0.001).astype(np.float32)
    z = np.round(rng.uniform(size=(K // 128, N)) * 15).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (pack_qtpu(q), s, z * s)]
    kw = {}
    if prologue == "norm":
        w = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kw["fuse_norm"] = (torch.from_numpy(w).to(dev, torch.bfloat16), 1e-5)
    elif prologue == "glu":
        kw["fuse_glu"] = True
    return torch.from_numpy(x).to(dev, torch.bfloat16), args, kw


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,K,N,prologue",
    [(1, 4096, 6144, "norm"), (4, 4096, 4096, None), (4, 14336, 4096, "glu"),
     (8, 512, 384, "norm"), (64, 1024, 512, None), (3, 256, 200, None),
     (100, 512, 200, None)],  # tensor-core path with ragged rows and columns
)
def test_gemm_kernel_matches_plain(rng, cuda_device, M, K, N, prologue):
    x, args, kw = _gemm_case(rng, cuda_device, M, K, N, prologue)
    before = tqmm.KERNEL.launches
    out = tqmm.quantized_matmul(x, *args, **kw)
    torch.cuda.synchronize()
    assert tqmm.KERNEL.launches == before + 1
    cpu_kw = dict(kw)
    if "fuse_norm" in kw:
        cpu_kw["fuse_norm"] = (kw["fuse_norm"][0].cpu(), kw["fuse_norm"][1])
    ref = tqmm.quantized_matmul(x.cpu(), *(a.cpu() for a in args), **cpu_kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,K,N,G,prologue",
    [(1, 4096, 6144, 32, "norm"), (4, 4096, 4096, 32, None), (4, 14336, 4096, 32, "glu"),
     (8, 160, 200, 32, None),  # a last chunk of one group, ragged columns
     (16, 4096, 4096, 32, None), (128, 512, 384, 64, None),
     (100, 192, 200, 64, None),  # tensor-core path, ragged rows, columns and chunk
     (3, 2048, 2816, 64, None), (512, 2048, 6144, 64, None),
     (4, 2048, 576, 64, None), (512, 2048, 576, 64, None)],  # N = 4.5 tiles (kv_a)
)
def test_dequant_gemm_kernel_matches_plain(rng, cuda_device, M, K, N, G, prologue):
    """K9 (G = 32, 64) through quantized_matmul, prologues applied first as
    the JAX small-group branch does, against its plain version."""
    x = rng.standard_normal((M, 2 * K if prologue == "glu" else K)).astype(np.float32)
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    s = (rng.uniform(size=(K // G, N)) * 0.01 + 0.001).astype(np.float32)
    z = np.round(rng.uniform(size=(K // G, N)) * 15).astype(np.float32)
    args = [torch.from_numpy(a) for a in (pack_qtpu(q, G), s, z * s)]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kw = {}
    xp = xt
    if prologue == "norm":
        w = torch.from_numpy((1 + 0.1 * rng.standard_normal(K)).astype(np.float32))
        kw["fuse_norm"] = (w.to(cuda_device, torch.bfloat16), 1e-5)
        xp = rms_norm(xt, w.to(torch.bfloat16), 1e-5)
    elif prologue == "glu":
        kw["fuse_glu"] = True
        xp = tqmm.glu_plain(xt)
    before = (tqmm.KERNEL.launches, tqmm.KERNEL_DEQUANT.launches)
    out = tqmm.quantized_matmul(xt.to(cuda_device), *(a.to(cuda_device) for a in args),
                                group_size=G, **kw)
    torch.cuda.synchronize()
    assert (tqmm.KERNEL.launches, tqmm.KERNEL_DEQUANT.launches) == (before[0], before[1] + 1)
    ref = tqmm.quantized_matmul_dequant_plain(xp, *args, G)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    with pytest.raises(NotImplementedError, match="B11"):
        tqmm.quantized_matmul(xt.to(cuda_device)[:, :K], *(a.to(cuda_device) for a in args),
                              group_size=16)


ATTN_CASES = {
    "plain": {},
    "offset_kvlen": dict(q_offset=[16, 40], kv_len=[80, 104]),
    "window": dict(window=24),
    "softcap": dict(logit_softcap=20.0),
    "alibi": dict(alibi=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,D", [(c, 128) for c in ATTN_CASES] + [("plain", 64), ("offset_kvlen", 256)]
)
def test_flash_kernel_matches_plain(rng, cuda_device, case, D):
    B, S, T, Hq, Hkv = 2, 96, 256, 8, 2
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
        for shape in ((B, S, Hq, D), (B, Hkv, T, D), (B, Hkv, T, D))
    )
    kw = dict(ATTN_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    for key in ("q_offset", "kv_len"):
        if key in kw:
            kw[key] = torch.tensor(kw[key], dtype=torch.int32)
    before = tflash.KERNEL.launches
    out = tflash.flash_attention(
        q, k, v, kv_heads_major=True,
        **{key: (val.to(cuda_device) if torch.is_tensor(val) else val)
           for key, val in kw.items()},
    )
    torch.cuda.synchronize()
    assert tflash.KERNEL.launches == before + 1
    ref = tflash.flash_attention(q.cpu(), k.cpu(), v.cpu(), kv_heads_major=True, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "offset_kvlen"])
def test_flash_kernel_qk192_v128_matches_plain(rng, cuda_device, case):
    """K2 at DeepSeek's MLA expanded prefill widths: q / k 192, v 128."""
    B, S, T, Hq, Hkv = 2, 96, 256, 4, 4
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
        for shape in ((B, S, Hq, 192), (B, Hkv, T, 192), (B, Hkv, T, 128))
    )
    kw = {key: torch.tensor(val, dtype=torch.int32)
          for key, val in ATTN_CASES[case].items()}
    before = tflash.KERNEL.launches
    out = tflash.flash_attention(q, k, v, kv_heads_major=True, scale=0.11,
                                 **{key: val.to(cuda_device) for key, val in kw.items()})
    torch.cuda.synchronize()
    assert tflash.KERNEL.launches == before + 1 and out.shape == (B, S, Hq, 128)
    ref = tflash.flash_attention(q.cpu(), k.cpu(), v.cpu(), kv_heads_major=True, scale=0.11,
                                 **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


def _wgmma_case(dev, M, K, N, seed):
    """Random QTPU weights (full-range words: every code 0..15) and x on
    the card, from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qw = torch.randint(-2**31, 2**31, (K // 8, N), generator=gen, device=dev,
                       dtype=torch.int32)
    s = torch.rand((K // 128, N), generator=gen, device=dev) * 0.01 + 0.001
    z = torch.round(torch.rand((K // 128, N), generator=gen, device=dev) * 15)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    return x, qw, s, z * s


@pytest.mark.cuda
@pytest.mark.parametrize("K", [512, 4096, 14336])
@pytest.mark.parametrize("N", [200, 6144])
@pytest.mark.parametrize("M", [9, 16, 17, 63, 64, 65, 127, 128, 129, 4096])
def test_gemm_wgmma_body_matches_plain(cuda_device, M, K, N):
    """K1 above 8 rows (the wgmma body, every token width and split-K
    plan, ragged rows and columns) against its plain version on the card;
    a second launch is bit-equal to the first."""
    x, *args = _wgmma_case(cuda_device, M, K, N, seed=M * 7 + K + N)
    before = tqmm.KERNEL.launches
    out = tqmm.quantized_matmul(x, *args)
    again = tqmm.quantized_matmul(x, *args)
    ref = tqmm.quantized_matmul_plain(x, *args)
    torch.cuda.synchronize()
    assert tqmm.KERNEL.launches == before + 2
    assert torch.equal(out, again)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [130, 4098])
@pytest.mark.parametrize("M", [16, 512])
def test_gemm_wgmma_body_odd_n_matches_plain(cuda_device, M, N):
    """K1 above 8 rows at N % 4 == 2: the wrapper pads the weight to a
    multiple of 4 for the tensor copies and slices the output back; against
    the plain version on the unpadded weight."""
    x, *args = _wgmma_case(cuda_device, M, 4096, N, seed=M + N)
    before = tqmm.KERNEL.launches
    out = tqmm.quantized_matmul(x, *args)
    ref = tqmm.quantized_matmul_plain(x, *args)
    torch.cuda.synchronize()
    assert tqmm.KERNEL.launches == before + 1 and out.shape == (M, N) and out.is_contiguous()
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


FLASH_SHAPES = [64, 128, 256, (192, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", FLASH_SHAPES, ids=lambda d: "x".join(map(str, d)) if
                         isinstance(d, tuple) else str(d))
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("S", [1, 15, 17, 128, 1900])
def test_flash_tensor_core_matches_plain(rng, cuda_device, S, case, group, dims):
    """K2 (tensor-core body, GQA-packed rows) at every query length and
    mask case, Hq / Hkv in {1, 4, 8} and each head width, against its plain
    version on the card, within TOL and within TOL x the row's max|ref|; a
    second launch is bit-equal to the first."""
    D, Dv = dims if isinstance(dims, tuple) else (dims, dims)
    B, Hkv = 2, 2
    Hq, T = Hkv * group, 2048 if S > 256 else 256
    dev = cuda_device
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(np.float32)).to(
        dev, torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(
        dev, torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((B, Hkv, T, Dv)).astype(np.float32)).to(
        dev, torch.bfloat16)
    kw = dict(ATTN_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq)).to(dev)
    for key in ("q_offset", "kv_len"):
        if key in kw:
            kw[key] = torch.tensor(kw[key], dtype=torch.int32, device=dev)
    before = tflash.KERNEL.launches
    out = tflash.flash_attention(q, k, v, kv_heads_major=True, **kw)
    again = tflash.flash_attention(q, k, v, kv_heads_major=True, **kw)
    qoff = tflash._per_batch_i32(kw.get("q_offset", 0), B, dev)
    klen = torch.clamp(tflash._per_batch_i32(kw.get("kv_len", T), B, dev), max=T)
    ref = tflash.flash_attention_plain(
        q, k, v, qoff, klen, D ** -0.5, kw.get("alibi_slopes"), kw.get("window"),
        kw.get("logit_softcap"))
    torch.cuda.synchronize()
    assert tflash.KERNEL.launches == before + 2 and out.shape == (B, S, Hq, Dv)
    assert torch.equal(out, again)
    o, r = f32(out), f32(ref)
    np.testing.assert_allclose(o, r, **TOL)
    row_max = np.abs(r).max(axis=-1, keepdims=True)
    assert (np.abs(o - r) <= TOL["rtol"] * row_max).all()


@pytest.mark.cuda
def test_redesigned_wrappers_refuse(cuda_device):
    """K1 above 8 rows and K2 refuse CPU operands and shapes they do not
    take (a prologue above 8 rows, an unsupported head width); nothing
    falls back."""
    x = torch.zeros((16, 256), dtype=torch.bfloat16)
    w = torch.zeros((32, 128), dtype=torch.int32)
    s = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tqmm.quantized_matmul_cuda(x, w, s, s)
    wd = torch.zeros((32, 128), dtype=torch.int32, device=cuda_device)
    sd = torch.zeros((2, 128), device=cuda_device)
    with pytest.raises(ValueError, match="prologue takes at most 8 rows"):
        tqmm.quantized_matmul_cuda(x.to(cuda_device), wd, sd, sd,
                                   norm_weight=torch.ones(256, device=cuda_device))
    q = torch.zeros((1, 4, 2, 128), dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16)
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(q, kv, kv, i, i + 4, 0.1)
    q96 = torch.zeros((1, 4, 2, 96), dtype=torch.bfloat16, device=cuda_device)
    kv96 = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(NotImplementedError):
        tflash.flash_attention(q96, kv96, kv96, kv_heads_major=True)


FUSED_CASES = {
    "rope": {},
    "no_rope_alibi": dict(use_rope=False, alibi=True),
    "window_softcap": dict(window=100, logit_softcap=30.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,hq,hkv,D",
    [(c, 8, 2, 128) for c in FUSED_CASES]
    + [("rope", 16, 2, 64), ("window_softcap", 4, 4, 256)],  # 2 heads a warp; MHA
)
def test_fused_step_kernel_matches_plain(rng, cuda_device, case, hq, hkv, D):
    B, S, L, length = 2, 256, 2, 191
    bf = [
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
        for shape in ((B, hq, D), (B, hkv, D), (B, hkv, D),
                      (L, B, hkv, S, D), (L, B, hkv, S, D))
    ]
    ang = rng.uniform(0, 6.28, size=(B, D // 2)).astype(np.float32)
    cs = [torch.from_numpy(np.concatenate([f(ang)] * 2, -1)) for f in (np.cos, np.sin)]
    kw = dict(FUSED_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(hq))
    ln = torch.tensor([length], dtype=torch.int32)
    ref, kref, vref = tfused.fused_decode_attention(
        *bf[:3], bf[3].clone(), bf[4].clone(), *cs, ln, 1, **kw)
    dev = cuda_device
    kc, vc = bf[3].to(dev), bf[4].to(dev)
    out, _, _ = tfused.fused_decode_attention(
        *(a.to(dev) for a in bf[:3]), kc, vc, *(a.to(dev) for a in cs), ln.to(dev), 1,
        **{k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()})
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    # the roped k row may round one bf16 step apart (f32 fma contraction)
    np.testing.assert_allclose(f32(kc), f32(kref), atol=1e-2, rtol=1e-2)
    np.testing.assert_array_equal(f32(vc), f32(vref))


def _fused_case(B, hq, hkv, S, D, L=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bf = [torch.randn(shape, generator=gen).to(torch.bfloat16)
          for shape in ((B, hq, D), (B, hkv, D), (B, hkv, D),
                        (L, B, hkv, S, D), (L, B, hkv, S, D))]
    ang = torch.rand((B, D // 2), generator=gen) * 6.28
    cs = [torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)]
    return bf, cs


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,D", [(8, 8, 64), (32, 8, 128), (16, 2, 256)])  # gq 1, 4, 8
@pytest.mark.parametrize("S", [256, 1536])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_fused_step_split_kernel_matches_plain(cuda_device, B, S, hq, hkv, D):
    """K3 with its key range split over blocks, at lengths 0, 1, 63, 64, 65
    and S - 1 (tile and split edges, only the new token, the last row) and
    each of plain, window, softcap and ALiBi: the output within tolerance of
    the plain version on the same inputs, the cache changed at ``length``
    only, and two launches bit-equal (the merge's fixed split order)."""
    dev = cuda_device
    bf, cs = _fused_case(B, hq, hkv, S, D, seed=B * S + D)
    bf_dev = [a.to(dev) for a in bf[:3]]
    cs_dev = [a.to(dev) for a in cs]
    kinds = [{}, dict(window=100), dict(logit_softcap=30.0),
             dict(alibi_slopes=torch.from_numpy(alibi_slopes(hq)))]
    for i, length in enumerate((0, 1, 63, 64, 65, S - 1)):
        kw = kinds[i % len(kinds)]
        ln = torch.tensor([length], dtype=torch.int32)
        kref, vref = bf[3].clone(), bf[4].clone()
        ref, _, _ = tfused.fused_decode_attention(*bf[:3], kref, vref, *cs, ln, 1, **kw)
        kdev = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()}
        outs = []
        for _ in range(2):
            kc, vc = bf[3].to(dev), bf[4].to(dev)
            out, _, _ = tfused.fused_decode_attention(*bf_dev, kc, vc, *cs_dev, ln.to(dev), 1,
                                                      **kdev)
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), length
        np.testing.assert_allclose(f32(outs[0]), f32(ref), **TOL)
        np.testing.assert_allclose(f32(kc), f32(kref), atol=1e-2, rtol=1e-2)
        np.testing.assert_array_equal(f32(vc), f32(vref))


@pytest.mark.cuda
def test_fused_step_graph_replays_at_moving_lengths(cuda_device):
    """A captured K3 launch, replayed while the length on the card moves to
    three values, equals the eager launches at those lengths (outputs and
    caches bit for bit): the split plan and the merge counters hold under
    replay."""
    dev = cuda_device
    B, hq, hkv, S, D = 4, 32, 8, 256, 128
    bf, cs = _fused_case(B, hq, hkv, S, D, seed=7)
    q, kn, vn = (a.to(dev) for a in bf[:3])
    c, s = (a.to(dev) for a in cs)
    length = torch.tensor([5], dtype=torch.int32, device=dev)
    kg, vg = bf[3].to(dev), bf[4].to(dev)
    tfused.fused_decode_attention(q, kn, vn, kg.clone(), vg.clone(), c, s, length, 1)  # eager first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g, _, _ = tfused.fused_decode_attention(q, kn, vn, kg, vg, c, s, length, 1)
    for ln in (63, 64, 191):
        ke, ve = kg.clone(), vg.clone()
        length.fill_(ln)
        graph.replay()
        out_e, _, _ = tfused.fused_decode_attention(q, kn, vn, ke, ve, c, s, length, 1)
        torch.cuda.synchronize()
        assert torch.equal(out_g, out_e), ln
        assert torch.equal(kg, ke) and torch.equal(vg, ve), ln


@pytest.mark.cuda
def test_wrappers_refuse_cpu_tensors(cuda_device):
    """A CUDA wrapper never falls back: CPU operands are refused."""
    x = torch.zeros((1, 256), dtype=torch.bfloat16)
    w = torch.zeros((32, 128), dtype=torch.int32)
    s = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tqmm.quantized_matmul_cuda(x, w, s, s)


def _pages(rng, L, P, Hkv, page, D, dtype=torch.bfloat16):
    return [torch.from_numpy(rng.standard_normal((L, P, Hkv, page, D)).astype(np.float32)).to(dtype)
            for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_write_kernel_matches_plain(rng, cuda_device, dtype):
    """K4's decode and chunk entries write exactly the plain scatter's rows
    (page 0, the trash page, may take colliding writes and is not compared)."""
    L, P, Hkv, page, D, B, S = 2, 9, 2, 16, 128, 3, 8
    for entry in ("decode", "chunk"):
        kp, vp = _pages(rng, L, P, Hkv, page, D, dtype)
        n = 1 if entry == "decode" else S
        kn, vn = (torch.from_numpy(rng.standard_normal((B, n, Hkv, D)).astype(np.float32))
                  for _ in range(2))
        pgs = torch.tensor([[3, 4], [5, 0], [0, 0]], dtype=torch.int32)
        offs = torch.tensor([12, 2, 9], dtype=torch.int32)  # crossing, inside, trash
        valid = torch.tensor([S, 5, S], dtype=torch.int32)
        ref = [t.clone() for t in (kp, vp)]
        got = [t.to(cuda_device) for t in (kp, vp)]
        before = tpw.KERNEL.launches_by_key.copy()
        if entry == "decode":
            tpw.paged_write_decode(*ref, kn[:, 0], vn[:, 0], pgs[:, 0], offs, 1)
            tpw.paged_write_decode(*got, kn[:, 0].to(cuda_device), vn[:, 0].to(cuda_device),
                                   pgs[:, 0].to(cuda_device), offs.to(cuda_device), 1)
        else:
            tpw.paged_write_chunk(*ref, kn, vn, pgs, offs, valid, 1)
            tpw.paged_write_chunk(*got, kn.to(cuda_device), vn.to(cuda_device),
                                  pgs.to(cuda_device), offs.to(cuda_device),
                                  valid.to(cuda_device), 1)
        torch.cuda.synchronize()
        assert sum(tpw.KERNEL.launches_by_key.values()) == sum(before.values()) + 1
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(f32(g[:, 1:]), f32(r[:, 1:]))


def _paged_attention_case(rng, dev, B, Hq, Hkv, D, page, n_pt, per_slot, S=None):
    P = 1 + B * n_pt
    kp, vp = _pages(rng, 2, P, Hkv, page, D)
    bt = torch.from_numpy(rng.permutation(np.arange(1, P))[: B * n_pt].reshape(B, n_pt).astype(np.int32))
    qshape = (B, Hq, D) if S is None else (B, S, Hq, D)
    q = torch.from_numpy(rng.standard_normal(qshape).astype(np.float32)).to(torch.bfloat16)
    ln = torch.tensor(per_slot, dtype=torch.int32)
    cpu = (q, kp, vp, bt, ln)
    return cpu, tuple(t.to(dev) for t in cpu)


PAGED_CASES = {
    "plain": {}, "window": dict(window=20), "softcap": dict(logit_softcap=20.0),
    "alibi": dict(alibi=True), "window_softcap": dict(window=40, logit_softcap=30.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,Hq,Hkv,D", [(c, 8, 2, 128) for c in PAGED_CASES]
    + [("plain", 32, 8, 128), ("plain", 4, 4, 64), ("window", 16, 2, 256)],
)
def test_paged_decode_kernel_matches_plain(rng, cuda_device, case, Hq, Hkv, D):
    cpu, gpu = _paged_attention_case(rng, cuda_device, 4, Hq, Hkv, D, 16, 6,
                                     [1, 37, 96, 64])  # 96 fills the table
    kw = dict(PAGED_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    before = tpa.KERNEL.launches
    out = tpa.paged_decode_attention(*gpu, layer=1, **kw)
    torch.cuda.synchronize()
    assert tpa.KERNEL.launches == before + 1
    ref = tpa.paged_decode_attention(*cpu, layer=1, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,Hq,Hkv,D", [(c, 8, 2, 128) for c in PAGED_CASES]
    + [("plain", 32, 8, 128), ("plain", 4, 4, 64), ("softcap", 16, 2, 256)],
)
def test_paged_chunk_kernel_matches_plain(rng, cuda_device, case, Hq, Hkv, D):
    S = 16
    # starts: fresh, mid-page, crossing a page boundary, ending at the table
    cpu, gpu = _paged_attention_case(rng, cuda_device, 4, Hq, Hkv, D, 16, 6,
                                     [0, 21, 40, 80], S=S)
    kw = dict(PAGED_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    out = tpa.paged_chunk_attention(*gpu, layer=1, **kw)
    torch.cuda.synchronize()
    ref = tpa.paged_chunk_attention(*cpu, layer=1, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
def test_paged_cache_update_routes_match_cpu(rng, cuda_device):
    """PagedKVCache.update on the card (K4 decode and chunk entries) leaves
    the pages as the CPU scatter does, past-max_seq positions included."""
    caches = [PagedKVCache.create(2, 9, 16, 2, 64, 2, 128, device=d) for d in ("cpu", cuda_device)]
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    steps = [(8, [0, 9]), (8, [20, 12]), (1, [13, 63]), (1, [14, 64]), (6, [61, 100])]
    for c in caches:
        c.block_table.copy_(bt)
    for S, starts in steps:
        kn, vn = (torch.from_numpy(rng.standard_normal((2, S, 2, 128)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(2))
        for c in caches:
            d = c.k_pages.device
            c.update(1, kn.to(d), vn.to(d), torch.tensor(starts, dtype=torch.int32, device=d))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(f32(caches[1].k_pages[:, 1:]), f32(caches[0].k_pages[:, 1:]))
    np.testing.assert_array_equal(f32(caches[1].v_pages[:, 1:]), f32(caches[0].v_pages[:, 1:]))



def _int8_pages(rng, L, P, Hkv, page, D):
    """INT8 pages and their [L, P, 8, Hkv*page] scale tiles, quantized from
    random float pages as PagedKVCache writes them."""
    kp, vp = _pages(rng, L, P, Hkv, page, D, torch.float32)
    (kc, ks), (vc, vs) = tpw.quantize_kv(kp), tpw.quantize_kv(vp)
    tiles = torch.zeros((L, P, 8, Hkv * page))
    tiles[:, :, 0] = ks.reshape(L, P, -1)
    tiles[:, :, 1] = vs.reshape(L, P, -1)
    return kc, vc, tiles


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["bf16", "f32", "int8_codes"])
def test_paged_write_int8_kernel_matches_plain(rng, cuda_device, rows):
    """K4q's decode and chunk entries leave codes and scale tiles byte-equal
    to the plain version: float rows quantized in the kernel (bf16 or f32),
    or int8 codes with their scales copied; page-crossing, masked and
    trash-page writes (page 0 is not compared)."""
    L, P, Hkv, page, D, B, S = 2, 9, 8, 64, 128, 3, 16
    for entry in ("decode", "chunk"):
        pages = list(_int8_pages(rng, L, P, Hkv, page, D))
        n = 1 if entry == "decode" else S
        kn, vn = (torch.from_numpy((rng.standard_normal((B, n, Hkv, D)) * 3).astype(np.float32))
                  for _ in range(2))
        extra = {}
        if rows == "bf16":
            kn, vn = kn.to(torch.bfloat16), vn.to(torch.bfloat16)
        elif rows == "int8_codes":
            (kn, ks), (vn, vs) = tpw.quantize_kv(kn), tpw.quantize_kv(vn)
            extra = dict(ks_new=ks, vs_new=vs)
        pgs = torch.tensor([[3, 4], [5, 0], [0, 0]], dtype=torch.int32)
        offs = torch.tensor([60, 2, 9], dtype=torch.int32)  # crossing, inside, trash
        valid = torch.tensor([S, 5, S], dtype=torch.int32)
        ref = [t.clone() for t in pages]
        got = [t.to(cuda_device) for t in pages]
        dev = {k: v.to(cuda_device) for k, v in extra.items()}
        before = tpw.KERNEL_INT8.launches
        if entry == "decode":
            sel = {k: v[:, 0] for k, v in extra.items()}
            tpw.paged_write_decode(*ref[:2], kn[:, 0], vn[:, 0], pgs[:, 0], offs, 1,
                                   kv_scales=ref[2], **sel)
            tpw.paged_write_decode(*got[:2], kn[:, 0].to(cuda_device), vn[:, 0].to(cuda_device),
                                   pgs[:, 0].to(cuda_device), offs.to(cuda_device), 1,
                                   kv_scales=got[2], **{k: v[:, 0] for k, v in dev.items()})
        else:
            tpw.paged_write_chunk(*ref[:2], kn, vn, pgs, offs, valid, 1, kv_scales=ref[2], **extra)
            tpw.paged_write_chunk(*got[:2], kn.to(cuda_device), vn.to(cuda_device),
                                  pgs.to(cuda_device), offs.to(cuda_device),
                                  valid.to(cuda_device), 1, kv_scales=got[2], **dev)
        torch.cuda.synchronize()
        assert tpw.KERNEL_INT8.launches == before + 1
        for r, g in zip(ref, got):
            assert torch.equal(g[:, 1:].cpu(), r[:, 1:])


def _int8_attention_case(rng, dev, B, Hq, Hkv, D, page, n_pt, per_slot, S=None):
    P = 1 + B * n_pt
    kc, vc, tiles = _int8_pages(rng, 2, P, Hkv, page, D)
    bt = torch.from_numpy(rng.permutation(np.arange(1, P))[: B * n_pt].reshape(B, n_pt).astype(np.int32))
    qshape = (B, Hq, D) if S is None else (B, S, Hq, D)
    q = torch.from_numpy(rng.standard_normal(qshape).astype(np.float32)).to(torch.bfloat16)
    cpu = (q, kc, vc, bt, torch.tensor(per_slot, dtype=torch.int32))
    return cpu, tuple(t.to(dev) for t in cpu), tiles


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,Hq,Hkv,D", [(c, 8, 2, 128) for c in PAGED_CASES]
    + [("plain", 32, 8, 128), ("plain", 4, 4, 64), ("window", 16, 2, 256)],
)
def test_paged_decode_int8_kernel_matches_plain(rng, cuda_device, case, Hq, Hkv, D):
    """K5q (q and p quantized in the kernel, dp4a dots) against the plain
    version of the Pallas INT8 arithmetic; ragged lengths, one slot of 1."""
    cpu, gpu, tiles = _int8_attention_case(rng, cuda_device, 4, Hq, Hkv, D, 32, 6,
                                           [1, 37, 192, 100])  # 192 fills the table
    kw = dict(PAGED_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    before = tpa.KERNEL_INT8.launches
    out = tpa.paged_decode_attention(*gpu, layer=1, kv_scales=tiles.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert tpa.KERNEL_INT8.launches == before + 1
    ref = tpa.paged_decode_attention(*cpu, layer=1, kv_scales=tiles, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,Hq,Hkv,D", [(c, 8, 2, 128) for c in PAGED_CASES]
    + [("plain", 32, 8, 128), ("plain", 4, 4, 64), ("softcap", 16, 2, 256)],
)
def test_paged_chunk_int8_kernel_matches_plain(rng, cuda_device, case, Hq, Hkv, D):
    S = 16
    # starts: fresh, mid-page, crossing a page boundary, ending at the table
    cpu, gpu, tiles = _int8_attention_case(rng, cuda_device, 4, Hq, Hkv, D, 32, 6,
                                           [0, 21, 56, 176], S=S)
    kw = dict(PAGED_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    before = tpa.KERNEL_INT8.launches
    out = tpa.paged_chunk_attention(*gpu, layer=1, kv_scales=tiles.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert tpa.KERNEL_INT8.launches == before + 1
    ref = tpa.paged_chunk_attention(*cpu, layer=1, kv_scales=tiles, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
def test_paged_cache_int8_update_routes_match_cpu(rng, cuda_device):
    """PagedKVCache(int8).update on the card (K4q's decode and chunk
    entries, a 40-token chunk through the scatter) leaves codes and scale
    tiles byte-equal to the CPU's quantize + scatter, past-max_seq
    positions included."""
    caches = [PagedKVCache.create(2, 9, 32, 2, 128, 2, 128, torch.int8, device=d)
              for d in ("cpu", cuda_device)]
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    steps = [(8, [0, 9]), (16, [28, 60]), (1, [13, 127]), (1, [14, 128]), (6, [125, 200]),
             (40, [30, 70])]
    for c in caches:
        c.block_table.copy_(bt)
    before = tpw.KERNEL_INT8.launches
    for S, starts in steps:
        kn, vn = (torch.from_numpy(rng.standard_normal((2, S, 2, 128)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(2))
        for c in caches:
            d = c.k_pages.device
            c.update(1, kn.to(d), vn.to(d), torch.tensor(starts, dtype=torch.int32, device=d))
    torch.cuda.synchronize()
    assert tpw.KERNEL_INT8.launches == before + 5  # the 40-token chunk is scattered
    for name in ("k_pages", "v_pages", "kv_scales"):
        assert torch.equal(getattr(caches[1], name)[:, 1:].cpu(), getattr(caches[0], name)[:, 1:])


DENSE_CASES = {
    # the 128/128 protocol's decode, one long-context stream, ragged rows
    # with a length-1 row, and softcap + ALiBi
    "protocol": (32, 256, lambda rng, B: rng.integers(129, 256, B)),
    "long_stream": (4, 2048, lambda rng, B: 1900 + rng.integers(-8, 8, B)),
    "ragged": (64, 256, lambda rng, B: np.concatenate([[1, 0, 256], rng.integers(1, 257, B - 3)])),
    "softcap_alibi": (32, 256, lambda rng, B: rng.integers(129, 256, B)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_decode_kernel_matches_plain(rng, cuda_device, case):
    """K7 over layer 1 of a 2-layer [L, B, Hkv, T, D] stack at Mistral-7B
    heads (Hq=32, Hkv=8, D=128), lengths on the card."""
    B, T, lens = DENSE_CASES[case]
    Hq, Hkv, D = 32, 8, 128
    lengths = torch.from_numpy(lens(rng, B).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(torch.bfloat16)
    k, v = [torch.from_numpy(rng.standard_normal((2, B, Hkv, T, D)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2)]
    kw = {}
    if case == "softcap_alibi":
        kw = dict(logit_softcap=30.0, alibi_slopes=torch.from_numpy(alibi_slopes(Hq)))
    before = tdda.KERNEL.launches
    out = tdda.dense_decode_attention(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
                                      lengths.to(cuda_device), layer=1, **kw)
    torch.cuda.synchronize()
    assert tdda.KERNEL.launches == before + 1
    ref = tdda.dense_decode_attention(q, k, v, lengths, layer=1, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    # scaled to each query row's output: a long row's values are ~0.03,
    # where the absolute part of TOL alone would pass a wrong softmax
    row_max = np.abs(f32(ref)).max(axis=-1, keepdims=True)
    assert (np.abs(f32(out) - f32(ref)) <= TOL["rtol"] * row_max).all()
    if case == "ragged":
        assert not f32(out)[1].any()  # the length-0 row


#: (bm, tile experts, live flags, N): 32-row blocks, 64-row blocks over
#: 64- and 128-row tiles, a ragged N; expert 2 of 4 gets no tile, the last
#: tiles are dead
GROUPED_CASES = {
    "bm32": (32, [0, 0, 1, 3, 3, 3], [1, 1, 1, 1, 1, 0], 384),
    "bm64": (64, [1, 3, 3, 3], [1, 1, 0, 0], 256),
    "bm128_ragged_n": (128, [0, 3, 3], [1, 1, 1], 200),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_kernel_matches_plain(rng, cuda_device, case):
    """K8 against its plain version: every tile with its own expert, dead
    tiles all zeros; group sizes K8 is not built for raise on the card
    (B11)."""
    import quick_tpu_torch.ops.grouped_matmul as tgm

    bm, te, live, N = GROUPED_CASES[case]
    E, K = 4, 512
    q = rng.integers(0, 16, size=(E, K, N), dtype=np.uint8)
    qw = np.stack([pack_qtpu(q[e]) for e in range(E)])
    s = (rng.uniform(size=(E, K // 128, N)) * 0.01 + 0.001).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // 128, N)) * 15) * s).astype(np.float32)
    x = rng.standard_normal((len(te) * bm, K)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, qw, s, zs, np.asarray(te, np.int32),
                                          np.asarray(live, np.int32))]
    args[0] = args[0].to(torch.bfloat16)
    before = tgm.KERNEL.launches
    out = tgm.quantized_matmul_grouped(*(a.to(cuda_device) for a in args), bm)
    torch.cuda.synchronize()
    assert tgm.KERNEL.launches == before + 1
    ref = tgm.quantized_matmul_grouped(*args, bm)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    dead = np.repeat(np.asarray(live) == 0, bm)
    assert not f32(out)[dead].any()
    with pytest.raises(NotImplementedError, match="B11"):
        tgm.quantized_matmul_grouped(*(a.to(cuda_device) for a in args), bm, group_size=16)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [64, 32])
@pytest.mark.parametrize("case,K", [("bm32", 512), ("bm64", 512), ("bm32", 320)])
def test_grouped_kernel_small_group_matches_plain(rng, cuda_device, G, case, K):
    """K8 at G = 64 and 32 (the output-side form of _grouped_fallback)
    against its plain version; K = 320 ends on a part-filled chunk of 128."""
    import quick_tpu_torch.ops.grouped_matmul as tgm

    bm, te, live, N = GROUPED_CASES[case]
    E = 4
    q = rng.integers(0, 16, size=(E, K, N), dtype=np.uint8)
    qw = np.stack([pack_qtpu(q[e], G) for e in range(E)])
    s = (rng.uniform(size=(E, K // G, N)) * 0.01 + 0.001).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // G, N)) * 15) * s).astype(np.float32)
    x = rng.standard_normal((len(te) * bm, K)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, qw, s, zs, np.asarray(te, np.int32),
                                          np.asarray(live, np.int32))]
    args[0] = args[0].to(torch.bfloat16)
    before = tgm.KERNEL.launches
    out = tgm.quantized_matmul_grouped(*(a.to(cuda_device) for a in args), bm, group_size=G)
    torch.cuda.synchronize()
    assert tgm.KERNEL.launches == before + 1
    ref = tgm.quantized_matmul_grouped(*args, bm, group_size=G)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    assert not f32(out)[np.repeat(np.asarray(live) == 0, bm)].any()


def _grouped_weights(rng, E, K, N, G):
    q = rng.integers(0, 16, size=(E, K, N), dtype=np.uint8)
    qw = np.stack([pack_qtpu(q[e], G) for e in range(E)])
    s = (rng.uniform(size=(E, K // G, N)) * 0.01 + 0.001).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // G, N)) * 15) * s).astype(np.float32)
    return [torch.from_numpy(a) for a in (qw, s, zs)]


#: (token expert choices, E, bm, K, N): build_routing's layouts. The decode
#: branch with expert 0 chosen by three tokens and expert 1 by two (one
#: pass of two tiles, then one more), the sorted branch with dead tiles at
#: bm 32, 64 and 128, an odd N (padded at the call), and a width whose
#: (column tile, expert) blocks fill the card (no split of K: the block
#: body writes bf16 and zeros its dead tiles itself)
GROUPED_ROUTES = {
    "decode_duplicates": ([[0, 1], [0, 2], [3, 1], [0, 5]], 8, 32, 512, 384),
    "sorted_bm32_dead": (None, 8, 32, 384, 256),
    "sorted_bm64_dead": (None, 8, 64, 256, 200),
    "sorted_bm128_dead": (None, 4, 128, 256, 256),
    "odd_n": ([[0, 1], [0, 2], [1, 3]], 4, 32, 256, 203),
    "unsplit_wide": (None, 8, 32, 256, 8448),
}


def _grouped_route_case(rng, name, G):
    import quick_tpu_torch.ops.grouped_matmul as tgm

    sel, E, bm, K, N = GROUPED_ROUTES[name]
    if sel is None:
        T = {32: 24, 64: 100, 128: 200}[bm]
        sel = np.argsort(rng.uniform(size=(T, E)), axis=1)[:, :2]
    sel = torch.as_tensor(np.asarray(sel), dtype=torch.int64)
    _, _, te, live, _ = tgm.build_routing(sel, E, bm)
    x = torch.from_numpy(rng.standard_normal((te.shape[0] * bm, K)).astype(np.float32))
    return [x.to(torch.bfloat16), *_grouped_weights(rng, E, K, N, G), te, live], bm


@pytest.mark.cuda
@pytest.mark.parametrize("G", [128, 64, 32])
@pytest.mark.parametrize("name", list(GROUPED_ROUTES))
def test_grouped_routes_match_plain(rng, cuda_device, name, G):
    """K8 against its plain version on build_routing's layouts, the whole
    output compared (padding rows and dead tiles included), one launch a
    call; a bm K8 cannot take raises, naming QUICK_TPU_MOE_BM."""
    import quick_tpu_torch.ops.grouped_matmul as tgm

    args, bm = _grouped_route_case(rng, name, G)
    te, live = args[4], args[5]
    if name.startswith("decode"):
        assert int(torch.bincount(te).max()) >= 2  # an expert chosen by several tokens
    if "dead" in name:
        assert not bool(live.all())
    before = tgm.KERNEL.launches
    out = tgm.quantized_matmul_grouped(*(a.to(cuda_device) for a in args), bm, group_size=G)
    torch.cuda.synchronize()
    assert tgm.KERNEL.launches == before + 1
    ref = tgm.quantized_matmul_grouped(*args, bm, group_size=G)
    assert out.shape == ref.shape
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    assert not f32(out)[np.repeat(live.numpy() == 0, bm)].any()
    with pytest.raises(ValueError, match="QUICK_TPU_MOE_BM"):
        tgm.quantized_matmul_grouped(*(a.to(cuda_device) for a in args[:4]),
                                     torch.zeros(args[0].shape[0] // 16, dtype=torch.int32,
                                                 device=cuda_device),
                                     torch.ones(args[0].shape[0] // 16, dtype=torch.int32,
                                                device=cuda_device), 16, group_size=G)


@pytest.mark.cuda
def test_grouped_graph_replays_after_routing_moves(rng, cuda_device):
    """K8 captured in a CUDA graph, then replayed after the routing (tile
    experts, live flags) and the rows changed in place: equal to an eager
    launch on the new routing, bit for bit."""
    import quick_tpu_torch.ops.grouped_matmul as tgm

    E, bm, K, N = 8, 32, 512, 256
    w = [t.to(cuda_device) for t in _grouped_weights(rng, E, K, N, 128)]

    def layout(seed):
        g = torch.Generator().manual_seed(seed)
        sel = torch.argsort(torch.rand((4, E), generator=g), dim=1)[:, :2]
        _, _, te, live, _ = tgm.build_routing(sel, E, bm)
        x = torch.randn((te.shape[0] * bm, K), generator=g).to(torch.bfloat16)
        return x.to(cuda_device), te.to(cuda_device), live.to(cuda_device)

    x, te, live = layout(0)
    out = tgm.quantized_matmul_grouped(x, *w, te, live, bm)  # eager first: builds, allocates
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tgm.quantized_matmul_grouped(x, *w, te, live, bm)
    for seed in (1, 2):
        x2, te2, live2 = layout(seed)
        x.copy_(x2)
        te.copy_(te2)
        live.copy_(live2)
        graph.replay()
        torch.cuda.synchronize()
        want = tgm.quantized_matmul_grouped(x2, *w, te2, live2, bm)
        np.testing.assert_array_equal(f32(out), f32(want))


#: (window, softcap, ALiBi) cases of K5 at the lengths the split walks:
#: none, one key, a page but one, a page, the whole table
K5_EDGE_CASES = {
    "plain": {}, "window": dict(window=20), "softcap": dict(logit_softcap=30.0),
    "alibi": dict(alibi=True), "all": dict(window=40, logit_softcap=30.0, alibi=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_EDGE_CASES))
@pytest.mark.parametrize("Hq,Hkv,D,page,n_pt", [(32, 8, 128, 64, 16), (8, 2, 64, 16, 6),
                                                (32, 1, 256, 16, 8)])
def test_paged_decode_split_kernel_edges(rng, cuda_device, case, Hq, Hkv, D, page, n_pt):
    """K5 split over blocks against its plain version (gather + einsum) and
    its split model, at lengths 0, 1, page - 1, page and n_pt * page."""
    lengths = [0, 1, page - 1, page, n_pt * page]
    cpu, gpu = _paged_attention_case(rng, cuda_device, len(lengths), Hq, Hkv, D, page, n_pt,
                                     lengths)
    kw = dict(K5_EDGE_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    before = tpa.KERNEL.launches
    out = tpa.paged_decode_attention(*gpu, layer=1, **kw)
    torch.cuda.synchronize()
    assert tpa.KERNEL.launches == before + 1
    ref = tpa.paged_decode_attention(*cpu, layer=1, **kw)
    np.testing.assert_allclose(f32(out)[1:], f32(ref)[1:], **TOL)
    assert not f32(out)[0].any()  # length 0: no visible key
    chunk, splits = tpa.split_plan(len(lengths), Hkv, Hq // Hkv, n_pt * page,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
    model = tpa.paged_decode_attention_split_plain(
        *(t.to(cuda_device) for t in cpu), 1, D ** -0.5, chunk=chunk, splits=splits,
        **{k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
    np.testing.assert_allclose(f32(out), f32(model), **TOL)


@pytest.mark.cuda
def test_paged_decode_graph_replays_at_moving_lengths(rng, cuda_device):
    """K5 captured in a CUDA graph and replayed after the lengths moved in
    place: equal to eager launches at those lengths, bit for bit (the
    merge counters are left at zero by every launch)."""
    Hq, Hkv, D, page, n_pt = 32, 8, 128, 64, 16
    cpu, gpu = _paged_attention_case(rng, cuda_device, 16, Hq, Hkv, D, page, n_pt,
                                     [1 + 37 * i for i in range(16)])
    q, kp, vp, bt, ln = gpu
    out = tpa.paged_decode_attention(q, kp, vp, bt, ln, layer=1)  # eager: makes the counters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_decode_attention(q, kp, vp, bt, ln, layer=1)
    for shift in (5, 300, 0):
        new = torch.tensor([min(n_pt * page, 1 + 37 * i + shift) for i in range(16)],
                           dtype=torch.int32, device=cuda_device)
        ln.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = tpa.paged_decode_attention(q, kp, vp, bt, new.clone(), layer=1)
        np.testing.assert_array_equal(f32(out), f32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_EDGE_CASES))
@pytest.mark.parametrize("Hq,Hkv,D,page,n_pt", [(32, 1, 256, 16, 8), (32, 8, 128, 64, 16),
                                                (8, 2, 64, 16, 6)])
def test_paged_chunk_split_kernel_edges(rng, cuda_device, case, Hq, Hkv, D, page, n_pt):
    """K6 split over blocks against its plain version (gather + einsum) and
    its split model, with 16-query chunks starting fresh, crossing a page,
    on a page boundary, and ending at the table; gq = 32 at D = 256 (eight
    64-row blocks a kv head)."""
    S, T = 16, n_pt * page
    starts = [0, page - 5, page, T - S]
    cpu, gpu = _paged_attention_case(rng, cuda_device, len(starts), Hq, Hkv, D, page, n_pt,
                                     starts, S=S)
    kw = dict(K5_EDGE_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    before = tpa.KERNEL.launches
    out = tpa.paged_chunk_attention(*gpu, layer=1, **kw)
    torch.cuda.synchronize()
    assert tpa.KERNEL.launches == before + 1
    ref = tpa.paged_chunk_attention(*cpu, layer=1, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    chunk, splits = tpa.chunk_split_plan(len(starts), Hkv, S, Hq // Hkv, T,
                                         torch.cuda.get_device_properties(0).multi_processor_count)
    model = tpa.paged_chunk_attention_split_plain(
        *(t.to(cuda_device) for t in cpu), 1, D ** -0.5, chunk=chunk, splits=splits,
        **{k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
    np.testing.assert_allclose(f32(out), f32(model), **TOL)


@pytest.mark.cuda
def test_paged_chunk_graph_replays_at_moving_starts(rng, cuda_device):
    """K6 captured in a CUDA graph and replayed after the starts moved in
    place: equal to eager launches at those starts, bit for bit (the merge
    counters are left at zero by every launch)."""
    Hq, Hkv, D, page, n_pt, S = 32, 8, 128, 64, 16, 16
    cpu, gpu = _paged_attention_case(rng, cuda_device, 8, Hq, Hkv, D, page, n_pt,
                                     [37 * i for i in range(8)], S=S)
    q, kp, vp, bt, st = gpu
    out = tpa.paged_chunk_attention(q, kp, vp, bt, st, layer=1)  # eager: makes the counters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_chunk_attention(q, kp, vp, bt, st, layer=1)
    for shift in (5, 300, 0):
        new = torch.tensor([min(n_pt * page - S, 37 * i + shift) for i in range(8)],
                           dtype=torch.int32, device=cuda_device)
        st.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = tpa.paged_chunk_attention(q, kp, vp, bt, new.clone(), layer=1)
        np.testing.assert_array_equal(f32(out), f32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_EDGE_CASES))
@pytest.mark.parametrize("Hq,Hkv,D,page,n_pt", [(32, 1, 256, 16, 8), (32, 8, 128, 64, 16),
                                                (8, 2, 64, 16, 6), (8, 8, 64, 16, 6)])
def test_paged_chunk_int8_split_kernel_edges(rng, cuda_device, case, Hq, Hkv, D, page, n_pt):
    """K6q (K6's key-split kernel over INT8 pages) against its plain version
    (the Pallas INT8 arithmetic page by page) and K6's split model with the
    scale tiles, with 16-query chunks starting fresh, crossing a page, on a
    page boundary and ending at the table; gq = 32 at D = 256, gq 4 and 1."""
    S, T = 16, n_pt * page
    starts = [0, page - 5, page, T - S]
    cpu, gpu, tiles = _int8_attention_case(rng, cuda_device, len(starts), Hq, Hkv, D, page,
                                           n_pt, starts, S=S)
    kw = dict(K5_EDGE_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(Hq))
    before = tpa.KERNEL_INT8.launches
    out = tpa.paged_chunk_attention(*gpu, layer=1, kv_scales=tiles.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert tpa.KERNEL_INT8.launches == before + 1
    ref = tpa.paged_chunk_attention(*cpu, layer=1, kv_scales=tiles, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    chunk, splits = tpa.chunk_split_plan(len(starts), Hkv, S, Hq // Hkv, T,
                                         torch.cuda.get_device_properties(0).multi_processor_count)
    model = tpa.paged_chunk_attention_split_plain(
        *(t.to(cuda_device) for t in cpu), 1, D ** -0.5, chunk=chunk, splits=splits,
        kv_scales=tiles.to(cuda_device),
        **{k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
    np.testing.assert_allclose(f32(out), f32(model), **TOL)


@pytest.mark.cuda
def test_paged_chunk_int8_graph_replays_at_moving_starts(rng, cuda_device):
    """K6q captured in a CUDA graph and replayed after the starts moved in
    place: equal to eager launches at those starts, bit for bit."""
    Hq, Hkv, D, page, n_pt, S = 32, 8, 128, 64, 16, 16
    cpu, gpu, tiles = _int8_attention_case(rng, cuda_device, 8, Hq, Hkv, D, page, n_pt,
                                           [37 * i for i in range(8)], S=S)
    q, kp, vp, bt, st = gpu
    tiles = tiles.to(cuda_device)
    out = tpa.paged_chunk_attention(q, kp, vp, bt, st, layer=1, kv_scales=tiles)  # eager
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_chunk_attention(q, kp, vp, bt, st, layer=1, kv_scales=tiles)
    for shift in (5, 300, 0):
        new = torch.tensor([min(n_pt * page - S, 37 * i + shift) for i in range(8)],
                           dtype=torch.int32, device=cuda_device)
        st.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = tpa.paged_chunk_attention(q, kp, vp, bt, new.clone(), layer=1, kv_scales=tiles)
        np.testing.assert_array_equal(f32(out), f32(want))


# ---------------------------------------------------------- MLA latent pages

def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_latent_page_writes_match_plain(rng, cuda_device, pages):
    """K4 / K4q on MLA's latent planes (one kv head, k_pe 64 wide, the latent
    512): decode and chunk writes leave pages (codes) and scale tiles
    byte-equal to the plain scatter (page 0, the trash page, not compared)."""
    L, P, page, B, S = 2, 9, 64, 3, 16
    for entry in ("decode", "chunk"):
        if pages == "int8":
            kc, ks = tpw.quantize_kv(_randn(rng, L, P, 1, page, 64))
            vc, vs = tpw.quantize_kv(_randn(rng, L, P, 1, page, 512))
            tiles = torch.zeros((L, P, 8, page))
            tiles[:, :, 0], tiles[:, :, 1] = ks.reshape(L, P, -1), vs.reshape(L, P, -1)
            state = [kc, vc, tiles]
        else:
            state = [_randn(rng, L, P, 1, page, 64).to(torch.bfloat16),
                     _randn(rng, L, P, 1, page, 512).to(torch.bfloat16)]
        n = 1 if entry == "decode" else S
        kn = torch.from_numpy((rng.standard_normal((B, n, 1, 64)) * 3).astype(np.float32))
        vn = torch.from_numpy(rng.standard_normal((B, n, 1, 512)).astype(np.float32))
        kn, vn = kn.to(torch.bfloat16), vn.to(torch.bfloat16)
        pgs = torch.tensor([[3, 4], [5, 0], [0, 0]], dtype=torch.int32)
        offs = torch.tensor([60, 2, 9], dtype=torch.int32)  # crossing, inside, trash
        valid = torch.tensor([S, 5, S], dtype=torch.int32)
        ref = [t.clone() for t in state]
        got = [t.to(cuda_device) for t in state]
        extra = lambda st: dict(kv_scales=st[2]) if pages == "int8" else {}  # noqa: E731
        kern = tpw.KERNEL_INT8 if pages == "int8" else tpw.KERNEL
        before = kern.launches
        if entry == "decode":
            tpw.paged_write_decode(*ref[:2], kn[:, 0], vn[:, 0], pgs[:, 0], offs, 1, **extra(ref))
            tpw.paged_write_decode(*got[:2], kn[:, 0].to(cuda_device), vn[:, 0].to(cuda_device),
                                   pgs[:, 0].to(cuda_device), offs.to(cuda_device), 1,
                                   **extra(got))
        else:
            tpw.paged_write_chunk(*ref[:2], kn, vn, pgs, offs, valid, 1, **extra(ref))
            tpw.paged_write_chunk(*got[:2], kn.to(cuda_device), vn.to(cuda_device),
                                  pgs.to(cuda_device), offs.to(cuda_device),
                                  valid.to(cuda_device), 1, **extra(got))
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for r, g in zip(ref, got):
            assert torch.equal(g[:, 1:].cpu(), r[:, 1:])


#: (slots, n_pt, lengths): ragged lengths ending mid-page, a full table, an
#: empty slot; one slot with one split; 16 slots as the Engine decodes
MLA_CASES = {
    "ragged": (4, 6, [1, 100, 384, 0]),
    "one_slot": (1, 2, [77]),
    "engine16": (16, 16, [1, 64, 65, 130, 200, 257, 300, 411, 512, 600, 700, 777, 850, 901,
                          1000, 1024]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_paged_kernel_matches_plain(rng, cuda_device, case, pages):
    """K10 (bf16 latent pages) and K10q (INT8 codes with scale tiles)
    against their plain version: 16 heads, R 512, dr 64, page 64, within
    2e-2 x (1 + |ref|) and 2e-2 of each row's max |ref|; an empty slot
    returns 0."""
    B, n_pt, lengths = MLA_CASES[case]
    L, page, Hq = 2, 64, 16
    P = 1 + B * n_pt
    kpe = _randn(rng, L, P, 1, page, 64)
    c = _randn(rng, L, P, 1, page, 512)
    tiles = None
    if pages == "int8":
        (kpe, ks), (c, cs) = tpw.quantize_kv(kpe), tpw.quantize_kv(c)
        tiles = torch.zeros((L, P, 8, page))
        tiles[:, :, 0], tiles[:, :, 1] = ks.reshape(L, P, -1), cs.reshape(L, P, -1)
    else:
        kpe, c = kpe.to(torch.bfloat16), c.to(torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(B, n_pt).astype(np.int32))
    q_c = _randn(rng, B, Hq, 512).to(torch.bfloat16)
    q_pe = _randn(rng, B, Hq, 64).to(torch.bfloat16)
    ln = torch.tensor(lengths, dtype=torch.int32)
    cpu = (q_c, q_pe, kpe, c, bt, ln)
    before = tmla.KERNEL.launches
    out = tmla.mla_paged_decode_attention(*(t.to(cuda_device) for t in cpu), layer=1,
                                          scale=0.1147,
                                          kv_scales=None if tiles is None else tiles.to(cuda_device))
    torch.cuda.synchronize()
    assert tmla.KERNEL.launches == before + 1
    ref = tmla.mla_paged_decode_attention(*cpu, layer=1, scale=0.1147, kv_scales=tiles)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    o, r = f32(out), f32(ref)
    rmax = np.abs(r).max(-1, keepdims=True)
    assert (np.abs(o - r) <= 2e-2 * np.where(rmax > 0, rmax, 1.0)).all()
    for b, n in enumerate(lengths):
        if n == 0:
            assert not o[b].any()


# ------------------------------------------------------- W4A8 and RMSNorm

def _a8_case(rng, M, K, N, G):
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    s = (rng.uniform(size=(K // G, N)) * 0.01 + 0.001).astype(np.float32)
    z = np.round(rng.uniform(size=(K // G, N)) * 15).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            *(torch.from_numpy(a) for a in (pack_qtpu(q, G), s, z * s)))


def _within(out, ref, tol):
    """|out - ref| <= tol * (1 + |ref|), as chip_smoke.py holds kernels."""
    o, r = f32(out), f32(ref)
    assert o.shape == r.shape and np.isfinite(o).all()
    assert (np.abs(o - r) <= tol * (1 + np.abs(r))).all(), np.abs(o - r).max()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,K,N,G",
    [(97, 512, 384, 128),     # split-K, ragged rows
     (128, 4096, 4096, 128),  # the Engine chunk's rows, split-K
     (200, 1024, 8192, 128),
     (512, 512, 16384, 128),  # no split
     (128, 512, 384, 64), (130, 320, 256, 64),  # a part-filled last chunk
     (100, 512, 200, 32)],    # ragged columns
)
def test_a8_gemm_kernels_match_plain(rng, cuda_device, monkeypatch, M, K, N, G):
    """K11 (and K11f at G = 128) through quantized_matmul(a8=True) against
    quantized_matmul_a8_plain on the same card tensors: the codes on the
    card equal the CPU's byte for byte; the outputs within 1e-2 x
    (1 + |ref|); K11f equal to K11 bit for bit. Rows <= 96 stay on K1."""
    x, qw, s, zs = (t.to(cuda_device) for t in _a8_case(rng, M, K, N, G))
    xq, sx = tqmm.quantize_activations(x)
    xq_c, sx_c = tqmm.quantize_activations(x.cpu())
    assert torch.equal(xq.cpu(), xq_c) and torch.equal(sx.cpu(), sx_c)
    monkeypatch.delenv("QUICK_TPU_A8_FUSED", raising=False)
    before = tqmm.KERNEL_A8.launches_by_key.copy()
    out = tqmm.quantized_matmul(x, qw, s, zs, group_size=G, a8=True)
    torch.cuda.synchronize()
    key = tqmm.a8_launch_key(M, K, N, G, False)
    assert tqmm.KERNEL_A8.launches_by_key[key] == before[key] + 1
    ref = tqmm.quantized_matmul_a8_plain(x, qw, s, zs, G)
    _within(out, ref, 1e-2)
    if G == 128:
        monkeypatch.setenv("QUICK_TPU_A8_FUSED", "1")
        fused = tqmm.quantized_matmul(x, qw, s, zs, group_size=G, a8=True)
        torch.cuda.synchronize()
        assert tqmm.KERNEL_A8.launches_by_key[tqmm.a8_launch_key(M, K, N, G, True)] >= 1
        _within(fused, ref, 1e-2)
        assert torch.equal(fused, out)  # one body, one plan: bit for bit
    x96 = x[:96]
    k1 = tqmm.KERNEL.launches + tqmm.KERNEL_DEQUANT.launches
    a8n = tqmm.KERNEL_A8.launches
    small = tqmm.quantized_matmul(x96, qw, s, zs, group_size=G, a8=True)
    assert tqmm.KERNEL_A8.launches == a8n
    assert tqmm.KERNEL.launches + tqmm.KERNEL_DEQUANT.launches == k1 + 1
    assert torch.equal(small, tqmm.quantized_matmul(x96, qw, s, zs, group_size=G))


#: K11f on its wgmma body: ragged M, N % 4 == 2, one and several stages
#: per split, the Mistral-7B widths
A8F_SHAPES = [(512, 130), (4096, 576), (4096, 4096), (14336, 4096), (1024, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", A8F_SHAPES)
@pytest.mark.parametrize("M", [9, 16, 97, 128, 200, 512])
def test_a8_fused_wgmma_body_matches_plain(cuda_device, M, K, N):
    """K11f (int8 wgmma over the QTPU words, rows quantized once) at every
    token width and split-K plan: within 1e-2 x (1 + |ref|) of its plain
    version, and equal to K11 on the same codes (K11's expression, group
    order and split of K: the same body and plan); a second launch
    bit-equal to the first."""
    x, qw, s, zs = _wgmma_case(cuda_device, M, K, N, seed=3 * M + K + N)
    before = tqmm.KERNEL_A8.launches
    out = tqmm.launch_a8(x, None, qw, s, zs)
    again = tqmm.launch_a8(x, None, qw, s, zs)
    k11 = tqmm.launch_a8(*tqmm.quantize_activations(x), qw, s, zs)
    ref = tqmm.quantized_matmul_a8_plain(x, qw, s, zs)
    torch.cuda.synchronize()
    assert tqmm.KERNEL_A8.launches == before + 3 and out.shape == (M, N)
    assert torch.equal(out, again)
    _within(out, ref, 1e-2)
    assert torch.equal(out, k11)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(97, 512), (512, 4096), (200, 14336)])
def test_a8_fused_first_kernel_equals_plain(cuda_device, M, K):
    """K11f's first kernel, read back from the scratch it writes: the int8
    codes and row scales byte-equal to quantize_activations', the groups'
    row sums equal to a8_row_quant_plain's."""
    import ctypes

    from quick_tpu_torch.ops._cuda import sm_count, stream_ptr

    x, qw, s, zs = _wgmma_case(cuda_device, M, K, 256, seed=M + K)
    N, ldrs = 256, -(-M // 4) * 4
    dev = x.device
    bt, splits, cps = tqmm.a8_plan(M, K, N, sm_count(dev.index))
    sx = torch.empty(M, device=cuda_device)
    scratch = torch.empty(M * K + (K // 128) * ldrs * 4, dtype=torch.uint8, device=cuda_device)
    partial = torch.empty(splits * M * N, device=cuda_device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=cuda_device)
    err = tqmm.KERNEL_A8.lib().qtt_quantized_matmul_a8(
        x.data_ptr(), sx.data_ptr(), qw.data_ptr(), s.data_ptr(), zs.data_ptr(), 1, M, K, N,
        128, bt, splits, cps, scratch.data_ptr(), partial.data_ptr(), out.data_ptr(),
        ctypes.c_void_p(stream_ptr(dev)))
    torch.cuda.synchronize()
    assert err == 0
    xq, sxr, rowsum = tqmm.a8_row_quant_plain(x)
    assert torch.equal(scratch[:M * K].view(torch.int8).reshape(M, K), xq)
    assert torch.equal(sx, sxr.reshape(M))
    got = scratch[M * K:].view(torch.float32).reshape(K // 128, ldrs)[:, :M]
    assert torch.equal(got, rowsum)


#: K11 on the wgmma body at G = 64 and 32: DeepSeek-V2-Lite's widths at
#: G = 64 (its dense down K = 10944 is 85.5 stages; kv_a N = 576) and ragged
#: last stages, N % 4 == 2
A8_SMALL_SHAPES = [(10944, 2048, 64), (2048, 576, 64), (2048, 21888, 64), (1408, 2048, 64),
                   (320, 130, 64), (160, 256, 32), (4096, 4096, 32), (10944, 130, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,G", A8_SMALL_SHAPES)
@pytest.mark.parametrize("M", [9, 97, 128, 200, 512])
def test_a8_wgmma_small_groups_match_plain(rng, cuda_device, M, K, N, G):
    """K11 at G = 64 and 32 on the int8 wgmma body (each group's exact dot
    folded in order; the groups past K of a last part stage skipped):
    within 1e-2 x (1 + |ref|) of its plain version, its row sums equal to
    the plain first kernel's, and a second launch bit-equal."""
    x, qw, s, zs = (t.to(cuda_device) for t in _a8_case(rng, M, K, N, G))
    xq, sx = tqmm.quantize_activations(x)
    before = tqmm.KERNEL_A8.launches
    out = tqmm.launch_a8(xq, sx, qw, s, zs, G)
    again = tqmm.launch_a8(xq, sx, qw, s, zs, G)
    ref = tqmm.quantized_matmul_a8_plain(x, qw, s, zs, G)
    torch.cuda.synchronize()
    assert tqmm.KERNEL_A8.launches == before + 2 and out.shape == (M, N)
    assert torch.equal(out, again)
    _within(out, ref, 1e-2)


#: K9 on its wgmma body: K not a multiple of the 128-deep stage (160, 192,
#: 1408 = 11 stages, 10944 = 85.5), N % 4 == 2 and DeepSeek's kv_a 576, the
#: Mistral-7B and DeepSeek widths
DQ_SHAPES = [(K, N, G) for G, Ks in ((32, (160, 4096, 10944)), (64, (192, 1408, 2048)))
             for K in Ks for N in (130, 576)] + [(4096, 4096, 32), (2048, 6144, 64),
                                                 (10944, 2048, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,G", DQ_SHAPES)
@pytest.mark.parametrize("M", [9, 16, 33, 100, 128, 129, 512])
def test_dequant_wgmma_body_matches_plain(cuda_device, M, K, N, G):
    """K9 above 8 rows (bf16 wgmma, each weight dequantized in registers)
    at G = 32 and 64, every token width and split-K plan, against its plain
    version; a second launch bit-equal to the first."""
    gen = torch.Generator(device=cuda_device).manual_seed(M * 5 + K + N + G)
    qw = torch.randint(-2**31, 2**31, (K // 8, N), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    s = torch.rand((K // G, N), generator=gen, device=cuda_device) * 0.01 + 0.001
    zs = torch.round(torch.rand((K // G, N), generator=gen, device=cuda_device) * 15) * s
    x = torch.randn((M, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = tqmm.KERNEL_DEQUANT.launches
    out = tqmm.quantized_matmul_dequant_cuda(x, qw, s, zs, G)
    again = tqmm.quantized_matmul_dequant_cuda(x, qw, s, zs, G)
    ref = tqmm.quantized_matmul_dequant_plain(x, qw, s, zs, G)
    torch.cuda.synchronize()
    assert tqmm.KERNEL_DEQUANT.launches == before + 2 and out.shape == (M, N)
    assert torch.equal(out, again)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


#: K9's decode rows (the 8-token wgmma body): K not a multiple of the
#: 128-deep stage (160 at G = 32, 192 at G = 64: one split; 10944 = 85.5
#: stages), N % 4 == 2 (padded at the call), N not a multiple of 128
#: (DeepSeek's kv_a 576), and widths whose plan splits K over many blocks
#: (the last block of a tile merging) or none
DQ_DECODE_SHAPES = [(160, 130, 32), (4096, 576, 32), (4096, 4098, 32), (192, 200, 64),
                    (2048, 576, 64), (10944, 2048, 64), (2048, 21888, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,G", DQ_DECODE_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8])
def test_dequant_decode_rows_match_plain(cuda_device, M, K, N, G):
    """K9 at every decode row count (one 8-token tile, rows >= M
    zero-filled by the copy) against its plain version; a second launch
    bit-equal to the first (the splits merged in split order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(M * 7 + K + N + G)
    qw = torch.randint(-2**31, 2**31, (K // 8, N), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    s = torch.rand((K // G, N), generator=gen, device=cuda_device) * 0.01 + 0.001
    zs = torch.round(torch.rand((K // G, N), generator=gen, device=cuda_device) * 15) * s
    x = torch.randn((M, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = tqmm.KERNEL_DEQUANT.launches
    out = tqmm.quantized_matmul_dequant_cuda(x, qw, s, zs, G)
    again = tqmm.quantized_matmul_dequant_cuda(x, qw, s, zs, G)
    ref = tqmm.quantized_matmul_dequant_plain(x, qw, s, zs, G)
    torch.cuda.synchronize()
    assert tqmm.KERNEL_DEQUANT.launches == before + 2 and out.shape == (M, N)
    assert tqmm.dequant_launch_plan(M, K, N + (-N % 4), 132)[0] == 8
    assert torch.equal(out, again)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,G", [(2048, 576, 64), (4096, 4096, 32)])
def test_dequant_decode_graph_replays(cuda_device, K, N, G):
    """K9 at M = 4 with K split over blocks, captured in a CUDA graph and
    replayed twice after x moved in place: each replay equal to an eager
    launch bit for bit (the last block of each tile resets its counter)."""
    gen = torch.Generator(device=cuda_device).manual_seed(K + N)
    qw = torch.randint(-2**31, 2**31, (K // 8, N), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    s = torch.rand((K // G, N), generator=gen, device=cuda_device) * 0.01 + 0.001
    zs = torch.round(torch.rand((K // G, N), generator=gen, device=cuda_device) * 15) * s
    x = torch.randn((4, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tqmm.dequant_launch_plan(4, K, N, sms)[1] > 1
    out = tqmm.quantized_matmul_dequant_cuda(x, qw, s, zs, G)  # eager: makes the counters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tqmm.quantized_matmul_dequant_cuda(x, qw, s, zs, G)
    for _ in range(2):
        x.copy_(torch.randn((4, K), generator=gen, device=cuda_device).to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        want = tqmm.quantized_matmul_dequant_cuda(x.clone(), qw, s, zs, G)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(f32(out), f32(want))
    np.testing.assert_allclose(f32(out), f32(tqmm.quantized_matmul_dequant_plain(x, qw, s, zs, G)),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_a8_kernel_matches_plain(rng, cuda_device, case):
    """K12 against its plain version on the card and on the CPU within
    1e-2 x (1 + |ref|), dead tiles all zeros; at G = 64 the a8 switch falls
    back to K8 (W4A16)."""
    import quick_tpu_torch.ops.grouped_matmul as tgm

    bm, te, live, N = GROUPED_CASES[case]
    E, K = 4, 512
    q = rng.integers(0, 16, size=(E, K, N), dtype=np.uint8)
    qw = np.stack([pack_qtpu(q[e]) for e in range(E)])
    s = (rng.uniform(size=(E, K // 128, N)) * 0.01 + 0.001).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // 128, N)) * 15) * s).astype(np.float32)
    x = rng.standard_normal((len(te) * bm, K)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, qw, s, zs, np.asarray(te, np.int32),
                                          np.asarray(live, np.int32))]
    args[0] = args[0].to(torch.bfloat16)
    dev_args = [a.to(cuda_device) for a in args]
    before = tgm.KERNEL_A8.launches
    out = tgm.quantized_matmul_grouped(*dev_args, bm, a8=True)
    torch.cuda.synchronize()
    assert tgm.KERNEL_A8.launches == before + 1
    ref = tgm.quantized_matmul_grouped_a8_plain(*dev_args, bm)
    _within(out, ref, 1e-2)
    _within(out, tgm.quantized_matmul_grouped(*args, bm, a8=True), 1e-2)
    assert not f32(out)[np.repeat(np.asarray(live) == 0, bm)].any()
    k8 = tgm.KERNEL.launches
    qw64 = torch.from_numpy(np.stack([pack_qtpu(q[e], 64) for e in range(E)])).to(cuda_device)
    s64 = dev_args[2].repeat_interleave(2, dim=1)
    tgm.quantized_matmul_grouped(dev_args[0], qw64, s64, s64, *dev_args[4:], bm, group_size=64,
                                 a8=True)
    assert tgm.KERNEL.launches == k8 + 1 and tgm.KERNEL_A8.launches == before + 1


#: (token expert choices or (tile experts, live flags), E, bm, K, N): K12
#: on K8's skeleton. bm = 96 (QUICK_TPU_MOE_BM) as 32-row sub-tiles, with
#: and without a K split; an expert chosen by several decode tokens with a
#: K split; 128-row passes with a split; every tile dead
K12_ROUTES = {
    "bm96": (([0, 0, 2, 3, 3, 1], [1, 1, 1, 1, 1, 0]), 4, 96, 512, 256),
    "bm96_split": (([0, 0, 2, 3, 3, 1], [1, 1, 1, 1, 1, 0]), 4, 96, 4096, 256),
    "decode_duplicates_split": ([[0, 1], [0, 2], [3, 1], [0, 5]], 8, 32, 4096, 512),
    "bm128_split": (([1, 1, 3], [1, 1, 0]), 4, 128, 4096, 200),
    "all_dead": (([0, 0, 0], [0, 0, 0]), 4, 64, 512, 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K12_ROUTES))
def test_grouped_a8_kernel_routes(rng, cuda_device, name):
    """K12 against its plain version and against the plain model of its
    split fold on the wrapper's plan, within 1e-2 x (1 + |ref|), the whole
    output compared, dead tiles all zeros, one launch a call, two launches
    equal bit for bit."""
    import quick_tpu_torch.ops.grouped_matmul as tgm

    layout, E, bm, K, N = K12_ROUTES[name]
    if isinstance(layout, tuple):
        te, live = (torch.tensor(a, dtype=torch.int32) for a in layout)
    else:
        _, _, te, live, _ = tgm.build_routing(torch.tensor(layout), E, bm)
        assert int(torch.bincount(te).max()) >= 2  # an expert chosen by several tokens
    x = torch.from_numpy(rng.standard_normal((te.shape[0] * bm, K)).astype(np.float32))
    args = [x.to(torch.bfloat16), *_grouped_weights(rng, E, K, N, 128), te, live]
    dev_args = [a.to(cuda_device) for a in args]
    u, te_u, _ = tgm.grouped_a8_tiles(te, live, bm)
    splits, cps = tgm.grouped_plan(E, te_u.numel(), K, -(-N // 4) * 4, u,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
    assert (splits > 1) == name.endswith("split")
    before = tgm.KERNEL_A8.launches
    out = tgm.quantized_matmul_grouped(*dev_args, bm, a8=True)
    again = tgm.quantized_matmul_grouped(*dev_args, bm, a8=True)
    torch.cuda.synchronize()
    assert tgm.KERNEL_A8.launches == before + 2
    assert torch.equal(out, again)
    _within(out, tgm.quantized_matmul_grouped_a8_plain(*dev_args, bm), 1e-2)
    _within(out, tgm.quantized_matmul_grouped_a8_split_plain(*dev_args, bm, splits, cps), 1e-2)
    assert not f32(out)[np.repeat(live.numpy() == 0, bm)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [32, 96])
def test_grouped_a8_graph_replays_after_routing_moves(rng, cuda_device, bm):
    """K12 captured in a CUDA graph, then replayed after the tile layout
    (tile experts, live flags) and the rows changed in place: equal to an
    eager launch on the new layout, bit for bit."""
    import quick_tpu_torch.ops.grouped_matmul as tgm

    E, K, N = 8, 512, 256
    w = [t.to(cuda_device) for t in _grouped_weights(rng, E, K, N, 128)]

    def layout(seed):
        g = torch.Generator().manual_seed(seed)
        sel = torch.argsort(torch.rand((4, E), generator=g), dim=1)[:, :2]
        _, _, te, live, _ = tgm.build_routing(sel, E, bm)
        x = torch.randn((te.shape[0] * bm, K), generator=g).to(torch.bfloat16)
        return x.to(cuda_device), te.to(cuda_device), live.to(cuda_device)

    x, te, live = layout(0)
    out = tgm.quantized_matmul_grouped(x, *w, te, live, bm, a8=True)  # eager: builds
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tgm.quantized_matmul_grouped(x, *w, te, live, bm, a8=True)
    for seed in (1, 2):
        x2, te2, live2 = layout(seed)
        x.copy_(x2)
        te.copy_(te2)
        live.copy_(live2)
        graph.replay()
        torch.cuda.synchronize()
        want = tgm.quantized_matmul_grouped(x2, *w, te2, live2, bm, a8=True)
        np.testing.assert_array_equal(f32(out), f32(want))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,xdt,wdt,sliced",
    [((4, 4096), torch.bfloat16, torch.bfloat16, None),
     ((512, 4096), torch.bfloat16, torch.bfloat16, None),
     ((2, 8, 128), torch.float32, torch.bfloat16, None),
     ((16, 5000), torch.bfloat16, torch.float32, None),  # past the registers' 4096
     ((16, 576), torch.bfloat16, torch.bfloat16, 512),   # ckv[..., :512]
     ((2, 8, 576), torch.bfloat16, torch.float32, 512)],
)
def test_rms_norm_kernel_matches_plain(rng, cuda_device, shape, xdt, wdt, sliced):
    """K13 through rms_norm on CUDA tensors against rms_norm_plain on the
    same tensors: within one step of x's type (bf16 or f32 rounding of the
    same f32 value, summed in another order), contiguous or a strided
    last-dim slice, one launch each."""
    from quick_tpu_torch.ops import norms

    x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(cuda_device, xdt)
    if sliced:
        x = x[..., :sliced]
    D = x.shape[-1]
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(D)).astype(np.float32)).to(cuda_device, wdt)
    before = norms.KERNEL.launches
    out = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert norms.KERNEL.launches == before + 1
    ref = norms.rms_norm_plain(x, w, 1e-5)
    assert out.shape == ref.shape and out.dtype == ref.dtype == xdt
    step = 2.0 ** -7 if xdt == torch.bfloat16 else 2.0 ** -20
    o, r = f32(out), f32(ref)
    assert (np.abs(o - r) <= step * np.abs(r) + 1e-30).all(), np.abs(o - r).max()


def _tail_case(rng, dev, M, K1, D, I):
    """K14's operands: test_layer_tail.py's weights (codes 0..15, scales
    0..0.02, zero terms half that) and activations (0.1 N(0, 1) in bf16)."""
    ws = []
    for K, N in ((K1, D), (D, 2 * I), (I, D)):
        q = rng.integers(0, 16, (K, N), dtype=np.uint8)
        s = rng.random((K // 128, N), dtype=np.float32) * 0.02
        ws += [pack_qtpu(q), s, rng.random((K // 128, N), dtype=np.float32) * 0.01]
    nw = (rng.standard_normal(D) * 0.1 + 1.0).astype(np.float32)
    ao = (rng.standard_normal((M, K1)) * 0.1).astype(np.float32)
    xr = (rng.standard_normal((M, D)) * 0.1).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in [ao, xr, nw] + ws]
    return [t[0].to(torch.bfloat16), t[1].to(torch.bfloat16)] + t[2:]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K1,D,I", [(1, 4096, 4096, 14336), (4, 4096, 4096, 14336),
                                      (8, 4096, 4096, 14336), (3, 512, 384, 768)])
def test_layer_tail_kernel_matches_plain(rng, cuda_device, M, K1, D, I):
    """K14 against its plain version on the same tensors, at Mistral-7B
    width and tests/test_layer_tail.py's shapes: within 8e-3 of max|ref|
    (that test's bound between two orders of the f32 group sums), one launch
    a call, the same bits on a second launch (split sums in a fixed order;
    the barrier and tile counters left at zero)."""
    from quick_tpu_torch.ops import fused_layer_tail as tft

    args = _tail_case(rng, cuda_device, M, K1, D, I)
    before = tft.KERNEL.launches
    out = tft.fused_layer_tail(*args)
    again = tft.fused_layer_tail(*args)
    torch.cuda.synchronize()
    assert tft.KERNEL.launches == before + 2
    ref = tft.fused_layer_tail_plain(*args)
    assert out.shape == ref.shape == (M, D) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    o, r = f32(out), f32(ref)
    assert np.abs(o - r).max() <= 8e-3 * np.abs(r).max(), (np.abs(o - r).max(), np.abs(r).max())


#: tiny models for the decode graphs: (config, group, batch, max_seq, new
#: tokens); the llama at B=4 takes K3, at B=16 K7 over 1024 tokens (a replay
#: that wrote at the capture's position would leave most of the cache zero)
_LLAMA = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024)
#: DeepSeek's latent widths (K10 is built for R 512, dr 64), narrow elsewhere
_DS = dict(vocab_size=256, hidden_size=128, intermediate_size=192, num_hidden_layers=3,
           num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
           kv_lora_rank=512, qk_nope_head_dim=32, qk_rope_head_dim=64, v_head_dim=32,
           head_dim=96, rotary_dim=64, num_local_experts=8, num_experts_per_tok=2,
           moe_router="deepseek", moe_intermediate_size=64, first_k_dense_replace=1,
           rms_norm_eps=1e-6, model_type="deepseek_v2", n_shared_experts=2)
GRAPH_MODELS = {
    "llama_k3": (_LLAMA, 128, 4, 64, 12),
    "llama_k7": (_LLAMA, 128, 16, 1024, 1008),
    "llama_tail": (_LLAMA, 128, 4, 64, 12),
    "mixtral": (dict(_LLAMA, num_local_experts=4, num_experts_per_tok=2, model_type="mixtral"),
                128, 4, 64, 12),
    "deepseek_v2": (_DS, 64, 4, 64, 12),
}


def _counted(fn):
    """fn()'s result and the launches it counted, by kernel and key."""
    from quick_tpu_torch.ops import all_kernels

    for k in all_kernels():
        k.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: dict(k.launches_by_key) for k in all_kernels() if k.launches}


def _assert_planes_equal(a, b, names, first_page=0):
    """The named cache tensors of ``a`` and ``b`` bit-equal from index
    ``first_page`` of dim 1 on: the graphed and the eager run launch the same
    kernels in the same order (greedy tokens of a random model repeat, so
    equal tokens alone would not show a graph that attends over the wrong
    rows)."""
    for name in names:
        x, y = getattr(a, name)[:, first_page:], getattr(b, name)[:, first_page:]
        assert torch.equal(x, y), (name, float((x.float() - y.float()).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPH_MODELS))
def test_graphed_decode_matches_eager(cuda_device, monkeypatch, name):
    """The decode loop with its step replayed from a CUDA graph against the
    eager loop on the card: the same greedy tokens, the same k/v cache bit
    for bit, and the same launch counts (a replay adds the launches recorded
    at capture). The llama_tail case runs under QUICK_TPU_LAYER_TAIL=1 (K14
    in the graph)."""
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.runtime import SamplingParams, decode_loop, make_cache, prefill
    from quick_tpu_torch.runtime.generate import graphable

    kw, G, B, max_seq, new = GRAPH_MODELS[name]
    monkeypatch.setenv("QUICK_TPU_LAYER_TAIL", "1" if name == "llama_tail" else "0")
    cfg = ModelConfig(**kw)
    params = init_quant_params(cfg, seed=0, group_size=G, device=cuda_device)
    assert graphable(params, cfg, make_cache(cfg, B, max_seq, device=cuda_device),
                     SamplingParams())
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, 16), generator=gen, device=cuda_device)

    def run(graph):
        cache = make_cache(cfg, B, max_seq, device=cuda_device)
        logits, cache = prefill(params, cfg, prompt, cache)
        return decode_loop(params, cfg, torch.argmax(logits, dim=-1), cache, new,
                           _graph=graph)

    (eager, c_eager), n_eager = _counted(lambda: run(False))
    (graphed, c_graphed), n_graphed = _counted(lambda: run(None))
    assert torch.equal(eager, graphed)
    assert c_eager.length == c_graphed.length == 16 + new
    assert int(c_graphed.length_dev) == c_graphed.length
    _assert_planes_equal(c_eager, c_graphed, ("k", "v"))
    assert n_eager == n_graphed
    if name == "llama_tail":
        assert sum(n_graphed["fused_layer_tail"].values()) == new * cfg.num_hidden_layers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama_k3", "llama_tail", "deepseek_v2"])
def test_graphed_engine_matches_eager(cuda_device, monkeypatch, name):
    """The Engine's greedy windows replayed from a captured [4, 1] step
    against eager windows: the same streams, the same pages bit for bit and
    the same launch counts."""
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.runtime import Engine

    kw, G, _, _, _ = GRAPH_MODELS[name]
    monkeypatch.setenv("QUICK_TPU_LAYER_TAIL", "1" if name == "llama_tail" else "0")
    cfg = ModelConfig(**kw)
    params = init_quant_params(cfg, seed=0, group_size=G, device=cuda_device)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(3, 30, 6), rng.integers(4, 20, 6))]

    def run(graphs):
        eng = Engine(params, cfg, max_slots=4, max_seq=64, page_size=16, chunk=8,
                     decode_window=4, device=cuda_device, _graphs=graphs)
        uids = [eng.submit(p, m) for p, m in reqs]
        out = eng.run()
        return [out[u] for u in uids], eng.stats, eng.cache

    (eager, st_e, c_e), n_eager = _counted(lambda: run(False))
    (graphed, st_g, c_g), n_graphed = _counted(lambda: run(True))
    assert eager == graphed
    assert st_e == st_g
    assert [len(o) for o in graphed] == [m for _, m in reqs]
    # without the trash page, which idle slots' rows write in no fixed order
    _assert_planes_equal(c_e, c_g, ("k_pages", "v_pages"), first_page=TRASH_PAGE + 1)
    assert n_eager == n_graphed
