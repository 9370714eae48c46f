"""K7 on K5's key-split kernel, on the CPU: a dense cache [L, B, Hkv, T, D]
is a paged one of P = B pages of T keys with slot b's one page b, which is
how ``csrc/decode_attention.cu`` instantiates ``csrc/paged_decode.cuh``.
K5's plain versions over that view (the split-and-merge model on K7's
plan, and the gather + einsum route) against K7's plain version, in f32
(the point is the algorithm: no bf16 rounding of p, whose running maxima
differ between the two), within 2e-4 as tests/test_torch_paged_split.py.
(K7 itself is held against its plain version in test_torch_kernels.py, on
a card.)"""
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.decode_attention as tdda
import quick_tpu_torch.ops.paged_attention as tpa

H100_SMS = 132
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("gq", [1, 4, 8, 32])
@pytest.mark.parametrize("D,T", [(64, 200), (128, 256), (256, 136)])
@pytest.mark.parametrize("case", [{}, dict(logit_softcap=30.0), dict(alibi=True)])
def test_k5_over_the_dense_cache_equals_k7(gq, D, T, case):
    """Lengths 0, 1, 63, 64, T and past T (the mask clamps, the ALiBi bias
    reads the raw length), T a multiple of 8 but not always of 64, on K7's
    split plan; gq 32 is two head groups of 16 in the kernel."""
    rng = np.random.default_rng(gq * D + T)
    Hkv, L = 2, 2
    lengths = np.asarray([0, 1, 63, 64, T, T + 5], np.int32)
    B, Hq = len(lengths), gq * Hkv
    k, v = (torch.from_numpy(rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32))
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32))
    kw = dict(case)
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(
            (2.0 ** (-8.0 * np.arange(1, Hq + 1) / Hq)).astype(np.float32))
    ln = torch.from_numpy(lengths)
    ref = tdda.dense_decode_attention_plain(q, k, v, ln, 1, D ** -0.5, **kw)
    table = torch.arange(B, dtype=torch.int32)[:, None]  # k, v as pages [L, P=B, Hkv, T, D]
    chunk, splits = tdda.split_plan(B, Hkv, T, H100_SMS)
    assert chunk % tdda.TILE == 0 and splits * chunk >= T
    split = tpa.paged_decode_attention_split_plain(
        q, k, v, table, ln, 1, D ** -0.5, chunk=chunk, splits=splits, **kw)
    np.testing.assert_allclose(f32(split), f32(ref), **TOL)
    assert not f32(split)[0].any()  # length 0: no key, zeros
    plain = tpa.paged_decode_attention_plain(q, k, v, table, ln, 1, D ** -0.5, **kw)
    np.testing.assert_allclose(f32(plain)[1:], f32(ref)[1:], **TOL)
