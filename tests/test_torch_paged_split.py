"""K5's key split on the CPU: the split plan covers every visible key once
at every length of the page table, with and without a window, and the
plain model of the split-and-merge arithmetic
(``paged_decode_attention_split_plain``) against the Pallas paged decode
kernel in interpret mode. (K5 itself is held against its plain version in
test_torch_kernels.py, on a card.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.decode_attention as tdda
import quick_tpu_torch.ops.paged_attention as tpa
from quick_tpu.ops.alibi import alibi_slopes
from quick_tpu.ops.paged_attention import paged_decode_attention as jax_decode

H100_SMS = 132


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("B,page,n_pt", [(16, 64, 16), (4, 16, 16), (1, 64, 4)])
def test_split_plan_covers_every_key_once(B, page, n_pt, window):
    """For every length in [0, n_pt * page] the splits' ranges cover each
    key of [window start, length) exactly once and nothing else, each
    inside the 64-key tiles its block walks; the plan is K7's over
    B x Hkv blocks (gq <= 16), from the shapes alone."""
    Hkv, gq, T = 8, 4, n_pt * page
    chunk, splits = tpa.split_plan(B, Hkv, gq, T, H100_SMS)
    assert (chunk, splits) == tdda.split_plan(B, Hkv, T, H100_SMS)
    assert chunk % 64 == 0 and splits * chunk >= T and (splits - 1) * chunk < T
    # gq = 32 takes two blocks a kv head: the plan counts them
    assert tpa.split_plan(B, Hkv, 32, T, H100_SMS) == tdda.split_plan(B, 2 * Hkv, T, H100_SMS)
    for length in range(T + 1):
        seen = np.zeros(T + 1, np.int64)
        for sp in range(splits):
            lo, hi = tpa.split_range(sp, chunk, length, window, T)
            if lo >= hi:
                continue
            assert sp * chunk <= lo and hi <= (sp + 1) * chunk
            assert lo // 64 * 64 >= sp * chunk  # the first tile starts inside the chunk
            seen[lo:hi] += 1
        first = max(0, length - window) if window else 0
        want = np.zeros(T + 1, np.int64)
        want[first:length] = 1
        assert np.array_equal(seen, want), length


SPLIT_CASES = {
    "plain": {},
    "softcap": dict(logit_softcap=30.0),
    "alibi": dict(alibi=True),
    "window": dict(window=40),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_model_matches_pallas_interpret(rng, case):
    """The split-and-merge arithmetic (per-split partials over 64-key
    tiles of the gathered pages, merged in split order) against the Pallas
    paged decode kernel in interpret mode, in f32, at 4 splits of 64 keys
    over 16 pages of 16: lengths 0, 1, page - 1, page, a tile, a tile + 1
    and the whole table, within K3's split model's tolerance."""
    B, Hq, Hkv, D, page, n_pt = 8, 8, 2, 32, 16, 16
    P = 1 + B * n_pt
    kp, vp = (rng.standard_normal((2, P, Hkv, page, D)).astype(np.float32) for _ in range(2))
    bt = rng.permutation(np.arange(1, P))[: B * n_pt].reshape(B, n_pt).astype(np.int32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    lengths = np.asarray([0, 1, page - 1, page, 64, 65, 200, n_pt * page], np.int32)
    kw = dict(SPLIT_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = alibi_slopes(Hq)
    ref = jax_decode(*(jnp.asarray(a) for a in (q, kp, vp, bt, lengths)), layer=1,
                     interpret=True, **{k: jnp.asarray(v) if k == "alibi_slopes" else v
                                        for k, v in kw.items()})
    chunk, splits = tpa.split_plan(B, Hkv, Hq // Hkv, n_pt * page, H100_SMS)
    assert (chunk, splits) == (64, 4)
    out = tpa.paged_decode_attention_split_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, lengths)), 1, D ** -0.5,
        chunk=chunk, splits=splits,
        **{k: torch.from_numpy(v) if k == "alibi_slopes" else v for k, v in kw.items()})
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-4, rtol=2e-4)
    assert not f32(out)[0].any()  # length 0: no key, zeros
    # the gather + einsum route (the kernel's plain version) agrees too
    plain = tpa.paged_decode_attention_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, lengths)), 1, D ** -0.5,
        **{k: torch.from_numpy(v) if k == "alibi_slopes" else v for k, v in kw.items()})
    np.testing.assert_allclose(f32(plain)[1:], f32(out)[1:], atol=2e-3)
