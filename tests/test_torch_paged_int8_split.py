"""K5q's key split on the CPU: the split plan gives every visible key to
exactly one split in whole units of max(page, 64) keys (so that no page's p
quantization group is cut), and the plain model of the kernel's arithmetic
(``paged_decode_attention_int8_split_plain``: units of a page or of a
64-key tile of pages, per-page ps, per-split running max, merge in split
order) against the Pallas INT8 paged decode kernel in interpret mode; with
one split the model is ``paged_decode_attention_int8_plain`` bit for bit.
(K5q itself is held against its plain version on a card in
test_torch_kernels.py and chip_smoke.py's phase 9a.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.paged_attention as tpa
from quick_tpu.ops.alibi import alibi_slopes
from quick_tpu.ops.paged_attention import paged_decode_attention as jax_decode
from quick_tpu_torch.ops.paged_write import quantize_kv

H100_SMS = 132
#: as tests/test_torch_int8_kv.py: the same INT8 arithmetic in f32 (integer
#: dots exact in both), so only exp and the order of the float sums differ;
#: a p code moved by one would show as ~1e-3 and fail this
ATOL_ATTN = 1e-4
#: a moved p code must sit this close to a rounding tie (k + 1/2) on both sides
NEAR_TIE = 1e-3


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("page", [16, 64, 128, 256])
def test_int8_split_plan_keeps_pages_whole(page, window):
    """At every length of a 1,024-key table the splits' ranges cover each
    key of [window start, length) exactly once; every chunk is a whole
    number of units (a multiple of lcm(64, page)), so each page lies in one
    split; the plan is from the shapes alone, capped at
    INT8_DECODE_MAX_TILES tiles, and at the INT8 Engine's 64 slots it splits
    where K5's plan would not."""
    B, Hkv, gq, T = 64, 8, 4, 1024
    unit = np.lcm(64, page)
    chunk, splits = tpa.int8_split_plan(B, Hkv, gq, page, T, H100_SMS)
    assert tpa.int8_unit(page) == unit and tpa.int8_decode_pages_ok(page)
    # a split's chunk starts and ends on page boundaries: no page spans two splits
    assert chunk % unit == 0 and splits * chunk >= T and (splits - 1) * chunk < T
    assert chunk <= max(unit, tpa.INT8_DECODE_MAX_TILES * 64)
    assert tpa.split_plan(B, Hkv, gq, T, H100_SMS)[1] == 1 and splits > 1
    for length in range(T + 1):
        seen = np.zeros(T + 1, np.int64)
        for sp in range(splits):
            lo, hi = tpa.split_range(sp, chunk, length, window, T)
            if lo >= hi:
                continue
            assert sp * chunk <= lo and hi <= (sp + 1) * chunk
            seen[lo:hi] += 1
        first = max(0, length - window) if window else 0
        want = np.zeros(T + 1, np.int64)
        want[first:length] = 1
        assert np.array_equal(seen, want), length


def test_int8_decode_pages():
    """K5q takes pages of a power of two that lie inside one warp's 16 keys
    of a tile or span whole tiles, up to the 256 of the INT8 contract."""
    assert [p for p in range(4, 260, 4) if tpa.int8_decode_pages_ok(p)] == [16, 32, 64, 128, 256]


def _case(seed, B, Hq, Hkv, D, page, n_pt, lengths):
    """q, INT8 pages and their scale tiles (quantize_kv of random rows), a
    permuted block table and the lengths, as numpy-seeded tensors."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_pt
    kf, vf = (torch.from_numpy(rng.standard_normal((2, P, Hkv, page, D)).astype(np.float32))
              for _ in range(2))
    (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
    tiles = torch.zeros((2, P, 8, Hkv * page))
    tiles[:, :, 0], tiles[:, :, 1] = ks.reshape(2, P, -1), vs.reshape(2, P, -1)
    bt = rng.permutation(np.arange(1, P))[: B * n_pt].reshape(B, n_pt).astype(np.int32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    return (torch.from_numpy(q), kc, vc, tiles, torch.from_numpy(bt),
            torch.tensor(lengths, dtype=torch.int32))


CASES = {
    "plain": {},
    "softcap": dict(logit_softcap=30.0),
    "alibi": dict(alibi=True),
    "window": dict(window=40),
}


def _kw(case, Hq):
    kw = dict(CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = alibi_slopes(Hq)
    return kw


def _moved_codes(args, kw, chunk, splits) -> int:
    """The p codes the split walk rounds differently from the one-split
    walk (the per-page order of the Pallas kernel at pages of >= 64 keys);
    each must sit at a near-tie on both sides."""
    seq, split = {}, {}
    tpa.paged_decode_attention_int8_split_plain(*args, **kw, ratios=seq)
    tpa.paged_decode_attention_int8_split_plain(*args, **kw, chunk=chunk, splits=splits,
                                                ratios=split)
    moved = 0
    for u0, a in seq.items():
        b = split[u0]
        diff = torch.round(a).clamp(-127, 127) != torch.round(b).clamp(-127, 127)
        for r in (a[diff], b[diff]):
            assert ((r - torch.floor(r) - 0.5).abs() < NEAR_TIE).all(), r
        moved += int(diff.sum())
    return moved


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("page,n_pt", [(16, 8), (64, 4), (256, 2)])
def test_int8_split_model_matches_pallas_interpret(case, page, n_pt):
    """The split-and-merge arithmetic, one unit a split (the most merging),
    against the Pallas INT8 paged decode kernel in interpret mode at
    ATOL_ATTN: lengths 0, 1, page - 1, page, a tile, a tile + 1, mid-table
    and the whole table. A p code that the splits round otherwise than the
    sequential walk must be a near-tie (none in these seeded cases)."""
    B, Hq, Hkv, D = 8, 8, 2, 32
    lengths = [0, 1, page - 1, page, 64, 65, n_pt * page // 2 + 9, n_pt * page]
    args = _case(page, B, Hq, Hkv, D, page, n_pt, lengths)
    q, kc, vc, tiles, bt, ln = args
    kw = _kw(case, Hq)
    ref = jax_decode(*(jnp.asarray(t.numpy()) for t in (q, kc, vc, bt, ln)), layer=1,
                     kv_scales=jnp.asarray(tiles.numpy()), interpret=True,
                     **{k: jnp.asarray(v) if k == "alibi_slopes" else v for k, v in kw.items()})
    kw = {k: torch.from_numpy(v) if k == "alibi_slopes" else v for k, v in kw.items()}
    chunk = tpa.int8_unit(page)
    splits = -(-n_pt * page // chunk)
    assert splits > 1
    out = tpa.paged_decode_attention_int8_split_plain(*args, 1, D ** -0.5, chunk=chunk,
                                                      splits=splits, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), atol=ATOL_ATTN, rtol=0)
    assert not f32(out)[0].any()  # length 0: no key, zeros
    assert _moved_codes((*args, 1, D ** -0.5), kw, chunk, splits) == 0


@pytest.mark.parametrize("case", ["plain", "window", "alibi"])
@pytest.mark.parametrize("page", [64, 128, 256])
def test_int8_split_model_one_split_is_the_plain_version(case, page):
    """With one split and pages of >= 64 keys (a unit is a page) the model
    is paged_decode_attention_int8_plain op for op: equal bit for bit."""
    B, Hq, Hkv, D, n_pt = 4, 8, 2, 32, 512 // page
    args = _case(page + 1, B, Hq, Hkv, D, page, n_pt, [0, 1, 300, n_pt * page])
    kw = {k: torch.from_numpy(v) if k == "alibi_slopes" else v
          for k, v in _kw(case, Hq).items()}
    plain = tpa.paged_decode_attention_int8_plain(*args, 1, D ** -0.5, **kw)
    model = tpa.paged_decode_attention_int8_split_plain(*args, 1, D ** -0.5, **kw)
    assert torch.equal(model, plain)
