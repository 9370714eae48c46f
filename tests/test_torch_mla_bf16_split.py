"""K10's key split over bf16 latent pages on the CPU: its plan (``split_plan``)
gives every token of a slot to exactly one split at every length, and a
split's tokens lie on at most the kernel's ``MAX_PAGES`` page ids, at pages
of 64, 48 (no power of two) and 8; and the plain model of the kernel's
arithmetic (``mla_paged_decode_attention_split_plain`` at that plan)
against the Pallas MLA paged decode kernel in interpret mode, at 16 and 20
heads (a partial head group on the card), lengths 0 (zeros), 1, mid-table
and the full table. (K10 itself is held against its plain version on a
card in test_torch_kernels.py and chip_smoke.py's phase 11a.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.mla_paged_attention as tmla
from quick_tpu.ops.mla_paged_attention import mla_paged_decode_attention as jax_mla_paged

H100_SMS = 132
#: test_torch_mla_split.py's tolerance for bf16 pages: bf16 queries and
#: pages, f32 sums in other orders, p rounded to bf16 against a running max
TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize(
    "B,n_pt,page",
    [(16, 16, 64), (4, 16, 48), (4, 64, 8), (1, 16, 48),
     (256, 64, 48), (256, 128, 8), (256, 512, 1), (300, 20, 100)],  # the cap binds
)
def test_k10_plan_covers_every_token_once(B, n_pt, page):
    """Whole 64-token tiles, at most MAX_CHUNK tokens a split, enough
    splits to cover the table and no empty one past it; every split's
    tokens on at most MAX_PAGES pages; at every length each token lies in
    exactly one of the splits the kernel counts as live."""
    splits, chunk = tmla.split_plan(B, n_pt, page, H100_SMS)
    T = n_pt * page
    assert chunk % tmla.TILE == 0 and chunk <= tmla.MAX_CHUNK
    assert splits * chunk >= T and (splits - 1) * chunk < T
    for sp in range(splits):
        lo, hi = sp * chunk, min(T, sp * chunk + chunk)
        assert (hi - 1) // page - lo // page + 1 <= tmla.MAX_PAGES
    assert (chunk - 1) // page + 2 <= tmla.MAX_PAGES  # the kernel's own check
    for length in range(T + 1):
        live = (length - 1) // chunk + 1 if length else 0
        seen = np.zeros(T, np.int64)
        for sp in range(live):
            seen[sp * chunk:min(length, sp * chunk + chunk)] += 1
        assert (seen[:length] == 1).all() and not seen[length:].any()


@pytest.mark.parametrize("HQ", [16, 20])
@pytest.mark.parametrize("page,n_pt", [(64, 16), (48, 16), (8, 64)])
def test_k10_split_model_matches_pallas_interpret(page, n_pt, HQ):
    """The split-and-merge arithmetic at K10's plan for 4 slots against the
    Pallas MLA kernel (interpret mode) on the same bf16 latent pages."""
    B, R, DR = 4, 64, 16
    T = page * n_pt
    rng = np.random.default_rng(page + HQ)
    P = 1 + B * n_pt
    bt = rng.permutation(np.arange(1, P)).reshape(B, n_pt).astype(np.int32)
    kpe, c, q_c, q_pe = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                         .to(torch.bfloat16)
                         for sh in ((1, P, 1, page, DR), (1, P, 1, page, R), (B, HQ, R),
                                    (B, HQ, DR)))
    lengths = np.asarray([0, 1, T // 2 + 7, T], np.int32)
    scale = (R + DR) ** -0.5
    jx = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731  (exact)
    want = jax_mla_paged(jx(q_c), jx(q_pe), jx(kpe), jx(c), jnp.asarray(bt),
                         jnp.asarray(lengths), layer=0, scale=scale, interpret=True)
    splits, chunk = tmla.split_plan(B, n_pt, page, H100_SMS)
    assert splits > 1  # the merge runs
    got = tmla.mla_paged_decode_attention_split_plain(
        q_c, q_pe, kpe, c, torch.from_numpy(bt), torch.from_numpy(lengths), 0, scale,
        chunk=chunk, splits=splits)
    assert got.shape == (B, HQ, R) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), np.asarray(want, np.float32), **TOL)
    assert not f32(got)[0].any()
