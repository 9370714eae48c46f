"""K4's one-read copy on the CPU: its launch plan (``copy_write_plan``, K4q's
``int8_write_plan`` in the copy kind over the rows' bytes), the kernel's
lane-to-row map (``int8_write_lane``) and each lane's units
(``write_lane_units``) write every 16-byte unit of every (token, head,
plane) row exactly once, or every element once on the scalar path, at
Mistral's and DeepSeek's widths in bf16 and f32, narrow and unequal
widths, widths of no whole unit, pointers off 16 bytes and more heads than
a block holds; and a numpy model of the kernel driven by that map (span
addressing, ``valid``, the bad-index guard) leaves pages byte-equal to the
port's plain scatter and to the JAX package's Pallas write kernels in
interpret mode. (K4 itself is held byte-equal to its plain version on a
card in test_torch_kernels.py and chip_smoke.py's phases 2 and 11a.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quick_tpu_torch.ops.paged_write as tpw
from quick_tpu.ops.paged_write import paged_write_chunk as jax_write_chunk
from quick_tpu.ops.paged_write import paged_write_decode as jax_write_decode

#: (Hkv, Dk, Dv, tokens, aligned) in values: Mistral's Engine decode and
#: chunk, DeepSeek's latent decode and chunk, narrow and unequal widths, a
#: width of no whole 16 bytes (bf16 20 / 36: 40 / 72 bytes), a row above a
#: lane group's units in bf16 (4096 bytes), pointers off 16 bytes, 32 heads
PLAN_CASES = {
    "mistral_decode": (8, 128, 128, 16, True),
    "mistral_chunk": (8, 128, 128, 128, True),
    "latent_decode": (1, 64, 512, 16, True),
    "latent_chunk": (1, 64, 512, 128, True),
    "narrow": (2, 16, 16, 24, True),
    "unequal_narrow": (2, 16, 48, 7, True),
    "scalar_width": (2, 20, 36, 5, True),
    "wide_row": (1, 64, 2048, 3, True),
    "misaligned": (8, 128, 128, 9, False),
    "many_heads": (32, 128, 128, 3, True),
}


def _lane_writes(plan, tokens, Hkv, Dk_bytes, Dv_bytes):
    """{(plane, token, head): [(block, thread, lane, kind, items)]} over
    every thread of the grid, as the kernel assigns them."""
    gx, gy = plan.grid(tokens, Hkv)
    out = {}
    for bx in range(gx):
        for by in range(gy):
            for t in range(plan.threads):
                got = tpw.int8_write_lane(plan, tokens, Hkv, bx, by, t)
                if got is None:
                    continue
                plane, n, h, lane = got
                kind, items = tpw.write_lane_units(plan, plane, lane,
                                                   Dv_bytes if plane else Dk_bytes, tpw.COPY_KIND)
                out.setdefault((plane, n, h), []).append(((bx, by), t, lane, kind, items))
    return out


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_copy_write_plan_writes_every_unit_once(case, esize):
    Hkv, Dk, Dv, tokens, aligned = PLAN_CASES[case]
    plan = tpw.copy_write_plan(Hkv, Dk, Dv, esize, tokens, aligned)
    assert plan == tpw.int8_write_plan(Hkv, Dk * esize, Dv * esize, tpw.COPY_KIND, tokens, aligned)
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.grid(tokens, Hkv)[1] <= 65535
    writes = _lane_writes(plan, tokens, Hkv, Dk * esize, Dv * esize)
    assert sorted(writes) == [(p, n, h) for p in (0, 1) for n in range(tokens) for h in range(Hkv)]
    for (plane, _, _), lanes in writes.items():
        nbytes = (Dv if plane else Dk) * esize
        G = 1 << (plan.lgv if plane else plan.lgk)
        threads = sorted(t for _, t, _, _, _ in lanes)
        assert len({blk for blk, *_ in lanes}) == 1
        assert threads == list(range(threads[0], threads[0] + G)) and threads[0] % G == 0
        kinds = {k for *_, k, _ in lanes}
        assert len(kinds) == 1
        items = sorted(i for *_, i_list in lanes for i in i_list)
        if kinds == {"values"}:  # the scalar path: every byte once, a warp a row
            assert G == 32 and items == list(range(nbytes))
            assert not aligned or nbytes % 16 or nbytes // 16 > 32 * tpw.WRITE_MAX_UNITS
        else:  # every 16-byte unit once
            assert aligned and nbytes % 16 == 0 and items == list(range(nbytes // 16))


def test_copy_write_plan_shapes():
    """The plans K4's design note names: Mistral's bf16 rows 16 lanes of one
    unit, its 8 heads x two planes one token a block of 256 lanes; the
    latent planes 8 + 32 lanes (two units a lane), six tokens a block; f32
    rows 32 lanes; the scalar path for pointers off 16 bytes."""
    assert tpw.copy_write_plan(8, 128, 128, 2, 16) == (4, 1, 4, 1, 1, 8)
    assert tpw.copy_write_plan(8, 128, 128, 2, 16).threads == 256
    assert tpw.copy_write_plan(1, 64, 512, 2, 16) == (3, 1, 5, 2, 6, 1)
    assert tpw.copy_write_plan(8, 128, 128, 4, 16) == (5, 1, 5, 1, 1, 4)
    assert tpw.copy_write_plan(8, 128, 128, 2, 16, aligned=False) == (5, 0, 5, 0, 1, 4)


def _model_write(pages, new, page_ids, offs, valid, layer, plan):
    """K4 in numpy, lane by lane: (k, v) uint8 page stacks [L, P, Hkv, page,
    bytes] written from uint8 rows [B, S, Hkv, bytes] through the plan's
    lane map and units, with the kernel's addressing and guard."""
    B, S, Hkv = new[0].shape[:3]
    P, page = pages[0].shape[1], pages[0].shape[3]
    n_pg = page_ids.shape[1]
    for (plane, n, h), lanes in _lane_writes(plan, B * S, Hkv, new[0].shape[-1],
                                             new[1].shape[-1]).items():
        b, i = divmod(n, S)
        r = int(offs[b]) + i
        second = r >= page
        pg = int(page_ids[b, 1 if second and n_pg > 1 else 0])
        row = r - page if second else r
        if (valid is not None and i >= valid[b]) or not (0 <= pg < P and 0 <= row < page):
            continue
        src, dst = new[plane][b, i, h], pages[plane][layer, pg, h, row]
        for *_, kind, items in lanes:
            for it in items:
                sl = slice(it, it + 1) if kind == "values" else slice(16 * it, 16 * it + 16)
                dst[sl] = src[sl]


def _as_bytes(t: torch.Tensor) -> np.ndarray:
    a = t.contiguous().view(torch.uint8) if t.dtype == torch.bfloat16 else t
    a = a.numpy()
    return a.reshape(*t.shape[:-1], -1).view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry", ["decode", "chunk"])
@pytest.mark.parametrize("widths", [(2, 16, 16), (1, 64, 512), (2, 20, 36)])
def test_copy_write_model_matches_plain_and_pallas(rng, widths, entry, dtype):
    """The lane model's pages equal the plain scatter's and the JAX Pallas
    write's (interpret) byte for byte outside the trash page 0: a page-
    crossing slot, an inside slot with a masked tail, a trash-page slot, and
    a slot whose page id lies outside the pool (no write)."""
    Hkv, Dk, Dv = widths
    L, P, page, S = 2, 9, 16, 8
    pages = [torch.from_numpy(rng.standard_normal((L, P, Hkv, page, D)).astype(np.float32))
             .to(dtype) for D in (Dk, Dv)]
    n = 1 if entry == "decode" else S
    new = [torch.from_numpy(rng.standard_normal((4, n, Hkv, D)).astype(np.float32)).to(dtype)
           for D in (Dk, Dv)]
    pgs = torch.tensor([[3, 4], [5, 0], [0, 0], [P + 3, 2]], dtype=torch.int32)
    offs = torch.tensor([12, 2, 9, 1], dtype=torch.int32)  # crossing, inside, trash, bad
    valid = torch.tensor([S, 5, S, S], dtype=torch.int32) if entry == "chunk" else None
    plan = tpw.copy_write_plan(Hkv, Dk, Dv, pages[0].element_size(), 4 * n)
    model = [_as_bytes(t).copy() for t in pages]
    ids = pgs[:, :1] if entry == "decode" else pgs
    _model_write(model, [_as_bytes(t) for t in new], ids.numpy(), offs.numpy(),
                 None if valid is None else valid.numpy(), 1, plan)
    ref = [t.clone() for t in pages]
    if entry == "decode":
        tpw.paged_write_plain(*ref, new[0][:3], new[1][:3], pgs[:3, :1].expand(3, 2),
                              offs[:3], None, 1)
    else:
        tpw.paged_write_plain(*ref, new[0][:3], new[1][:3], pgs[:3], offs[:3], valid[:3], 1)
    for m, r in zip(model, ref):
        np.testing.assert_array_equal(m[:, 1:], _as_bytes(r)[:, 1:])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = lambda t: jnp.asarray(t.float().numpy(), jdt)  # noqa: E731
    ji = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    if entry == "decode":
        jk, jv = jax_write_decode(j(pages[0]), j(pages[1]), j(new[0][:3, 0]), j(new[1][:3, 0]),
                                  ji(pgs[:3, 0]), ji(offs[:3]), 1, interpret=True)
    else:
        jk, jv = jax_write_chunk(j(pages[0]), j(pages[1]), j(new[0][:3]), j(new[1][:3]),
                                 ji(pgs[:3]), ji(offs[:3]), ji(valid[:3]), 1, interpret=True)
    for m, jt in zip(model, (jk, jv)):
        got = torch.from_numpy(np.array(jt, np.float32)).to(dtype)
        np.testing.assert_array_equal(m[:, 1:], _as_bytes(got)[:, 1:])
