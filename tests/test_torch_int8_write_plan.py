"""K4q's one-read vectorized write on the CPU: its launch plan
(``int8_write_plan``, with the kernel's lane-to-row map ``int8_write_lane``)
gives every (token, head, plane) row to exactly one group of lanes, aligned
inside a warp, whose lanes x units cover the row's width once, at Mistral's
widths, DeepSeek's latent planes, the narrow test widths, widths and
pointers that take the scalar path, and more heads than a block holds; and
K4q's plain version (quantize_kv + scatter) byte-equal to the JAX package's
``_quantize_kv`` followed by its Pallas INT8 write kernels in interpret
mode, on rows of zeros, rows whose values divide to exact halves, and the
latent widths. (K4q itself is held byte-equal to its plain version on a
card in test_torch_kernels.py and chip_smoke.py's phases 9a and 11a.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quick_tpu_torch.ops.paged_write as tpw
from quick_tpu.modules.paged_cache import _quantize_kv
from quick_tpu.ops.paged_write import paged_write_chunk as jax_write_chunk
from quick_tpu.ops.paged_write import paged_write_decode as jax_write_decode

#: (Hkv, Dk, Dv, tokens, aligned): Mistral's decode and chunk, DeepSeek's
#: latent decode and chunk, the narrow test widths, widths of no whole unit
#: or above a lane's units, pointers off 16 bytes, 32 heads (two blocks a token)
PLAN_CASES = {
    "mistral_decode": (8, 128, 128, 64, True),
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


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_int8_write_plan_covers_every_row_once(case, kind):
    Hkv, Dk, Dv, tokens, aligned = PLAN_CASES[case]
    plan = tpw.int8_write_plan(Hkv, Dk, Dv, kind, tokens, aligned)
    values = tpw.WRITE_UNIT[kind]
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    gx, gy = plan.grid(tokens, Hkv)
    assert gy <= 65535
    groups = {}  # (plane, token, head) -> [(block, thread, lane)]
    for bx in range(gx):
        for by in range(gy):
            warp_paths = {}
            for t in range(plan.threads):
                got = tpw.int8_write_lane(plan, tokens, Hkv, bx, by, t)
                if got is None:
                    continue
                plane, n, h, lane = got
                groups.setdefault((plane, n, h), []).append(((bx, by), t, lane))
                # a warp's lanes all take the vector path or all the scalar one
                vec = (plan.vv if plane else plan.vk) > 0
                assert warp_paths.setdefault(t // 32, vec) == vec
    assert sorted(groups) == [(p, n, h) for p in (0, 1) for n in range(tokens)
                              for h in range(Hkv)]
    for (plane, _, _), lanes in groups.items():
        lg, V, D = (plan.lgv, plan.vv, Dv) if plane else (plan.lgk, plan.vk, Dk)
        G = 1 << lg
        blocks = {blk for blk, _, _ in lanes}
        threads = sorted(t for _, t, _ in lanes)
        assert len(blocks) == 1 and sorted(lane for _, _, lane in lanes) == list(range(G))
        # one aligned group of G consecutive lanes inside one warp
        assert threads == list(range(threads[0], threads[0] + G)) and threads[0] % G == 0
        if V == 0:  # the scalar path: a warp a row, the lanes stride over D
            assert G == 32
            assert not aligned or D % values or D // values > 32 * tpw.WRITE_MAX_UNITS
            continue
        assert aligned and D % values == 0
        units = [lane + G * v for lane in range(G) for v in range(V) if lane + G * v < D // values]
        assert sorted(units) == list(range(D // values))
        assert (V - 1) * G * values < D <= V * G * values and V <= tpw.WRITE_MAX_UNITS


def test_int8_write_plan_shapes():
    """The plans the kernel's design note names: 16 lanes a 128-wide bf16
    row, 8 for the 64-wide k_pe, a warp of two units for the 512-wide
    latent; a block of one Mistral token, of six latent tokens; the scalar
    path, a warp a row, for pointers off 16 bytes."""
    assert tpw.int8_write_plan(8, 128, 128, 0, 64) == (4, 1, 4, 1, 1, 8)
    assert tpw.int8_write_plan(1, 64, 512, 0, 16) == (3, 1, 5, 2, 6, 1)
    assert tpw.int8_write_plan(8, 128, 128, 0, 64, aligned=False) == (5, 0, 5, 0, 1, 4)


# ----------------------------------------- K4q's plain version against JAX

def _edge_rows(rng, B, S, Hkv, D, halves, scale=3.0):
    """Random rows; slot 1's first row zeros, slot 0's first token's last
    head led by ``halves``, values that divide to exact halves (amax 127:
    scale 1.0; amax 63.5: scale 0.5). Both slots' first tokens are written."""
    x = (rng.standard_normal((B, S, Hkv, D)) * scale).astype(np.float32)
    x[1, 0, 0] = 0.0
    x[0, 0, -1, :len(halves)] = halves
    return x


HALVES_K = [127.0, 0.5, -0.5, 1.5, 2.5, -2.5, 126.5, -125.5]  # scale 1.0
HALVES_V = [63.5, 0.25, -0.75, 31.75]  # scale 0.5


def _jax_quantized_write(entry, kc, vc, tiles, kf, vf, pgs, offs, valid, dtype):
    jk, jks = _quantize_kv(jnp.asarray(kf, dtype))
    jv, jvs = _quantize_kv(jnp.asarray(vf, dtype))
    j = lambda t: jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)  # noqa: E731
    if entry == "decode":
        return jax_write_decode(j(kc), j(vc), jk[:, 0], jv[:, 0], j(pgs[:, 0]), j(offs), 1,
                                kv_scales=j(tiles), ks_new=jks[:, 0], vs_new=jvs[:, 0],
                                interpret=True)
    return jax_write_chunk(j(kc), j(vc), jk, jv, j(pgs), j(offs), j(valid), 1,
                           kv_scales=j(tiles), ks_new=jks, vs_new=jvs, interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["decode", "chunk"])
@pytest.mark.parametrize("widths", [(2, 16, 16), (1, 64, 512)])
def test_int8_write_plain_matches_jax_quantize_and_pallas(rng, widths, entry, dtype):
    """Float rows through the port's write (quantized in the call, as K4q
    does) leave codes and scale tiles byte-equal to the JAX package's
    _quantize_kv + _write_kernel_quant / _chunk_write_kernel_quant
    (interpret): page-crossing, masked and trash-page writes; page 0 is
    not compared."""
    Hkv, Dk, Dv = widths
    L, P, page, S = 2, 9, 32, 8
    kc, ks = tpw.quantize_kv(torch.from_numpy(rng.standard_normal((L, P, Hkv, page, Dk))
                                              .astype(np.float32)))
    vc, vs = tpw.quantize_kv(torch.from_numpy(rng.standard_normal((L, P, Hkv, page, Dv))
                                              .astype(np.float32)))
    tiles = torch.zeros((L, P, 8, Hkv * page))
    tiles[:, :, 0], tiles[:, :, 1] = ks.reshape(L, P, -1), vs.reshape(L, P, -1)
    n = 1 if entry == "decode" else S
    kf = _edge_rows(rng, 3, n, Hkv, Dk, HALVES_K)
    vf = _edge_rows(rng, 3, n, Hkv, Dv, HALVES_V, scale=1.0)
    pgs = np.asarray([[3, 4], [5, 0], [0, 0]], np.int32)
    offs = np.asarray([28, 2, 9], np.int32)  # crossing, inside, trash
    valid = np.asarray([S, 5, S], np.int32)
    ref = _jax_quantized_write(entry, kc, vc, tiles, kf, vf, pgs, offs, valid, jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    kt, vt = torch.from_numpy(kf).to(tdt), torch.from_numpy(vf).to(tdt)
    got = [t.clone() for t in (kc, vc, tiles)]
    if entry == "decode":
        tpw.paged_write_decode(*got[:2], kt[:, 0], vt[:, 0], torch.from_numpy(pgs[:, 0]),
                               torch.from_numpy(offs), 1, kv_scales=got[2])
    else:
        tpw.paged_write_chunk(*got[:2], kt, vt, torch.from_numpy(pgs), torch.from_numpy(offs),
                              torch.from_numpy(valid), 1, kv_scales=got[2])
    for a, b in zip(got, ref):  # bytes: int8 codes, f32 scales by their bits
        view = np.uint8 if a.dtype == torch.int8 else np.uint32
        np.testing.assert_array_equal(a.numpy()[:, 1:].view(view), np.asarray(b)[:, 1:].view(view))
    # the zero rows' scales are 1e-8, their codes 0; the halves round to even
    (kq, ksc), (vq, vsc) = tpw.quantize_kv(kt), tpw.quantize_kv(vt)
    for q, sc in ((kq, ksc), (vq, vsc)):
        assert not q[1, 0, 0].any() and sc[1, 0, 0] == torch.tensor(1e-8)
    assert ksc[0, 0, -1] == 1.0 and vsc[0, 0, -1] == 0.5
    assert kq[0, 0, -1, :8].tolist() == [127, 0, 0, 2, 2, -2, 126, -126]
    assert vq[0, 0, -1, :4].tolist() == [127, 0, -2, 64]
