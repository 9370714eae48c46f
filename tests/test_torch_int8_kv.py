"""Port parity for INT8 KV pages: ``quantize_kv``, ``PagedKVCache(int8)``
(update on every route, the scale tiles, the dequantizing ``layer``), the
plain versions of K4q (INT8 page writes), K5q (INT8 paged decode attention)
and K6q (INT8 paged chunk attention) against the JAX package's Pallas
kernels in interpret mode, a tiny model's paged forward over INT8 pages,
and the Engine's greedy streams with ``dtype=int8`` against the JAX Engine
with ``dtype=jnp.int8``. Codes and scale tiles must be byte-equal; pages
are compared outside page 0, the trash page, which takes colliding junk
writes in both packages. (K4q, K5q and K6q themselves are held against
these plain versions on a card in test_torch_kernels.py.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.modules.paged_cache import PagedKVCache as JCache
from quick_tpu.modules.paged_cache import _quantize_kv
from quick_tpu.ops.alibi import alibi_slopes
from quick_tpu.ops.paged_attention import paged_chunk_attention as jax_chunk
from quick_tpu.ops.paged_attention import paged_decode_attention as jax_decode
from quick_tpu.ops.paged_write import paged_write_chunk as jax_write_chunk
from quick_tpu.ops.paged_write import paged_write_decode as jax_write_decode
from quick_tpu.runtime.serving import Engine as JaxEngine
from quick_tpu.utils.checkpoint import params_to_flat
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_decode_attention,
    quantize_q,
)
from quick_tpu_torch.ops.paged_write import paged_write_chunk, paged_write_decode, quantize_kv
from quick_tpu_torch.runtime import Engine

#: K5q / K6q plain versions against the Pallas kernels: the same arithmetic
#: in f32 (integer dots exact in both), so only exp and the order of the
#: float sums differ (measured ~4e-7). A flipped int8 rounding of q or p
#: would show as ~1e-2 and fail this.
ATOL_ATTN = 1e-4


def _tiles(ks, vs):
    """[L, P, 8, Hkv*page] scale tiles from per-(layer, page, head, token)
    k / v scales (row 0 k, row 1 v)."""
    L, P = ks.shape[:2]
    t = torch.zeros((L, P, 8, ks[0, 0].numel()))
    t[:, :, 0] = ks.reshape(L, P, -1)
    t[:, :, 1] = vs.reshape(L, P, -1)
    return t


def _j(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------- quantize_kv

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bytes(rng, dtype):
    x = (rng.standard_normal((3, 5, 4, 64)) * rng.uniform(0.01, 20, (3, 5, 4, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1e-8, codes 0
    x[1, 2, 3, :4] = [127.5, -0.5, 1.5, 2.5]  # halves round to even
    jc, js = _quantize_kv(jnp.asarray(x, jnp.dtype(dtype)))
    tc, ts = quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_quantize_q_matches_the_pallas_wrapper(rng):
    """K5q's query quantization equals paged_decode_attention's (:528-538),
    evaluated op by op (under jit XLA multiplies by fl(1/127) instead of
    dividing; see the Engine test)."""
    q = rng.standard_normal((3, 8, 64)).astype(np.float32)
    q[1, 2] = 0.0
    qf = jnp.asarray(q)
    sq = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-30) / 127.0
    codes = jnp.clip(jnp.round(qf / sq), -127, 127).astype(jnp.int8)
    tc, ts = quantize_q(torch.from_numpy(q))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(sq))


# --------------------------------------------------------- PagedKVCache(int8)

L, P, PAGE, H, D = 2, 9, 32, 2, 16
BT = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # max_seq 128

#: (tokens per write, per-slot starts) of each write. "decode" and the
#: chunks <= PAGE take the JAX package's Pallas write kernels with
#: QUICK_TPU_PAGED_WRITE=1 (its scatter with =0); a chunk longer than a
#: page takes the scatter in both packages.
UPDATES = {
    "decode": [(1, [0, 9]), (1, [31, 32]), (1, [32, 63])],
    "chunk_crossing_page": [(8, [28, 9]), (16, [40, 90]), (5, [63, 31])],
    "trash_page": [(1, [127, 128]), (8, [124, 200]), (16, [120, 127])],
    "scatter_longer_than_page": [(40, [0, 5]), (33, [40, 90])],
}


def _caches():
    jc = JCache.create(L, P, PAGE, max_slots=2, max_seq=128, n_kv=H, head_dim=D, dtype=jnp.int8)
    jc = dataclasses.replace(jc, block_table=jnp.asarray(BT))
    tc = PagedKVCache.create(L, P, PAGE, 2, 128, H, D, torch.int8, device="cpu")
    tc.block_table.copy_(torch.from_numpy(BT))
    assert tc.quantized and tc.kv_scales.shape == tuple(jc.kv_scales.shape)
    return jc, tc


@pytest.mark.parametrize("jax_route", ["write_kernels", "scatter"])
@pytest.mark.parametrize("case", list(UPDATES))
def test_update_matches_jax_bytes(rng, monkeypatch, case, jax_route):
    """The port's update (on the CPU: quantize + scatter) leaves codes and
    scale tiles byte-equal to the JAX update through its Pallas INT8 write
    kernels (interpret mode) or its scatter; the dequantized layer views
    are equal too."""
    monkeypatch.setenv("QUICK_TPU_PAGED_WRITE", "1" if jax_route == "write_kernels" else "0")
    jc, tc = _caches()
    for S, starts in UPDATES[case]:
        k = (rng.standard_normal((2, S, H, D)) * 3).astype(np.float32)
        v = rng.standard_normal((2, S, H, D)).astype(np.float32)
        jc = jc.update(1, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                       jnp.asarray(starts, jnp.int32))
        tc = tc.update(1, torch.from_numpy(k).to(torch.bfloat16),
                       torch.from_numpy(v).to(torch.bfloat16), torch.tensor(starts, dtype=torch.int32))
    np.testing.assert_array_equal(tc.k_pages.numpy()[:, 1:], np.asarray(jc.k_pages)[:, 1:])
    np.testing.assert_array_equal(tc.v_pages.numpy()[:, 1:], np.asarray(jc.v_pages)[:, 1:])
    np.testing.assert_array_equal(tc.kv_scales.numpy()[:, 1:], np.asarray(jc.kv_scales)[:, 1:])
    assert tc.kv_scales[:, 1:].abs().sum() > 0
    for i in range(L):
        for a, b in zip(tc.layer(i), jc.layer(i)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(f32(a), f32(b))


def test_select_merge_keep_the_scale_tiles():
    _, tc = _caches()
    ids, ok = torch.tensor([1, 0]), torch.tensor([True, False])
    sub = tc.select(ids, ok)
    assert sub.kv_scales is tc.kv_scales and sub.quantized
    merged = tc.merge(sub.with_length(torch.tensor([5, 9])), ids, ok)
    assert merged.kv_scales is tc.kv_scales and merged.length.tolist() == [0, 5]


# ------------------------------------------------------- K4q's plain version

def _pages_and_tiles(rng, Hkv, page, Dh):
    kc, ks = quantize_kv(torch.from_numpy(rng.standard_normal((L, P, Hkv, page, Dh)).astype(np.float32)))
    vc, vs = quantize_kv(torch.from_numpy(rng.standard_normal((L, P, Hkv, page, Dh)).astype(np.float32)))
    return kc, vc, _tiles(ks, vs)


@pytest.mark.parametrize("entry", ["decode", "chunk"])
def test_write_plain_matches_pallas_quant_kernels(rng, entry):
    """paged_write_decode / paged_write_chunk with kv_scales, given codes
    and scales (the JAX functions' signature), against _write_kernel_quant
    / _chunk_write_kernel_quant in interpret mode: page-crossing, masked
    (valid) and trash-page writes; then the float-row form (quantized in
    the call, as K4q does) writes the same bytes."""
    Hkv, page, Dh, S = 2, 32, 16, 8
    kc, vc, tiles = _pages_and_tiles(rng, Hkv, page, Dh)
    n = 1 if entry == "decode" else S
    kf = (rng.standard_normal((3, n, Hkv, Dh)) * 2).astype(np.float32)
    vf = rng.standard_normal((3, n, Hkv, Dh)).astype(np.float32)
    (kn, ksn), (vn, vsn) = quantize_kv(torch.from_numpy(kf)), quantize_kv(torch.from_numpy(vf))
    pgs = np.asarray([[3, 4], [5, 0], [0, 0]], np.int32)
    offs = np.asarray([28, 2, 9], np.int32)  # crossing, inside, trash
    valid = np.asarray([S, 5, S], np.int32)
    got = [t.clone() for t in (kc, vc, tiles)]
    if entry == "decode":
        ref = jax_write_decode(_j(kc), _j(vc), _j(kn[:, 0]), _j(vn[:, 0]), _j(pgs[:, 0]),
                               _j(offs), 1, kv_scales=_j(tiles), ks_new=_j(ksn[:, 0]),
                               vs_new=_j(vsn[:, 0]), interpret=True)
        out = paged_write_decode(*got[:2], kn[:, 0], vn[:, 0], torch.from_numpy(pgs[:, 0]),
                                 torch.from_numpy(offs), 1, kv_scales=got[2],
                                 ks_new=ksn[:, 0], vs_new=vsn[:, 0])
    else:
        ref = jax_write_chunk(_j(kc), _j(vc), _j(kn), _j(vn), _j(pgs), _j(offs), _j(valid), 1,
                              kv_scales=_j(tiles), ks_new=_j(ksn), vs_new=_j(vsn), interpret=True)
        out = paged_write_chunk(*got[:2], kn, vn, torch.from_numpy(pgs), torch.from_numpy(offs),
                                torch.from_numpy(valid), 1, kv_scales=got[2], ks_new=ksn,
                                vs_new=vsn)
    assert len(out) == 3 and all(a is b for a, b in zip(out, got))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy()[:, 1:], np.asarray(b)[:, 1:])
    again = [t.clone() for t in (kc, vc, tiles)]
    if entry == "decode":
        paged_write_decode(*again[:2], torch.from_numpy(kf[:, 0]), torch.from_numpy(vf[:, 0]),
                           torch.from_numpy(pgs[:, 0]), torch.from_numpy(offs), 1,
                           kv_scales=again[2])
    else:
        paged_write_chunk(*again[:2], torch.from_numpy(kf), torch.from_numpy(vf),
                          torch.from_numpy(pgs), torch.from_numpy(offs), torch.from_numpy(valid),
                          1, kv_scales=again[2])
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.numpy()[:, 1:], b.numpy()[:, 1:])


# ------------------------------------------------- K5q / K6q plain versions

ATTN_CASES = {
    "mha_ragged": dict(Hq=4, Hkv=4, D=64, page=32, lengths=[13, 100]),
    "gqa_page_aligned": dict(Hq=8, Hkv=2, D=64, page=32, lengths=[64, 5]),
    "mqa_single_token": dict(Hq=4, Hkv=1, D=32, page=32, lengths=[1, 40]),
    "window": dict(Hq=4, Hkv=2, D=32, page=32, lengths=[50, 90], window=40),
    "softcap": dict(Hq=4, Hkv=2, D=32, page=32, lengths=[19, 70], logit_softcap=30.0),
    "window_softcap": dict(Hq=4, Hkv=2, D=32, page=32, lengths=[33, 95], window=20,
                           logit_softcap=30.0),
    "alibi": dict(Hq=4, Hkv=2, D=32, page=32, lengths=[19, 66], alibi=True),
}
N_PT = 4


def _attn_inputs(rng, case, S=None):
    c = dict(ATTN_CASES[case])
    Hq, Hkv, Dh, page = c.pop("Hq"), c.pop("Hkv"), c.pop("D"), c.pop("page")
    per_slot = np.asarray(c.pop("lengths"), np.int32)
    if S is not None:  # chunk starts: the chunk ends inside the table
        per_slot = np.minimum(per_slot, N_PT * page - S)
    B = len(per_slot)
    kc, vc, tiles = _pages_and_tiles(rng, Hkv, page, Dh)
    bt = rng.permutation(np.arange(1, P))[: B * N_PT].reshape(B, N_PT).astype(np.int32)
    q = rng.standard_normal((B, Hq, Dh) if S is None else (B, S, Hq, Dh)).astype(np.float32)
    if c.pop("alibi", False):
        c["alibi_slopes"] = alibi_slopes(Hq)
    return (torch.from_numpy(q), kc, vc, torch.from_numpy(bt), torch.from_numpy(per_slot)), tiles, c


def _both_attn(fn_jax, fn_torch, args, tiles, kw):
    ref = fn_jax(*(_j(a) for a in args), layer=1, kv_scales=_j(tiles), interpret=True,
                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    out = fn_torch(*args, layer=1, kv_scales=tiles,
                   **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                      for k, v in kw.items()})
    return f32(out), f32(ref)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_decode_int8_plain_matches_pallas_interpret(rng, case):
    args, tiles, kw = _attn_inputs(rng, case)
    out, ref = _both_attn(jax_decode, paged_decode_attention, args, tiles, kw)
    np.testing.assert_allclose(out, ref, atol=ATOL_ATTN)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunk_int8_plain_matches_pallas_interpret(rng, case):
    """Chunk queries at starts + i, chunks crossing page boundaries."""
    args, tiles, kw = _attn_inputs(rng, case, S=4)
    out, ref = _both_attn(jax_chunk, paged_chunk_attention, args, tiles, kw)
    np.testing.assert_allclose(out, ref, atol=ATOL_ATTN)


# ------------------------------------------------------------ model, Engine

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_flat(params_to_flat(jparams), tcfg, device="cpu")


def test_paged_model_forward_int8_matches_jax(models, rng):
    """model_forward over INT8 pages with per-slot starts: a ragged chunk,
    then decode steps, against the JAX model on its INT8 paged cache (on
    the CPU both read the pages through the dequantizing layer()); the
    written codes and scale tiles are byte-equal."""
    jcfg, jparams, tcfg, tparams = models
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    jc = JCache.create(2, 9, 8, 3, 32, 2, 32, jnp.int8)
    jc = dataclasses.replace(jc, block_table=jnp.asarray(bt), length=jnp.asarray([0, 5, 0], jnp.int32))
    tc = PagedKVCache.create(2, 9, 8, 3, 32, 2, 32, torch.int8, device="cpu")
    tc.block_table.copy_(torch.from_numpy(bt))
    tc = tc.with_length(torch.tensor([0, 5, 0]))
    toks = rng.integers(0, 512, (3, 6)).astype(np.int32)
    valid = np.asarray([6, 4, 0], np.int32)  # a padding row of length 0
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks), jc, advance=jnp.asarray(valid),
                         last_valid=jnp.asarray(valid))
    tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks).long(), tc,
                           advance=torch.from_numpy(valid), last_valid=torch.from_numpy(valid))
    tol = dict(atol=3e-2, rtol=3e-2)  # as tests/test_torch_model.py
    np.testing.assert_allclose(f32(tl)[:2], f32(jl)[:2], **tol)
    for _ in range(2):
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        one = np.asarray([1, 1, 0], np.int32)
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(nxt), jc, advance=jnp.asarray(one),
                             last_valid=jnp.asarray(one))
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(nxt).long(), tc,
                               advance=torch.from_numpy(one), last_valid=torch.from_numpy(one))
        np.testing.assert_allclose(f32(tl)[:2], f32(jl)[:2], **tol)
    np.testing.assert_array_equal(tc.length.numpy(), [8, 11, 0])
    np.testing.assert_array_equal(tc.k_pages.numpy()[:, 1:], np.asarray(jc.k_pages)[:, 1:])
    np.testing.assert_array_equal(tc.v_pages.numpy()[:, 1:], np.asarray(jc.v_pages)[:, 1:])
    np.testing.assert_array_equal(tc.kv_scales.numpy()[:, 1:], np.asarray(jc.kv_scales)[:, 1:])


#: engine options per case (page 16 and chunk 8, as tests/test_torch_serving.py)
ENGINE_CASES = {
    "decode_window_4": dict(decode_window=4),
    # 7 usable pages: full reservation would need 2-3 per request
    "optimistic_preemption": dict(decode_window=2, prefill_rows=2, reserve="optimistic",
                                  n_pages=8),
    "prefix_cache_off": dict(decode_window=4, prefix_cache=False),
}


def _trace(seed: int = 0):
    """Six requests: a 16-token (one-page) shared prefix, then 2-19 own
    tokens; 8-23 new tokens each."""
    r = np.random.default_rng(seed)
    prefix = [int(t) for t in r.integers(0, 512, 16)]
    return [(prefix + [int(t) for t in r.integers(0, 512, int(r.integers(2, 20)))],
             int(r.integers(8, 24))) for _ in range(6)]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_int8_greedy_streams_match_jax(models, case):
    """Engine(dtype=torch.int8) against Engine(dtype=jnp.int8): token-equal
    greedy streams and the same schedule (every stats key, preemptions
    included). The pools are not compared byte for byte here: the JAX
    Engine's jitted step programs round a few k / v rows one bf16 step
    apart from its eager forward, and XLA rewrites ``amax / 127.0`` as
    ``amax * fl(1/127)`` under jit (its HLO shows the multiply); the writes
    themselves are held byte-equal above."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(max_slots=4, max_seq=64, page_size=16, chunk=8, **ENGINE_CASES[case])
    reqs = _trace()
    outs, engines = [], []
    for cls, params, cfg, extra in ((JaxEngine, jparams, jcfg, dict(dtype=jnp.int8)),
                                    (Engine, tparams, tcfg, dict(dtype=torch.int8, device="cpu"))):
        eng = cls(params, cfg, **kw, **extra)
        uids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        outs.append([res[u] for u in uids])
        engines.append(eng)
    jeng, teng = engines
    assert outs[1] == outs[0]
    assert [len(o) for o in outs[1]] == [n for _, n in reqs]
    for key, value in jeng.stats.items():
        assert teng.stats[key] == value, key
    if case == "optimistic_preemption":
        assert teng.stats["preemptions"] > 0
    assert teng.cache.quantized and teng.cache.kv_scales[:, 1:].abs().sum() > 0
