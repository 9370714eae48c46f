"""K3's key split on the CPU: the split plan covers every visible key once
at every length, the plain model of the split-and-merge arithmetic
(``fused_decode_attention_split_plain``) against the Pallas fused step in
interpret mode, and ``QUICK_TPU_FUSED_STEP=0`` turning the fused route
off. (K3 itself is held against its plain version in
test_torch_kernels.py, on a card.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu.ops.alibi import alibi_slopes
from quick_tpu.ops.fused_decode_step import fused_decode_attention as jax_fused
import quick_tpu_torch.ops.decode_attention as tdda
import quick_tpu_torch.ops.fused_decode_step as tfused

H100_SMS = 132


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("S", [256, 1536])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_split_plan_covers_every_key_once(B, S, window):
    """For every length in [0, S) the splits' ranges cover each key of
    [window start, length) exactly once and nothing else (never the new
    position), each inside the 64-key tiles its block walks; the plan is
    K7's over B x Hkv blocks, from the shapes alone."""
    Hkv, gq = 8, 4
    chunk, splits = tfused.split_plan(B, Hkv, gq, S, H100_SMS)
    assert (chunk, splits) == tdda.split_plan(B, Hkv, S, H100_SMS)
    assert chunk % 64 == 0 and splits * chunk >= S and (splits - 1) * chunk < S
    # gq = 32 takes two blocks a kv head: the plan counts them
    assert tfused.split_plan(B, Hkv, 32, S, H100_SMS) == tdda.split_plan(B, 2 * Hkv, S, H100_SMS)
    for length in range(S):
        seen = np.zeros(S + 1, np.int64)
        for sp in range(splits):
            lo, hi = tfused.split_range(sp, chunk, length, window)
            if lo >= hi:
                continue
            assert sp * chunk <= lo and hi <= (sp + 1) * chunk
            t_begin = lo // 64 * 64
            assert t_begin >= sp * chunk  # the first tile starts inside the chunk
            seen[lo:hi] += 1
        first = max(0, length - window + 1) if window else 0
        want = np.zeros(S + 1, np.int64)
        want[first:length] = 1
        assert np.array_equal(seen, want), length


SPLIT_CASES = {
    "rope": {},
    "softcap": dict(logit_softcap=30.0),
    "alibi": dict(use_rope=False, alibi=True),
    "window": dict(window=40),
}


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 255])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_model_matches_pallas_interpret(rng, case, length):
    """The split-and-merge arithmetic (per-split partials over 64-key
    tiles, merged in split order, then the new token) against the Pallas
    fused step in interpret mode, in f32, at 4 splits of 64 keys: the
    output within test_fused_step_plain_matches_pallas_interpret's
    tolerance, and the cache written at ``length`` only."""
    B, hq, hkv, S, D, L = 2, 4, 2, 256, 64, 2
    q = rng.standard_normal((B, hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    kc = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    ang = rng.uniform(0, 6.28, size=(B, D // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    kw = dict(SPLIT_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = alibi_slopes(hq)
    jkw = {k: (jnp.asarray(v) if k == "alibi_slopes" else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if k == "alibi_slopes" else v) for k, v in kw.items()}
    ref, kref, vref = jax_fused(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc, cos, sin)),
        jnp.asarray(length, jnp.int32), 1, interpret=True, **jkw,
    )
    chunk, splits = tfused.split_plan(B, hkv, hq // hkv, S, H100_SMS)
    assert (chunk, splits) == (64, 4)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = tfused.fused_decode_attention_split_plain(
        *(torch.from_numpy(a) for a in (q, kn, vn)), tk, tv,
        torch.from_numpy(cos), torch.from_numpy(sin),
        torch.tensor([length], dtype=torch.int32), 1, D ** -0.5,
        chunk=chunk, splits=splits, **tkw,
    )
    tol = dict(atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(f32(out), f32(ref), **tol)
    np.testing.assert_allclose(f32(tk), f32(kref), **tol)
    np.testing.assert_allclose(f32(tv), f32(vref), **tol)
    if length == 0:  # only the new token counts
        np.testing.assert_allclose(f32(out), np.repeat(vn, hq // hkv, axis=1), **tol)


def test_fused_step_switch_changes_the_route(monkeypatch):
    """On a CUDA device (no card needed to decide) the fused step takes a
    small dense cache's decode; QUICK_TPU_FUSED_STEP=0 turns it off, as the
    JAX gate does, and the step falls to K7 or the einsum."""
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.modules import blocks as tblocks
    from quick_tpu_torch.runtime import make_cache

    cfg = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=64)
    B, T = 4, 32
    cache = make_cache(cfg, B, T, device="cpu")
    rope_cos = torch.zeros((64, cfg.head_dim // 2))
    cuda = torch.device("cuda")
    monkeypatch.delenv("QUICK_TPU_FUSED_STEP", raising=False)
    assert tblocks.dense_decode_route(cfg, cache, B, rope_cos, 0, cuda) == "fused"
    monkeypatch.setenv("QUICK_TPU_FUSED_STEP", "0")
    assert tblocks.dense_decode_route(cfg, cache, B, rope_cos, 0, cuda) == "einsum"
    monkeypatch.setattr(tblocks, "_use_dense_decode_kernel", lambda *a: True)
    assert tblocks.dense_decode_route(cfg, cache, B, rope_cos, 0, cuda) == "dense_kernel"
    monkeypatch.setenv("QUICK_TPU_FUSED_STEP", "1")
    assert tblocks.dense_decode_route(cfg, cache, B, rope_cos, 0, cuda) == "fused"
