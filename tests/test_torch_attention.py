"""Port parity for attention: the golden einsum path, the plain flash
version (K2's contract) and the plain fused decode step (K3's contract)
against quick_tpu. (K2 and K3 themselves are held against their plain
versions in test_torch_kernels.py, on a card.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu.ops.alibi import alibi_slopes
from quick_tpu.ops.attention import causal_attention as jax_causal
from quick_tpu.ops.flash_attention import flash_attention as jax_flash
from quick_tpu.ops.fused_decode_step import fused_decode_attention as jax_fused
import quick_tpu_torch.ops.flash_attention as tflash
import quick_tpu_torch.ops.fused_decode_step as tfused
from quick_tpu_torch.ops.attention import causal_attention

CASES = {
    "plain": {},
    "offset_kvlen": dict(q_offset=[16, 40], kv_len=[80, 104]),
    "window": dict(window=24),
    "softcap": dict(logit_softcap=20.0),
    "alibi": dict(alibi=True),
}


def _qkv(rng, B, S, T, Hq, Hkv, D):
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return q, k, v


def _kwargs(case, Hq, to):
    kw = dict(CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = to(alibi_slopes(Hq))
    for key in ("q_offset", "kv_len"):
        if key in kw:
            kw[key] = to(np.asarray(kw[key], np.int32))
    return kw


@pytest.mark.parametrize("case", list(CASES))
def test_causal_attention_matches_jax(rng, case):
    B, S, T, Hq, Hkv, D = 2, 24, 128, 4, 2, 32
    q, k, v = _qkv(rng, B, S, T, Hq, Hkv, D)
    ref = jax_causal(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_heads_major=True,
        **_kwargs(case, Hq, jnp.asarray),
    )
    out = causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_heads_major=True, **_kwargs(case, Hq, torch.from_numpy),
    )
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_plain_matches_pallas_interpret(rng, case):
    """Plain K2 against the Pallas flash kernel in interpret mode, f32
    (atol as tests/test_flash_attention.py)."""
    B, S, T, Hq, Hkv, D = 2, 64, 128, 4, 2, 32
    q, k, v = _qkv(rng, B, S, T, Hq, Hkv, D)
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_heads_major=True,
        interpret=True, **_kwargs(case, Hq, jnp.asarray),
    )
    out = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_heads_major=True, **_kwargs(case, Hq, torch.from_numpy),
    )
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-3)


FUSED_CASES = {
    "rope": {},
    "no_rope_alibi": dict(use_rope=False, alibi=True),
    "window_softcap": dict(window=12, logit_softcap=30.0),
}


def _fused_inputs(rng, B=2, hq=4, hkv=2, S=32, D=64, L=2, length=19):
    q = rng.standard_normal((B, hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    kc = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    ang = rng.uniform(0, 6.28, size=(B, D // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    return q, kn, vn, kc, vc, cos, sin, length


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_step_plain_matches_pallas_interpret(rng, case):
    """Plain K3 against the Pallas fused step (interpret), output AND cache,
    f32 (tolerance as tests/test_decode_attention.py)."""
    q, kn, vn, kc, vc, cos, sin, length = _fused_inputs(rng)
    kw = dict(FUSED_CASES[case])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = alibi_slopes(q.shape[1])
    jkw = {k: (jnp.asarray(v) if k == "alibi_slopes" else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if k == "alibi_slopes" else v) for k, v in kw.items()}
    ref, kref, vref = jax_fused(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc, cos, sin)),
        jnp.asarray(length, jnp.int32), 1, interpret=True, **jkw,
    )
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, k2, v2 = tfused.fused_decode_attention(
        *(torch.from_numpy(a) for a in (q, kn, vn)), tk, tv,
        torch.from_numpy(cos), torch.from_numpy(sin),
        torch.tensor([length], dtype=torch.int32), 1, **tkw,
    )
    assert k2 is tk and v2 is tv  # written in place
    tol = dict(atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(f32(out), f32(ref), **tol)
    np.testing.assert_allclose(f32(tk), f32(kref), **tol)
    np.testing.assert_allclose(f32(tv), f32(vref), **tol)


@pytest.mark.parametrize(
    "scaling",
    [None, {"rope_type": "linear", "factor": 2.0},
     {"rope_type": "dynamic", "factor": 2.0, "original_max_position_embeddings": 32},
     {"rope_type": "llama3", "factor": 8.0, "original_max_position_embeddings": 16},
     {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32},
     {"rope_type": "longrope", "original_max_position_embeddings": 32,
      "long_factor": [1.0 + i / 16 for i in range(16)],
      "short_factor": [1.0] * 16}],
)
def test_rope_tables_and_apply_match(rng, scaling):
    from quick_tpu.ops.rope import apply_rope as japply, rope_table as jtable
    from quick_tpu_torch.ops.rope import apply_rope, rope_table

    jc, js = jtable(64, 32, 10000.0, scaling)
    tc, ts = rope_table(64, 32, 10000.0, scaling, device="cpu")
    np.testing.assert_allclose(f32(tc), f32(jc), atol=1e-5)
    np.testing.assert_allclose(f32(ts), f32(js), atol=1e-5)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 5))
    ref = japply(jnp.asarray(x), jnp.asarray(pos), jc, js)
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tc, ts)
    np.testing.assert_allclose(f32(out), f32(ref), atol=1e-5)


def test_layer_norm_matches(rng):
    from quick_tpu.ops.norms import layer_norm as jlayer_norm
    from quick_tpu_torch.ops.norms import layer_norm

    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 4, 64), (64,), (64,)))
    for bias in (b, None):
        ref = jlayer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                          None if bias is None else jnp.asarray(bias), 1e-5)
        out = layer_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                         None if bias is None else torch.from_numpy(bias), 1e-5)
        np.testing.assert_allclose(f32(out), f32(ref), atol=1e-2, rtol=1e-2)  # bf16 out


@pytest.mark.parametrize("local_theta", [None, 10000.0])
def test_local_rope_tables_match(local_theta):
    from quick_tpu import ModelConfig as JaxConfig
    from quick_tpu.ops.rope import local_rope_tables as jlocal
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.ops.rope import local_rope_tables

    kw = dict(hidden_size=128, num_attention_heads=4, max_position_embeddings=64,
              rope_theta=1e6, rope_local_theta=local_theta,
              rope_scaling={"rope_type": "linear", "factor": 8.0})
    ref = jlocal(JaxConfig(**kw))
    out = local_rope_tables(ModelConfig(**kw), device="cpu")
    if local_theta is None:
        assert ref == (None, None) and out == (None, None)
        return
    for o, r in zip(out, ref):
        np.testing.assert_allclose(f32(o), f32(r), atol=1e-5)
