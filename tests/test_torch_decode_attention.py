"""Port parity for the dense-cache decode attention (K7's plain version)
and the einsum decode: the same numpy inputs through
``quick_tpu.ops.decode_attention.dense_decode_attention`` (the Pallas
kernel in interpret mode) and ``quick_tpu.ops.attention.decode_attention``,
and through their counterparts in the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu.ops import attention as jattn
from quick_tpu.ops import decode_attention as jdda
from quick_tpu_torch.ops import attention as tattn
from quick_tpu_torch.ops import decode_attention as tdda

# f32: both run the same chunked online softmax in f32, summing in other
# orders. bf16: the same, with the output rounded to bf16 (one step, 2^-8
# relative) and p rounded to bf16 before p @ v in both
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def alibi_slopes(n_heads: int) -> np.ndarray:
    return 2.0 ** (-8.0 * np.arange(1, n_heads + 1, dtype=np.float32) / n_heads)


def _inputs(seed, L, B, Hq, Hkv, T, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(dtype) for a in arrs])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["plain", "softcap", "alibi", "softcap_alibi"])
def test_dense_decode_matches_pallas_interpret(dtype, case):
    """Per-row lengths across two 128-key chunks, a length-0 row and a
    full row; layer 1 of a 2-layer stack."""
    L, B, Hq, Hkv, T, D = 2, 5, 8, 2, 256, 64
    q, k, v = _inputs(0, L, B, Hq, Hkv, T, D)
    lengths = np.array([1, 0, 129, 256, 77], np.int32)
    softcap = 30.0 if "softcap" in case else None
    slopes = alibi_slopes(Hq) if "alibi" in case else None
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    ref = jdda.dense_decode_attention(
        jq, jk, jv, jnp.asarray(lengths), layer=1,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        logit_softcap=softcap, interpret=True)
    out = tdda.dense_decode_attention(
        tq, tk, tv, torch.from_numpy(lengths), layer=1,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        logit_softcap=softcap)
    assert out.dtype == dtype and tuple(out.shape) == (B, Hq, D)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL[dtype])
    assert not f32(out)[1].any()  # length 0 -> zeros


@pytest.mark.parametrize("shape", [(4, 1, 32, 4), (2, 3, 64, 2)])
def test_dense_decode_layer_view_and_query_rank(shape):
    """A single [B, Hkv, T, D] layer and a [B, 1, Hq, D] query, scalar
    length (the JAX call's other accepted forms), in f32."""
    B, Hkv_mul, T, Hkv = shape
    Hq, D = Hkv * Hkv_mul, 32
    q, k, v = _inputs(1, 1, B, Hq, Hkv, T, D)
    ref = jdda.dense_decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k[0]),
                                      jnp.asarray(v[0]), T - 3, interpret=True)
    out = tdda.dense_decode_attention(torch.from_numpy(q)[:, None], torch.from_numpy(k[0]),
                                      torch.from_numpy(v[0]), T - 3)
    assert tuple(out.shape) == (B, 1, Hq, D)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL[torch.float32])


@pytest.mark.parametrize("B,Hq,Hkv,T,D", [(1, 32, 8, 256, 128), (32, 32, 8, 256, 128),
                                          (4, 32, 8, 2048, 128), (3, 4, 4, 100, 64),
                                          (2, 8, 8, 4096, 256), (64, 6, 3, 24, 64)])
def test_supports_and_tiles_match(B, Hq, Hkv, T, D):
    assert tdda.supports(B, Hq, Hkv, T, D) == jdda.supports(B, Hq, Hkv, T, D)
    assert tdda._pick_tiles(B, Hkv, T, D) == jdda._pick_tiles(B, Hkv, T, D)


@pytest.mark.parametrize("B,T,sms", [(32, 256, 132), (4, 2048, 132), (64, 256, 132),
                                     (16, 512, 132), (1, 100, 132), (2, 8, 4)])
def test_split_plan_covers_the_keys(B, T, sms):
    """K7's key split: whole 64-key tiles, every key in exactly one chunk,
    no empty trailing chunk, and at least one block per SM where T allows
    (the plan aims at two; whole tiles round the split count down)."""
    Hkv = 8
    chunk, splits = tdda.split_plan(B, Hkv, T, sms)
    assert chunk % tdda.TILE == 0 and splits >= 1
    assert (splits - 1) * chunk < T <= splits * chunk
    assert B * Hkv * splits >= min(sms, B * Hkv * -(-T // tdda.TILE))


@pytest.mark.parametrize("heads_major", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_einsum_decode_attention_matches(heads_major, per_row):
    B, Hq, Hkv, T, D = 3, 8, 2, 40, 32
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    shape = (B, Hkv, T, D) if heads_major else (B, T, Hkv, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    slopes = alibi_slopes(Hq)
    lens = np.array([5, 40, 17], np.int32) if per_row else 23
    ref = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        alibi_slopes=jnp.asarray(slopes), kv_heads_major=heads_major)
    out = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens) if per_row else lens,
        alibi_slopes=torch.from_numpy(slopes), kv_heads_major=heads_major)
    np.testing.assert_allclose(f32(out), f32(ref), atol=1e-5, rtol=1e-5)


def test_model_decode_through_the_dense_kernel_path(monkeypatch):
    """The block's dense-decode branch (the whole cache stack, the layer
    index and the [B] lengths built once per forward), taken on the CPU with
    K7's plain version, against the JAX model with its dense decode kernel
    forced (interpret mode): the same decode logits."""
    from quick_tpu import ModelConfig as JaxConfig
    from quick_tpu.models import init_quant_params, model_forward as jax_forward
    from quick_tpu.runtime import make_cache as jax_cache
    from quick_tpu.utils.checkpoint import params_to_flat
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.models import model as tmodel
    from quick_tpu_torch.models.convert import params_from_flat
    from quick_tpu_torch.modules import blocks as tblocks
    from quick_tpu_torch.runtime import make_cache

    tiny = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
    jcfg, tcfg = JaxConfig(**tiny), ModelConfig(**tiny)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_flat(params_to_flat(jparams), tcfg, device="cpu")
    seen = []

    def gate(B, Hq, Hkv, cache, D, device):
        seen.append(B)
        return True

    monkeypatch.setattr(tblocks, "_use_dense_decode_kernel", gate)
    monkeypatch.setenv("QUICK_TPU_DENSE_KERNEL", "1")
    monkeypatch.setenv("QUICK_TPU_FUSED_STEP", "0")
    B, S, T = 3, 6, 32
    toks = np.random.default_rng(5).integers(0, 256, (B, S + 3)).astype(np.int32)
    jc, tc = jax_cache(jcfg, B, T), make_cache(tcfg, B, T, device="cpu")
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks[:, :S]), jc)
    tl, tc = tmodel.model_forward(tparams, tcfg, torch.from_numpy(toks[:, :S]).long(), tc)
    for t in range(S, S + 3):
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tmodel.model_forward(tparams, tcfg, torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=3e-2, rtol=3e-2)
    assert len(seen) >= 3 * (1 + tcfg.num_hidden_layers)  # once per forward + per layer


def test_dense_decode_route_is_one_decision(monkeypatch):
    """model_forward and attention_forward read one route per layer: the
    fused step where its gate holds, K7 where the dense gate holds and no
    sliding window binds, the einsum otherwise; the K7 route without the
    [B] lengths of model_forward raises instead of building them."""
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.modules import blocks as tblocks
    from quick_tpu_torch.runtime import make_cache

    cfg = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=64, sliding_window=16,
                      sliding_window_pattern=2)  # layer 0 slides, layer 1 is global
    params = init_quant_params(cfg, device="cpu")
    B, T = 3, 32
    cache = make_cache(cfg, B, T, device="cpu")
    cpu = torch.device("cpu")

    def route(i):
        return tblocks.dense_decode_route(cfg, cache, B, params.rope_cos, i, cpu)

    assert [route(0), route(1)] == ["einsum", "einsum"]  # no kernel on the CPU
    monkeypatch.setattr(tblocks, "_use_dense_decode_kernel", lambda *a: True)
    assert [route(0), route(1)] == ["einsum", "dense_kernel"]  # the window binds at 0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, 1, 128))
                         .astype(np.float32)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="decode_lengths"):
        tblocks.attention_forward(params.blocks[1].attn, cfg, x, params.rope_cos,
                                  params.rope_sin, cache, 1, torch.zeros((B, 1), dtype=torch.long))
    monkeypatch.setattr(tblocks, "_use_fused_decode_step", lambda *a: True)
    assert [route(0), route(1)] == ["fused", "fused"]
