"""Decoder blocks, dense llama path (port of ``quick_tpu/modules/blocks.py``).

The port covers the dense llama-family block: pre-RMSNorm, fused QKV and
gate_up linears, RoPE, the head-major dense KV cache or the paged cache,
attention (with the sliding window and the attention-logit softcap the
kernels take) and the SwiGLU MLP. The other families' switches (qk-norm,
sandwich norms, ALiBi, parallel residual, LayerNorm, plain MLPs, ...), MoE,
MLA, context parallelism and the layer-tail kernel are not ported yet: such
configs are refused by ``models/model.py::check_supported`` (ROADMAP.md).

The kernel gates mirror the JAX package's so that both take the same branch
on the same inputs, with the card in place of the TPU: the decode prologue
gate ``_fuse_decode_norm_ok`` (:142), the fused decode step gate
``_use_fused_decode_step`` (:159), the dense decode kernel gate
``_use_dense_decode_kernel`` (:115), the paged kernels' gate
``_use_paged_kernel`` (:99) and the chunk kernel's ``supports_chunk``. The
thresholds are the TPU's; a later slice re-derives them for the card
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.modules.cache import KVCache
from quick_tpu_torch.modules.linear import AnyLinear, QuantLinear
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.ops.attention import causal_attention
from quick_tpu_torch.ops.norms import rms_norm

AnyCache = Union[KVCache, PagedKVCache]


@dataclasses.dataclass
class AttentionParams:
    qkv_proj: AnyLinear  # fused [D, (Hq + 2*Hkv) * hd]
    o_proj: AnyLinear


@dataclasses.dataclass
class MLPParams:
    gate_up_proj: AnyLinear  # fused [D, 2*ffn]
    down_proj: AnyLinear


@dataclasses.dataclass
class BlockParams:
    attn_norm: torch.Tensor
    attn: AttentionParams
    mlp_norm: torch.Tensor
    mlp: MLPParams


def _use_paged_kernel(cache) -> bool:
    """Paged caches on the card read their pages with the paged-attention
    kernels K5 / K6 (the JAX package: on the TPU)."""
    return isinstance(cache, PagedKVCache) and cache.k_pages.is_cuda


def _use_dense_decode_kernel(B, Hq, Hkv, cache: KVCache, D, device) -> bool:
    """Dense-cache decode through K7 where the JAX package takes its dense
    decode kernel: caches of >= 8 MB of K+V per layer on the accelerator."""
    from quick_tpu_torch.ops.decode_attention import supports

    if isinstance(cache, PagedKVCache):
        return False
    if not supports(B, Hq, Hkv, cache.max_seq, D):
        return False
    if device.type != "cuda":
        return False
    return 2 * B * cache.max_seq * Hkv * D * 2 >= 8 << 20


def _fuse_decode_norm_ok(lin, x) -> bool:
    """Fold the pre-GEMM RMSNorm into the GEMM kernel's prologue? Decode
    rows (<= 8) of a G=128 quantized linear only."""
    if not isinstance(lin, QuantLinear) or lin.group_size != 128:
        return False
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return rows <= 8


def _use_fused_decode_step(cache: KVCache, B: int, hd: int, rope_cos, device) -> bool:
    """Gate for the fused rope + cache-write + attention kernel: B <= 8,
    full rotary, and a cache layer small enough for the TPU kernel's
    VMEM-resident blocks (3 MiB per batch row)."""
    from quick_tpu_torch.ops.fused_decode_step import group_for

    L, _, Hkv, Smax, D = cache.k.shape
    ok = (
        B <= 8
        and 2 * rope_cos.shape[-1] == hd
        and Smax % group_for(cache.k.dtype) == 0
        and Hkv * Smax * D * cache.k.element_size() <= 3 * 1024 * 1024
    )
    return ok and device.type == "cuda"


def _attention_window(cfg: ModelConfig, layer_idx: int, reach: int) -> Optional[int]:
    """The sliding window of this layer, dropped when it cannot bind (the
    whole reachable context fits in it) so the kernel paths stay live."""
    window = cfg.sliding_window if cfg.layer_is_sliding(layer_idx) else None
    return None if window is not None and reach <= window else window


def dense_decode_route(cfg: ModelConfig, cache: KVCache, B: int, rope_cos, layer_idx: int,
                       device) -> str:
    """The attention a one-token step over the dense cache takes at
    ``layer_idx``: "fused" (the fused decode step, K3), "dense_kernel" (K7,
    which reads the [B] lengths ``model_forward`` builds) or "einsum" (the
    plain attention over the cache view). ``model_forward`` and
    ``attention_forward`` both ask here."""
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if _use_fused_decode_step(cache, B, hd, rope_cos, device):
        return "fused"
    if _attention_window(cfg, layer_idx, cache.max_seq) is None and _use_dense_decode_kernel(
        B, hq, hkv, cache, hd, device
    ):
        return "dense_kernel"
    return "einsum"


def attention_forward(
    p: AttentionParams,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, D]
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    cache: Optional[AnyCache],
    layer_idx: int,
    positions: torch.Tensor,  # [B, S]
    pre_norm: Optional[tuple] = None,  # (rms_weight, eps): x is the RAW
    # residual and the norm runs in the qkv GEMM's prologue
    decode_lengths: Optional[torch.Tensor] = None,  # [B] int32 on x's
    # device: the dense cache's length + 1, for the dense decode kernel
) -> Tuple[torch.Tensor, Optional[AnyCache]]:
    from quick_tpu_torch.ops.rope import apply_rope

    B, S, _ = x.shape
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = p.qkv_proj(x, fuse_norm=pre_norm) if pre_norm is not None else p.qkv_proj(x)
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    window = _attention_window(cfg, layer_idx, cache.max_seq if cache is not None else S)
    softcap = cfg.attn_logit_softcap
    route = None
    if S == 1 and isinstance(cache, KVCache):
        route = dense_decode_route(cfg, cache, B, rope_cos, layer_idx, x.device)
    if route == "fused":
        from quick_tpu_torch.ops.fused_decode_step import fused_decode_attention

        pos0 = positions[:, 0]
        c = rope_cos[pos0].to(torch.float32)  # [B, hd/2]
        s_r = rope_sin[pos0].to(torch.float32)
        out, _, _ = fused_decode_attention(
            q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v,
            torch.cat([c, c], dim=-1), torch.cat([s_r, s_r], dim=-1),
            cache.length, layer_idx, window=window, logit_softcap=softcap,
        )  # writes the new k/v row into cache.k / cache.v in place
        return p.o_proj(out.reshape(B, S, hq * hd)), cache
    q = apply_rope(q, positions, rope_cos, rope_sin)
    k = apply_rope(k, positions, rope_cos, rope_sin)
    if cache is not None:
        start = cache.length  # host int (dense) or [B] device tensor (paged)
        cache = cache.update(layer_idx, k, v, start)  # in place
        if S == 1 and _use_paged_kernel(cache):
            from quick_tpu_torch.ops.paged_attention import paged_decode_attention

            # whole page stacks + layer index, as the JAX call site
            out = paged_decode_attention(
                q[:, 0], cache.k_pages, cache.v_pages, cache.block_table,
                start + 1, layer=layer_idx, window=window,
                logit_softcap=softcap,
            )[:, None]
            return p.o_proj(out.reshape(B, S, hq * hd)), cache
        if route == "dense_kernel":
            from quick_tpu_torch.ops.decode_attention import dense_decode_attention

            if decode_lengths is None:
                raise ValueError(
                    "the dense decode kernel reads the [B] lengths that "
                    "model_forward builds once per forward: pass decode_lengths"
                )
            # K7 over the whole cache stack + layer index, as the JAX call site
            out = dense_decode_attention(
                q, cache.k, cache.v, decode_lengths, layer=layer_idx,
                logit_softcap=softcap,
            )
            return p.o_proj(out.reshape(B, S, hq * hd)), cache
        if S > 1 and _use_paged_kernel(cache):
            from quick_tpu_torch.ops.paged_attention import (
                paged_chunk_attention,
                supports_chunk,
            )

            if supports_chunk(S, hq, hkv, cache.page_size):
                out = paged_chunk_attention(
                    q, cache.k_pages, cache.v_pages, cache.block_table, start,
                    layer=layer_idx, window=window, logit_softcap=softcap,
                )
                return p.o_proj(out.reshape(B, S, hq * hd)), cache
        k_all, v_all = cache.layer(layer_idx)  # [B, Hkv, T, D] head-major
        out = causal_attention(
            q, k_all, v_all, q_offset=start, kv_len=start + S,
            kv_heads_major=True, window=window, logit_softcap=softcap,
        )
    else:
        out = causal_attention(q, k, v, window=window, logit_softcap=softcap)
    return p.o_proj(out.reshape(B, S, hq * hd)), cache


def mlp_forward(
    p: MLPParams, x: torch.Tensor, pre_norm: Optional[tuple] = None,
) -> torch.Tensor:
    """SwiGLU MLP with fused gate + up."""
    gu = p.gate_up_proj(x, fuse_norm=pre_norm) if pre_norm is not None else p.gate_up_proj(x)
    if isinstance(p.down_proj, QuantLinear):
        # silu(gate) * up rides in the down GEMM's prologue at decode rows;
        # other routes gate first inside the call
        return p.down_proj(gu, fuse_glu=True)
    gate, up = torch.chunk(gu, 2, dim=-1)
    return p.down_proj(silu(gate) * up)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` with its rounding: x * (1 / (1 + exp(-x))), each op
    rounded to x's dtype (``F.silu`` rounds once, which in bf16 differs
    from the JAX package in a third of the values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def block_forward(
    p: BlockParams,
    cfg: ModelConfig,
    x: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    cache: Optional[AnyCache],
    layer_idx: int,
    positions: torch.Tensor,
    decode_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[AnyCache]]:
    eps = cfg.rms_norm_eps
    if _fuse_decode_norm_ok(p.attn.qkv_proj, x):
        # the norm rides in the qkv GEMM's prologue
        attn_out, cache = attention_forward(
            p.attn, cfg, x, rope_cos, rope_sin, cache, layer_idx, positions,
            pre_norm=(p.attn_norm, eps), decode_lengths=decode_lengths,
        )
    else:
        attn_out, cache = attention_forward(
            p.attn, cfg, rms_norm(x, p.attn_norm, eps), rope_cos, rope_sin,
            cache, layer_idx, positions, decode_lengths=decode_lengths,
        )
    x = x + attn_out
    if _fuse_decode_norm_ok(p.mlp.gate_up_proj, x):
        mlp_out = mlp_forward(p.mlp, x, pre_norm=(p.mlp_norm, eps))
    else:
        mlp_out = mlp_forward(p.mlp, rms_norm(x, p.mlp_norm, eps))
    return x + mlp_out, cache
