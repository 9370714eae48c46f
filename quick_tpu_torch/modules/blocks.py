"""Decoder blocks of the RMSNorm families, with dense or MoE MLPs, and
DeepSeek's MLA attention (port of ``quick_tpu/modules/blocks.py``).

The port covers the llama-family block and its RMSNorm relatives:
pre-RMSNorm (none for olmo2), fused QKV and gate_up linears, the per-head
(qwen3, gemma3) or full-width (olmo2) q / k RMSNorm, gemma2's query scale
(also granite's attention multiplier), RoPE (gemma3's local tables on its
sliding layers), the head-major dense KV cache or the paged cache, attention
(with the sliding window and the attention-logit softcap the kernels take),
the SwiGLU or GeGLU MLP, the post-norms on each sub-layer's output (gemma2,
gemma3, olmo2) and the residual multiplier (granite, minicpm), and the
sparse MoE MLP (``moe_forward``: the "mixtral", "softmax_all" and
"deepseek" routers, shared experts, ungated or gated by a sigmoid,
quantized experts through the grouped kernel K8, or K12 under
``QUICK_TPU_MOE_A8``); and the DeepSeek-V2 / V3 block, MLA attention
(``modules/mla.py``) with DeepSeekMoE. The LayerNorm families' switches
(LayerNorm, cohere's LayerNorm qk-norm, ALiBi, parallel residual, plain
MLPs, ...), expert and context parallelism are not ported yet: such
configs are refused by ``models/model.py::check_supported`` (ROADMAP.md).
Under ``QUICK_TPU_LAYER_TAIL=1`` a decode layer's post-attention tail
(o-proj, residual, MLP norm, SwiGLU MLP, residual) runs as one call of
``ops/fused_layer_tail.py`` (K14 on the card), gated by ``_use_layer_tail``
(:185) as in the JAX package.

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
import math
import os
from typing import Optional, Tuple, Union

import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.modules.cache import KVCache, write_start
from quick_tpu_torch.modules.linear import AnyLinear, Linear, QuantLinear, moe_a8_enabled
from quick_tpu_torch.modules.mla import MLAParams
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.ops.attention import causal_attention
from quick_tpu_torch.ops.norms import rms_norm

AnyCache = Union[KVCache, PagedKVCache]


@dataclasses.dataclass
class AttentionParams:
    qkv_proj: AnyLinear  # fused [D, (Hq + 2*Hkv) * hd]
    o_proj: AnyLinear
    #: qwen3-style per-head RMSNorm weights [head_dim], applied to q / k
    #: after the head reshape, before RoPE (cfg.use_qk_norm)
    q_norm: Optional[torch.Tensor] = None
    k_norm: Optional[torch.Tensor] = None


@dataclasses.dataclass
class MLPParams:
    gate_up_proj: AnyLinear  # fused [D, 2*ffn]
    down_proj: AnyLinear


@dataclasses.dataclass
class MoEParams:
    """Sparse MoE (``MoEParams`` :60): a float router and per-expert fused
    MLPs stacked on a leading expert axis; the optional always-on shared
    expert, its qwen2_moe sigmoid gate and the deepseek v3 selection bias."""

    router: Linear  # [D, E], kept float
    gate_up_proj: AnyLinear  # leading expert axis on each array
    down_proj: AnyLinear
    shared_gate_up: Optional[AnyLinear] = None  # [D, 2*F_shared]
    shared_down: Optional[AnyLinear] = None     # [F_shared, D]
    score_bias: Optional[torch.Tensor] = None   # [E], selection only
    shared_gate: Optional[AnyLinear] = None     # [D, 1] (qwen2_moe)


@dataclasses.dataclass
class BlockParams:
    attn_norm: Optional[torch.Tensor]  # None: no pre-norms (olmo2)
    attn: Union[AttentionParams, MLAParams]
    mlp_norm: Optional[torch.Tensor]
    mlp: Union[MLPParams, MoEParams]
    #: the sandwich norms of gemma2 / gemma3 and olmo2's post-norms: an
    #: RMSNorm on each sub-layer's OUTPUT before the residual add (HF's
    #: post_attention_layernorm / post_feedforward_layernorm)
    attn_post_norm: Optional[torch.Tensor] = None
    mlp_post_norm: Optional[torch.Tensor] = None


def scalar_as(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` through f32, as ``jnp.asarray(v, dtype)``
    rounds a Python scalar, returned as a Python float: a tensor times it
    computes in f32 and rounds once, as the JAX package's product of two
    bf16 operands."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def _use_paged_kernel(cache) -> bool:
    """Paged caches on the card read their pages with the paged-attention
    kernels K5 / K6, and MLA's latent pages with K10 (the JAX package: on
    the TPU). ``QUICK_TPU_PAGED=0`` (read at every call) turns them off, as
    in the JAX package (:107-110): the gather + einsum route instead."""
    if os.environ.get("QUICK_TPU_PAGED", "") == "0":
        return False
    return isinstance(cache, PagedKVCache) and cache.k_pages.is_cuda


def _use_dense_decode_kernel(B, Hq, Hkv, cache: KVCache, D, device) -> bool:
    """Dense-cache decode through K7 where the JAX package takes its dense
    decode kernel: caches of >= 8 MB of K+V per layer on the accelerator.
    ``QUICK_TPU_DENSE_KERNEL=0`` (read at every call) turns it off, as in
    the JAX package (:123-125)."""
    from quick_tpu_torch.ops.decode_attention import supports

    if os.environ.get("QUICK_TPU_DENSE_KERNEL", "") == "0":
        return False
    if isinstance(cache, PagedKVCache):
        return False
    if not supports(B, Hq, Hkv, cache.max_seq, D):
        return False
    if device.type != "cuda":
        return False
    return 2 * B * cache.max_seq * Hkv * D * 2 >= 8 << 20


def _fuse_decode_norm_ok(lin, x) -> bool:
    """Fold the pre-GEMM RMSNorm into the GEMM kernel's prologue? Decode
    rows (<= 8) of a G=128 quantized linear only. ``QUICK_TPU_FUSED_NORM=0``
    (read at every call) turns it off, as in the JAX package (:149)."""
    if os.environ.get("QUICK_TPU_FUSED_NORM", "1") == "0":
        return False
    if not isinstance(lin, QuantLinear) or lin.group_size != 128:
        return False
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return rows <= 8


def _use_layer_tail(p: "BlockParams", cfg: ModelConfig, x: torch.Tensor) -> bool:
    """Gate of the decode layer tail (``_use_layer_tail`` :185): opt-in by
    ``QUICK_TPU_LAYER_TAIL=1`` (read at every call), at most 8 rows, the
    llama-family pre-RMSNorm block (no post-norms, no residual multiplier)
    with a gated SiLU MLP, G = 128 bias-free
    quantized o / gate_up / down linears, no MoE and no MLA (the port has no
    tensor or sequence parallelism to refuse)."""
    if os.environ.get("QUICK_TPU_LAYER_TAIL", "") != "1":
        return False
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    mlp = p.mlp
    return (
        rows <= 8
        and cfg.pre_norms and not cfg.parallel_residual
        and cfg.residual_multiplier is None and cfg.layernorm == "rmsnorm"
        and p.attn_post_norm is None and p.mlp_post_norm is None
        and not cfg.is_mla and isinstance(p.attn, AttentionParams)
        and isinstance(mlp, MLPParams)
        and cfg.gated_mlp and cfg.act_fn == "silu"
        and all(
            isinstance(lin, QuantLinear) and lin.group_size == 128 and lin.bias is None
            for lin in (p.attn.o_proj, mlp.gate_up_proj, mlp.down_proj)
        )
    )


def _use_fused_decode_step(cache: KVCache, B: int, hd: int, rope_cos, device) -> bool:
    """Gate for the fused rope + cache-write + attention kernel: B <= 8,
    full rotary, and a cache layer small enough for the TPU kernel's
    VMEM-resident blocks (3 MiB per batch row). ``QUICK_TPU_FUSED_STEP=0``
    turns it off, as in the JAX package (read at every call)."""
    from quick_tpu_torch.ops.fused_decode_step import group_for

    if os.environ.get("QUICK_TPU_FUSED_STEP", "") == "0":
        return False

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


def qkv_heads(p: AttentionParams, cfg: ModelConfig, qkv: torch.Tensor):
    """q, k, v [B, S, h, hd] of the fused qkv output [B, S, (hq + 2 hkv) hd]
    as RoPE takes them, on every route and in the AWQ search's loss forward
    (:269-305, awq :205-231): the q / k RMSNorm and the query scale."""
    B, S, _ = qkv.shape
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    if cfg.use_qk_norm and cfg.qk_norm_full:
        # olmo2: one RMSNorm over the whole projection width, before the head
        # reshape (``_full_rms`` :269-284). On the card K13 runs it over
        # [B*S, hq*hd] and [B*S, hkv*hd] rows: column slices of the qkv
        # output whose rows K13 reads at the qkv row stride, no copy
        q = rms_norm(q, p.q_norm, cfg.rms_norm_eps)
        k = rms_norm(k, p.k_norm, cfg.rms_norm_eps)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    if cfg.use_qk_norm and not cfg.qk_norm_full:
        # qwen3's and gemma3's per-head RMSNorm ([hd] weights shared by the
        # heads) before RoPE (:288-298). On the card K13 runs it over
        # [B*S*h, hd] rows; q and k are column slices of the qkv output, so
        # their rows do not flatten to one stride and the wrapper copies them
        # into contiguous rows first (one copy each, per layer)
        q = rms_norm(q, p.q_norm, cfg.rms_norm_eps)
        k = rms_norm(k, p.k_norm, cfg.rms_norm_eps)
    if cfg.query_pre_attn_scalar is not None:
        # gemma2's query scale and granite's attention_multiplier, folded
        # into q after the qk-norm as qpas^-0.5 * hd^0.5 in q's dtype
        # (:299-305): every attention kernel keeps its default hd^-0.5
        q = q * scalar_as(cfg.query_pre_attn_scalar ** -0.5 * hd ** 0.5, q.dtype)
    return q, k, v


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
    return_pre_o: bool = False,  # return the raw [B, S, hq*hd] attention
    # output WITHOUT the o projection: the layer tail runs o itself
) -> Tuple[torch.Tensor, Optional[AnyCache]]:
    from quick_tpu_torch.ops.rope import apply_rope

    B, S, _ = x.shape
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def project(out):  # the attention output -> o_proj(out), or out itself
        out = out.reshape(B, S, hq * hd)
        return out if return_pre_o else p.o_proj(out)

    qkv = p.qkv_proj(x, fuse_norm=pre_norm) if pre_norm is not None else p.qkv_proj(x)
    q, k, v = qkv_heads(p, cfg, qkv)
    window = _attention_window(cfg, layer_idx, cache.max_seq if cache is not None else S)
    softcap = cfg.attn_logit_softcap
    route = None
    if S == 1 and isinstance(cache, KVCache):
        route = dense_decode_route(cfg, cache, B, rope_cos, layer_idx, x.device)
    if route == "fused":
        cache.check_room(1)  # K3 reads length_dev and cannot raise
        from quick_tpu_torch.ops.fused_decode_step import fused_decode_attention

        pos0 = positions[:, 0]
        c = rope_cos[pos0].to(torch.float32)  # [B, hd/2]
        s_r = rope_sin[pos0].to(torch.float32)
        out, _, _ = fused_decode_attention(
            q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v,
            torch.cat([c, c], dim=-1), torch.cat([s_r, s_r], dim=-1),
            cache.length_dev, layer_idx,
            window=window, logit_softcap=softcap,
        )  # writes the new k/v row into cache.k / cache.v in place
        return project(out), cache
    q = apply_rope(q, positions, rope_cos, rope_sin)
    k = apply_rope(k, positions, rope_cos, rope_sin)
    if cache is not None:
        start = cache.length  # host int (dense) or [B] device tensor (paged)
        cache = cache.update(layer_idx, k, v, write_start(cache, S))  # in place
        if S == 1 and _use_paged_kernel(cache):
            from quick_tpu_torch.ops.paged_attention import paged_decode_attention

            # whole page (and scale-tile) stacks + layer index, as the JAX
            # call site; INT8 pages take K5q
            out = paged_decode_attention(
                q[:, 0], cache.k_pages, cache.v_pages, cache.block_table,
                start + 1, layer=layer_idx, kv_scales=cache.kv_scales,
                window=window, logit_softcap=softcap,
            )[:, None]
            return project(out), cache
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
            return project(out), cache
        if S > 1 and _use_paged_kernel(cache):
            from quick_tpu_torch.ops.paged_attention import (
                paged_chunk_attention,
                supports_chunk,
            )

            if supports_chunk(S, hq, hkv, cache.page_size):
                out = paged_chunk_attention(
                    q, cache.k_pages, cache.v_pages, cache.block_table, start,
                    layer=layer_idx, kv_scales=cache.kv_scales, window=window,
                    logit_softcap=softcap,
                )
                return project(out), cache
        # [B, Hkv, T, D] head-major; INT8 pages come back dequantized
        k_all, v_all = cache.layer(layer_idx)
        out = causal_attention(
            q, k_all, v_all, q_offset=start, kv_len=start + S,
            kv_heads_major=True, window=window, logit_softcap=softcap,
        )
    else:
        out = causal_attention(q, k, v, window=window, logit_softcap=softcap)
    return project(out), cache


def mlp_forward(
    p: MLPParams, cfg: ModelConfig, x: torch.Tensor, pre_norm: Optional[tuple] = None,
) -> torch.Tensor:
    """The gated MLP with fused gate + up: SwiGLU, or GeGLU under
    ``act_fn="gelu"`` (gemma)."""
    gu = p.gate_up_proj(x, fuse_norm=pre_norm) if pre_norm is not None else p.gate_up_proj(x)
    if cfg.act_fn == "silu" and isinstance(p.down_proj, QuantLinear):
        # silu(gate) * up rides in the down GEMM's prologue at decode rows;
        # other routes gate first inside the call. gelu never takes the
        # prologue (the JAX package fuses only SiLU, :523)
        return p.down_proj(gu, fuse_glu=True)
    gate, up = torch.chunk(gu, 2, dim=-1)
    return p.down_proj(act(gate, cfg) * up)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` with its rounding: x * (1 / (1 + exp(-x))), each op
    rounded to x's dtype (``F.silu`` rounds once, which in bf16 differs
    from the JAX package in a third of the values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) with its rounding:
    x * (0.5 * (1 + tanh(c * (x + k * x^3)))) with c = sqrt(2 / pi) and k =
    0.044715 rounded to x's dtype, x^3 as (x * x) * x, each op rounded to
    x's dtype (``F.gelu(approximate="tanh")`` rounds once)."""
    c = scalar_as(math.sqrt(2 / math.pi), x.dtype)
    k = scalar_as(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MLP activation ``cfg.act_fn`` (``_act`` :503-508): silu or gelu."""
    if cfg.act_fn == "silu":
        return silu(x)
    if cfg.act_fn == "gelu":
        return gelu(x)
    raise NotImplementedError(f"act_fn={cfg.act_fn!r} is not ported (ROADMAP A12)")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim in
    ``lax.top_k``'s order: descending, the lower index first among ties
    (``torch.topk`` promises no order for ties). A stable sort on the
    device; no host sync."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _grouped_moe(p: MoEParams, x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                 token_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped ragged expert dispatch (``_grouped_moe`` :542): expert-sort
    the routed (token, expert) pairs, run both expert GEMMs as one K8
    launch each (K12 under ``QUICK_TPU_MOE_A8=1``), combine by gathering
    each token's kk rows. Returns f32 [B, S, D].

    The JAX package re-takes the top kk of the combine weights here; with
    every expert on one card that gives the router's own choice ``sel``
    [B, S, kk] (positive weights), and experts 0..kk-1 at weight 0 for a
    masked token (an all-zero row; ``lax.top_k`` takes the lower index
    first). So the router's choice is used as it is. Slots are sorted by
    expert id so the f32 combine sums in the JAX package's order."""
    from quick_tpu_torch.ops.grouped_matmul import (
        build_routing,
        pick_grouped_bm,
        quantized_matmul_grouped,
    )

    B, S, D = x.shape
    T, kk = B * S, sel.shape[-1]
    E_local = _n_local_experts(p)
    sel, ss = torch.sort(sel.reshape(T, kk), dim=1)  # expert-id-ascending (distinct ids)
    w = torch.gather(weights.reshape(T, kk).to(torch.float32), 1, ss)
    if token_mask is not None:
        m = token_mask.reshape(T, 1)
        sel = torch.where(m, sel, torch.arange(kk, device=x.device))
        w = w * m
    bm = pick_grouped_bm(T * kk, E_local)
    tok_rows, pos, tile_e, tile_live, _ = build_routing(sel, E_local, bm)
    xs = x.reshape(T, D)[tok_rows]  # [Mp, D] expert-sorted tokens
    gup, dnp = p.gate_up_proj, p.down_proj
    a8 = moe_a8_enabled()  # int8 x int8 expert dots (K12)
    gu = quantized_matmul_grouped(
        xs, gup.qweight, gup.scales, gup.zeros_x_scales, tile_e, tile_live, bm,
        group_size=gup.group_size, a8=a8,
    )
    gate, up = torch.chunk(gu, 2, dim=-1)
    yd = quantized_matmul_grouped(
        silu(gate) * up, dnp.qweight, dnp.scales, dnp.zeros_x_scales, tile_e, tile_live, bm,
        group_size=dnp.group_size, a8=a8,
    )
    yg = yd[pos.reshape(-1)].reshape(T, kk, D).to(torch.float32)
    return torch.sum(yg * w[..., None], dim=1).reshape(B, S, D)


def moe_forward(
    p: MoEParams, cfg: ModelConfig, x: torch.Tensor,
    token_mask: Optional[torch.Tensor] = None,  # [B, S]: padding tokens
    # get zero combine weights
) -> torch.Tensor:
    """MoE dispatch (``moe_forward`` :592) on one card (E_local = E; expert
    parallelism is ROADMAP A15). The router runs on f32 x against its bf16
    weight cast to f32 (a full-f32 product under PyTorch's default
    ``allow_tf32=False``). Quantized bias-free experts ride the grouped
    kernel at every batch size unless ``QUICK_TPU_MOE_GROUPED=0``; float or
    biased experts (left so by ``modules_to_not_convert``), and every expert
    under that switch, take the per-expert path at B*S <= 32 (every
    expert is computed: an unrouted one adds exact zeros, and nothing is
    read back to the host) or the einsum over all experts."""
    B, S, D = x.shape
    topk = cfg.num_experts_per_tok
    logits = p.router(x.to(torch.float32))  # [B, S, E]
    if cfg.moe_router == "deepseek":
        weights, sel = _deepseek_route(p, cfg, logits)
    elif cfg.moe_router == "softmax_all":
        # qwen2/3-MoE: softmax over all experts, then top-k of the scores;
        # renormalized only under norm_topk_prob
        weights, sel = top_k(torch.softmax(logits, dim=-1), topk)
        if cfg.norm_topk_prob and topk > 1:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    elif cfg.moe_router == "mixtral":
        weights, sel = top_k(logits, topk)
        weights = torch.softmax(weights, dim=-1)
    else:
        raise NotImplementedError(f"moe_router={cfg.moe_router!r} is not ported")

    def expert_fn(gu_q, gu_s, gu_z, gu_b, dn_q, dn_s, dn_z, dn_b):
        gup = _rebuild_linear(p.gate_up_proj, gu_q, gu_s, gu_z, gu_b)
        dnp = _rebuild_linear(p.down_proj, dn_q, dn_s, dn_z, dn_b)
        gate, up = torch.chunk(gup(x), 2, dim=-1)
        return dnp(silu(gate) * up)  # [B, S, D]

    grouped_ok = (
        os.environ.get("QUICK_TPU_MOE_GROUPED", "1") != "0"  # read at every call (:669)
        and isinstance(p.gate_up_proj, QuantLinear) and isinstance(p.down_proj, QuantLinear)
        and p.gate_up_proj.bias is None and p.down_proj.bias is None
    )
    if grouped_ok:
        y = _grouped_moe(p, x, sel, weights, token_mask)
    else:
        # combine weights per expert [B, S, E]: the one-hot sum of the JAX
        # package, as a scatter (the selected ids of a row are distinct)
        comb = torch.zeros(logits.shape, dtype=torch.float32, device=x.device).scatter_(
            -1, sel, weights.to(torch.float32))
        if token_mask is not None:
            comb = comb * token_mask[..., None].to(comb.dtype)
        if B * S <= 32:
            y = torch.zeros((B, S, D), dtype=torch.float32, device=x.device)
            for e in range(_n_local_experts(p)):
                y = y + _apply_expert(p, e, expert_fn).to(torch.float32) * comb[..., e:e + 1]
        else:
            outs = _map_experts(p, expert_fn)  # [E, B, S, D]
            y = torch.einsum("ebsd,bse->bsd", outs.to(torch.float32), comb)
    y = y.to(x.dtype)
    if p.shared_gate_up is not None:
        # always-on shared expert; qwen2_moe gates it per token with
        # sigmoid(shared_gate(x))
        gate, up = torch.chunk(p.shared_gate_up(x), 2, dim=-1)
        sh = p.shared_down(silu(gate) * up)
        if p.shared_gate is not None:
            g = torch.sigmoid(p.shared_gate(x).to(torch.float32))
            sh = (sh.to(torch.float32) * g).to(sh.dtype)
        y = y + sh
    return y


def _deepseek_route(p: MoEParams, cfg: ModelConfig, logits: torch.Tensor):
    """DeepSeekMoE's gate (``moe_forward`` :606-636; HF modeling_deepseek
    MoEGate): score every expert (softmax v2, sigmoid v3), add the v3
    ``score_bias`` for the selection only, limit the selection to the
    ``topk_group`` best of ``n_group`` expert groups (a group scores its
    max, or with a bias the sum of its top two), take the top-k, gather the
    ORIGINAL scores of the chosen experts, renormalize under
    ``norm_topk_prob`` and scale by ``routed_scaling_factor``. Returns
    (weights, sel) [B, S, k]."""
    B, S, E = logits.shape
    topk = cfg.num_experts_per_tok
    scores = (torch.sigmoid(logits) if cfg.scoring_func == "sigmoid"
              else torch.softmax(logits, dim=-1))
    choice = scores if p.score_bias is None else scores + p.score_bias.to(scores.dtype)
    ng, tg = cfg.n_group, cfg.topk_group
    if ng and tg and tg < ng:
        gsc = choice.reshape(B, S, ng, E // ng)
        gscore = top_k(gsc, 2)[0].sum(-1) if p.score_bias is not None else gsc.amax(-1)
        _, gsel = top_k(gscore, tg)  # [B, S, tg]
        gmask = torch.zeros((B, S, ng), dtype=torch.bool, device=logits.device).scatter_(
            -1, gsel, True)
        choice = torch.where(gmask[..., None], gsc,
                             torch.full_like(gsc, -math.inf)).reshape(B, S, E)
    _, sel = top_k(choice, topk)
    weights = torch.gather(scores, -1, sel)
    if cfg.norm_topk_prob and topk > 1:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * cfg.routed_scaling_factor, sel


def _n_local_experts(p: MoEParams) -> int:
    gu = p.gate_up_proj
    return (gu.qweight if isinstance(gu, QuantLinear) else gu.weight).shape[0]


def _expert_fields(lin: AnyLinear, e: int):
    """Expert e's slices of one projection, quantized or float."""
    b = None if lin.bias is None else lin.bias[e]
    if isinstance(lin, QuantLinear):
        return (lin.qweight[e], lin.scales[e], lin.zeros_x_scales[e], b)
    return (lin.weight[e], None, None, b)


def _apply_expert(p: MoEParams, e: int, fn):
    return fn(*_expert_fields(p.gate_up_proj, e), *_expert_fields(p.down_proj, e))


def _rebuild_linear(proto: AnyLinear, *fields) -> AnyLinear:
    if isinstance(proto, QuantLinear):
        q, s, z, b = fields
        return QuantLinear(q, s, z, b, proto.group_size)
    return Linear(fields[0], fields[3])


def _map_experts(p: MoEParams, fn) -> torch.Tensor:
    """Every expert's output stacked on a leading expert axis."""
    return torch.stack([_apply_expert(p, e, fn) for e in range(_n_local_experts(p))])


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
    token_mask: Optional[torch.Tensor] = None,  # [B, S] valid tokens (MoE)
) -> Tuple[torch.Tensor, Optional[AnyCache]]:
    """One block (``block_forward`` :787-872): the pre-norms (none for
    olmo2, whose sub-layers read the raw residual), the attention, the
    post-norms on each sub-layer's output (gemma2 / gemma3 / olmo2) and the
    residual multiplier (granite, minicpm) before each residual add."""
    eps = cfg.rms_norm_eps
    tail = _use_layer_tail(p, cfg, x)
    if cfg.is_mla:
        # MLA never takes the fused norm prologue (:791-806)
        from quick_tpu_torch.modules.mla import mla_attention_forward

        attn_out, cache = mla_attention_forward(
            p.attn, cfg, rms_norm(x, p.attn_norm, eps), rope_cos, rope_sin, cache,
            layer_idx, positions,
        )
    elif cfg.pre_norms and _fuse_decode_norm_ok(p.attn.qkv_proj, x):
        # the norm rides in the qkv GEMM's prologue
        attn_out, cache = attention_forward(
            p.attn, cfg, x, rope_cos, rope_sin, cache, layer_idx, positions,
            pre_norm=(p.attn_norm, eps), decode_lengths=decode_lengths,
            return_pre_o=tail,
        )
    else:
        attn_out, cache = attention_forward(
            p.attn, cfg, rms_norm(x, p.attn_norm, eps) if cfg.pre_norms else x,
            rope_cos, rope_sin, cache, layer_idx, positions, decode_lengths=decode_lengths,
            return_pre_o=tail,
        )
    if tail:
        # o-proj + residual + MLP norm + SwiGLU MLP + residual in one call
        # (:816-833): K14 on the card, its plain version on the CPU
        from quick_tpu_torch.ops.fused_layer_tail import fused_layer_tail

        B, S, D = x.shape
        o, gup, dn = p.attn.o_proj, p.mlp.gate_up_proj, p.mlp.down_proj
        y = fused_layer_tail(
            attn_out.reshape(B * S, -1), x.reshape(B * S, D), p.mlp_norm,
            o.qweight, o.scales, o.zeros_x_scales,
            gup.qweight, gup.scales, gup.zeros_x_scales,
            dn.qweight, dn.scales, dn.zeros_x_scales, eps=float(eps),
        )
        return y.reshape(B, S, D).to(x.dtype), cache
    x = x + sublayer_out(attn_out, p.attn_post_norm, cfg)
    if isinstance(p.mlp, MLPParams) and cfg.pre_norms and _fuse_decode_norm_ok(
            p.mlp.gate_up_proj, x):
        mlp_out = mlp_forward(p.mlp, cfg, x, pre_norm=(p.mlp_norm, eps))
    else:
        h = rms_norm(x, p.mlp_norm, eps) if cfg.pre_norms else x
        # the MLP norm is never fused into an MoE layer (:851-857)
        mlp_out = (moe_forward(p.mlp, cfg, h, token_mask) if isinstance(p.mlp, MoEParams)
                   else mlp_forward(p.mlp, cfg, h))
    return x + sublayer_out(mlp_out, p.mlp_post_norm, cfg), cache


def sublayer_out(y: torch.Tensor, post_norm: Optional[torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """A sub-layer's output as the residual adds it: its post-norm (K13 on
    the card), then the residual multiplier in y's dtype (:835-838,
    :869-872; in the AWQ search awq :321-327, :371-376)."""
    if post_norm is not None:
        y = rms_norm(y, post_norm, cfg.rms_norm_eps)
    if cfg.residual_multiplier is not None:
        y = y * scalar_as(cfg.residual_multiplier, y.dtype)
    return y
