"""AWQ: activation-aware weight quantization (port of
``quick_tpu/quantize/awq.py``).

The reference's search semantics (quick/awq/quantize/quantizer.py):

- scale search (quantizer.py:181-282): a 20-point grid over
  ``s = x_mean^r / w_mean^(1-r)``, normalized by sqrt(max * min); the
  objective is the MSE of the inspected module's output (the whole attention
  or the whole MLP) with weights pseudo-quantized as Q(W * s) / s.
- clip search (quantizer.py:284-350): a per-(group, out-channel) shrink of
  the clipping range, the objective the MSE of per-group partial products
  over sampled tokens; q / k are never clipped (quantizer.py:287).
- scale application (scale.py:27-137): ``1/s`` folds into the previous op
  (a norm weight or the previous linear's output channels), ``s`` into the
  target weights.

Every step runs on the params' device. On the card the searches' attention
is ``ops/attention.py::causal_attention`` (the flash kernel K2) and their
RMSNorms ``ops/norms.py::rms_norm`` (K13), as the model's forward; the
products of the loss forwards and the clip search's einsums are plain
``torch.matmul`` / ``einsum`` (full f32 for the clip search under PyTorch's
default ``allow_tf32=False``), as the JAX package leaves them to XLA. The
running best of each grid stays on the device (``torch.where``): nothing
is read back per candidate. Eager PyTorch: no counterpart of the JAX
package's one jitted program per block.

The port runs what ``models/model.py::check_supported`` admits: the
RMSNorm families (dense and the three ported MoE routers; the per-head and
full-width RMS qk-norm, query_pre_attn_scalar, post-norms, no pre-norms
with unit qkv and gate_up scales, residual multipliers, GeGLU, the
embedding scales, gemma3's local rope tables) and MLA. The JAX package's
branches for the LayerNorm families' switches (LayerNorm and its qk-norm,
parallel residual, ALiBi, non-gated MLPs) wait for ROADMAP A12; such
configs raise there.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig, QuantConfig
from quick_tpu_torch.modules.blocks import (
    AttentionParams,
    BlockParams,
    MLPParams,
    MoEParams,
    act,
    moe_forward,
    qkv_heads,
    sublayer_out,
)
from quick_tpu_torch.modules.linear import Linear, QuantLinear
from quick_tpu_torch.ops.attention import causal_attention
from quick_tpu_torch.ops.norms import rms_norm
from quick_tpu_torch.ops.rope import apply_rope
from quick_tpu_torch.quantize.numerics import pseudo_quantize_tensor

N_GRID = 20


# ---------------------------------------------------------------------------
# Search records (route comparisons)
# ---------------------------------------------------------------------------

class SearchRecord(NamedTuple):
    """One grid search's losses, in call order: a scale search's
    ``losses`` [N_GRID] and candidate vectors ``grid`` [N_GRID, K]; a clip
    search's ``losses`` [n, ng, N] and the unclipped bound ``grid`` [ng, N]
    (candidate i is grid * (1 - i / N_GRID)). The pick is the first least
    loss along dim 0, as the running ``<`` of the search takes it."""
    kind: str
    losses: torch.Tensor
    grid: torch.Tensor

    def picks(self) -> torch.Tensor:
        return torch.argmin(self.losses, dim=0)


_RECORD: contextvars.ContextVar[Optional[List[SearchRecord]]] = contextvars.ContextVar(
    "awq_search_record", default=None)


@contextlib.contextmanager
def recorded_searches() -> Iterator[List[SearchRecord]]:
    """Inside the block every scale and clip search appends its
    ``SearchRecord`` to the yielded list (on the search's device). Outside
    it nothing is kept."""
    out: List[SearchRecord] = []
    token = _RECORD.set(out)
    try:
        yield out
    finally:
        _RECORD.reset(token)


def relative_gap(losses: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|l[a] - l[b]| / min(l[a], l[b]) of the grid losses [n, ...] at two
    picks (index tensors of the losses' trailing shape); the absolute
    difference where the smaller loss is 0."""
    la = torch.gather(losses, 0, a.reshape(1, *losses.shape[1:]))[0]
    lb = torch.gather(losses, 0, b.reshape(1, *losses.shape[1:]))[0]
    den = torch.minimum(la, lb)
    num = (la - lb).abs()
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), num)


def compare_searches(ra: List[SearchRecord], rb: List[SearchRecord]) -> List[dict]:
    """The picks of two runs of the same searches (two routes, two
    devices): for each search its kind, picks, differing picks and the
    largest relative gap of a differing pick, the larger of the two runs'
    ``relative_gap`` at both picks (0 where every pick agrees)."""
    if [r.kind for r in ra] != [r.kind for r in rb]:
        raise ValueError("the two runs made different searches")
    out = []
    for a, b in zip(ra, rb):
        dev = a.losses.device
        la, lb = a.losses.to(torch.float32), b.losses.to(dev, torch.float32)
        pa, pb = a.picks(), b.picks().to(dev)
        differ = pa != pb
        gap = 0.0
        if bool(differ.any()):
            g = torch.maximum(relative_gap(la, pa, pb), relative_gap(lb, pa, pb))
            gap = float(g[differ].max())
        out.append(dict(kind=a.kind, picks=pa.numel(), differ=int(differ.sum()), gap=gap))
    return out


def _record(kind: str, losses: torch.Tensor, grid: torch.Tensor) -> None:
    rec = _RECORD.get()
    if rec is not None:
        rec.append(SearchRecord(kind, losses, grid))


# ---------------------------------------------------------------------------
# Scale search
# ---------------------------------------------------------------------------

def _w_mean_score(ws: List[torch.Tensor], group_size: int) -> torch.Tensor:
    """Per-input-channel weight magnitude score (reference STEP 1,
    quantizer.py:193-199): |w| normalized by its group's amax, averaged over
    every output channel of every layer of the group."""
    parts = []
    for w in ws:
        K, N = w.shape
        wg = w.to(torch.float32).abs().reshape(K // group_size, group_size, N)
        wn = wg / (wg.amax(dim=1, keepdim=True) + 1e-6)
        parts.append(wn.reshape(K, N))
    return torch.cat(parts, dim=1).mean(dim=1)  # [K]


def search_scale(
    x: torch.Tensor,  # [T, K] inputs to the group
    ws: List[torch.Tensor],  # weights [K, N_i] sharing the input
    loss_forward: Callable[[List[torch.Tensor]], torch.Tensor],
    group_size: int,
    zero_point: bool = True,
    duo_scaling: bool = True,
) -> torch.Tensor:
    """Grid-search the per-input-channel scale vector s [K] (f32):
    ``loss_forward(scaled_ws)`` gives the module output, whose MSE against
    the float output is minimized (reference _compute_best_scale,
    quantizer.py:221-282)."""
    x_mean = x.to(torch.float32).abs().mean(dim=0)  # [K]
    w_mean = _w_mean_score(ws, group_size)
    fp_out = loss_forward(ws).to(torch.float32)

    def candidate(ratio):
        # the reference's candidate (quantizer.py:249-253): the QUOTIENT is
        # clamped at 1e-4, not an epsilon added to the denominator
        s = torch.pow(x_mean, ratio)
        if duo_scaling:
            s = s / torch.pow(w_mean, 1 - ratio)
        s = torch.clamp(s, min=1e-4)
        return s / torch.sqrt(s.max() * s.min())

    def loss_for(s):
        scaled = []
        for w in ws:
            wq = pseudo_quantize_tensor(
                w.to(torch.float32) * s[:, None], group_size, zero_point=zero_point,
            ) / s[:, None]
            scaled.append(wq.to(w.dtype))
        out = loss_forward(scaled).to(torch.float32)
        return ((fp_out - out) ** 2).mean()

    record = _RECORD.get() is not None
    best_s = best_loss = None
    cands, losses = [], []
    for i in range(N_GRID):
        s = candidate(i / N_GRID)
        loss = loss_for(s)
        if record:
            cands.append(s)
            losses.append(loss)
        if best_s is None:
            best_s, best_loss = s, loss
        else:
            pick = loss < best_loss  # on the device: no host sync
            best_s = torch.where(pick, s, best_s)
            best_loss = torch.where(pick, loss, best_loss)
    if record:
        _record("scale", torch.stack(losses), torch.stack(cands))
    return best_s


# ---------------------------------------------------------------------------
# Clip search
# ---------------------------------------------------------------------------

def search_clip(
    w: torch.Tensor,  # [K, N]
    x: torch.Tensor,  # [T, K]
    group_size: int,
    zero_point: bool = True,
    n_grid: int = N_GRID,
    max_shrink: float = 0.5,
    n_sample_token: int = 512,
) -> torch.Tensor:
    """Best per-(group, out-channel) |w| clipping bound [ng, N] (reference
    _compute_best_clip, quantizer.py:302-350), over every
    max(T // n_sample_token, 1)-th token."""
    K, N = w.shape
    ng = K // group_size
    T = x.shape[0]
    stride = max(T // n_sample_token, 1)
    xs = x[::stride].to(torch.float32)  # [Ts, K]
    xg = xs.reshape(-1, ng, group_size)  # [Ts, ng, G]
    wg = w.to(torch.float32).reshape(ng, group_size, N)
    org_max = wg.abs().amax(dim=1, keepdim=True)  # [ng, 1, N]
    org_out = torch.einsum("tgk,gkn->tgn", xg, wg)  # [Ts, ng, N]

    best_max = org_max
    min_err = torch.full((ng, 1, N), float("inf"), dtype=torch.float32, device=w.device)
    errs = [] if _RECORD.get() is not None else None
    for i_s in range(int(max_shrink * n_grid)):
        maxv = org_max * (1 - i_s / n_grid)
        cw = torch.clamp(wg, min=-maxv, max=maxv)
        qw = pseudo_quantize_tensor(
            cw.reshape(K, N), group_size, zero_point=zero_point
        ).reshape(ng, group_size, N)
        out = torch.einsum("tgk,gkn->tgn", xg, qw)
        err = ((out - org_out) ** 2).mean(dim=0)[:, None, :]  # [ng, 1, N]
        if errs is not None:
            errs.append(err[:, 0])
        pick = err < min_err
        min_err = torch.where(pick, err, min_err)
        best_max = torch.where(pick, maxv, best_max)
    if errs is not None:
        _record("clip", torch.stack(errs), org_max[:, 0])
    return best_max[:, 0, :]  # [ng, N]


def apply_clip(w: torch.Tensor, max_val: torch.Tensor, group_size: int) -> torch.Tensor:
    K, N = w.shape
    wg = w.to(torch.float32).reshape(K // group_size, group_size, N)
    wc = torch.clamp(wg, min=-max_val[:, None, :], max=max_val[:, None, :])
    return wc.reshape(K, N).to(w.dtype)


# ---------------------------------------------------------------------------
# Block-level pipeline (llama path, dense or MoE; MLA)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AwqBlockResult:
    block: BlockParams  # quantized
    x_next: torch.Tensor  # activations for the next block (float, scaled)


def _flat(a: torch.Tensor) -> torch.Tensor:  # [B, S, D] -> [T, D]
    return a.reshape(-1, a.shape[-1])


def _scale_rows(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(w * s[:, None]) in f32, back in w's dtype: the target side of a fold."""
    return (w.to(torch.float32) * s[:, None]).to(w.dtype)


def _divide_cols(w: torch.Tensor, cols: slice, s: torch.Tensor) -> torch.Tensor:
    """w with its ``cols`` divided by s (in w's dtype): the previous-linear
    side of an fc -> fc fold (``.at[..., cols].divide``)."""
    w = w.clone()
    w[..., cols] = w[..., cols] / s.to(w.dtype)
    return w


def _pack(w: torch.Tensor, bias, name: str, skip: frozenset, qcfg: QuantConfig):
    if name in skip:
        return Linear(w, bias)
    return QuantLinear.from_float(w, bias, qcfg.q_group_size, qcfg.zero_point)


def awq_quantize_block(
    blk: BlockParams,
    cfg: ModelConfig,
    x: torch.Tensor,           # [B, S, D] float activations entering the block
    positions: torch.Tensor,   # [B, S]
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    qcfg: QuantConfig,
    apply_clips: bool = True,
    skip: frozenset = frozenset(),
    sliding: bool = False,  # this layer attends through a sliding window
) -> AwqBlockResult:
    """Search and apply AWQ scales / clips for one llama-path block, then
    quantize and pack (``awq_quantize_block`` :177; the reference's per-layer
    loop, quantizer.py:87-146, with the llama scaling groups,
    models/llama.py:37-73). ``skip`` holds canonical linear names ('qkv',
    'o', 'gate_up', 'down') left float (their AWQ scales still apply: an
    exact float transform)."""
    G, zp = qcfg.q_group_size, qcfg.zero_point
    B, S, D = x.shape
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv_b = blk.attn.qkv_proj.bias

    def attn_fwd(qkv_w: torch.Tensor, attn_in: torch.Tensor) -> torch.Tensor:
        """The attention output (the o projection's input) for a qkv
        weight, with the block forward's q / k RMSNorm (olmo2's full-width
        one before the head reshape, qwen3's and gemma3's per-head one
        after, :205-231), query_pre_attn_scalar, rope, window and softcap."""
        qkv = torch.matmul(attn_in, qkv_w.to(attn_in.dtype))
        if qkv_b is not None:
            qkv = qkv + qkv_b.to(qkv.dtype)
        q, k, v = qkv_heads(blk.attn, cfg, qkv)
        q = apply_rope(q, positions, rope_cos, rope_sin)
        k = apply_rope(k, positions, rope_cos, rope_sin)
        window = cfg.sliding_window if sliding else None
        if window is not None and S <= window:
            window = None
        out = causal_attention(q, k, v, window=window, logit_softcap=cfg.attn_logit_softcap)
        return out.reshape(B, S, hq * hd)

    # ---------------- attention: norm -> qkv group --------------------------
    qkv_w = blk.attn.qkv_proj.weight
    if blk.attn_norm is not None:
        attn_norm = blk.attn_norm.to(torch.float32)
        attn_in = rms_norm(x, blk.attn_norm, cfg.rms_norm_eps)
        s_qkv = search_scale(
            _flat(attn_in), [qkv_w], loss_forward=lambda ws: attn_fwd(ws[0], attn_in),
            group_size=G, zero_point=zp,
        )
        # the norm /= s, qkv rows *= s (reference scale_ln_fcs, scale.py:71-98)
        attn_norm = attn_norm / s_qkv
        qkv_w = _scale_rows(qkv_w, s_qkv)
        attn_in = attn_in / s_qkv.to(attn_in.dtype)
    else:
        # olmo2 (no pre-norms): qkv reads the raw residual, with no op before
        # it to fold a scale into, so it keeps unit scales; its clip search
        # still runs (:279-286)
        attn_norm, attn_in = None, x

    # o group: prev_op = the v section, only when the shapes match (MHA;
    # reference models/llama.py:52-58)
    o_w = blk.attn.o_proj.weight
    v_cols = slice((hq + hkv) * hd, (hq + 2 * hkv) * hd)
    o_in = attn_fwd(qkv_w, attn_in)
    if hq == hkv:
        s_o = search_scale(
            _flat(o_in), [o_w], loss_forward=lambda ws: torch.matmul(o_in, ws[0].to(o_in.dtype)),
            group_size=G, zero_point=zp,
        )
        # v output channels (weight AND bias) /= s_o, o rows *= s_o
        # (reference scale_fc_fc, scale.py:100-117)
        qkv_w = _divide_cols(qkv_w, v_cols, s_o)
        if qkv_b is not None:
            qkv_b = _divide_cols(qkv_b, v_cols, s_o)
        o_w = _scale_rows(o_w, s_o)
        o_in = o_in / s_o.to(o_in.dtype)

    # clips (not q / k: reference avoid_clipping, quantizer.py:287)
    if apply_clips:
        v_w = qkv_w[:, v_cols]
        qkv_w = qkv_w.clone()
        qkv_w[:, v_cols] = apply_clip(v_w, search_clip(v_w, _flat(attn_in), G, zp), G)
        o_w = apply_clip(o_w, search_clip(o_w, _flat(o_in), G, zp), G)

    attn_out = torch.matmul(o_in, o_w.to(o_in.dtype))
    if blk.attn.o_proj.bias is not None:
        attn_out = attn_out + blk.attn.o_proj.bias.to(attn_out.dtype)
    x_mid = x + sublayer_out(attn_out, blk.attn_post_norm, cfg)

    # ---------------- MLP ---------------------------------------------------
    if blk.mlp_norm is not None:
        mlp_in = rms_norm(x_mid, blk.mlp_norm, cfg.rms_norm_eps)
        ones = torch.ones_like(blk.mlp_norm, dtype=torch.float32)
    else:
        # olmo2: gate_up reads the raw residual and keeps unit scales
        # (:338-343)
        mlp_in, ones = x_mid, None
    if isinstance(blk.mlp, MoEParams):
        new_mlp, mlp_out, mlp_norm_scale = _awq_moe(blk.mlp, cfg, mlp_in, ones, qcfg,
                                                    apply_clips, skip=skip)
    else:
        new_mlp, mlp_out, mlp_norm_scale = _awq_mlp(blk.mlp, cfg, mlp_in, ones, qcfg, apply_clips)
        new_mlp = MLPParams(
            gate_up_proj=_pack(new_mlp.gate_up_proj.weight, new_mlp.gate_up_proj.bias,
                               "gate_up", skip, qcfg),
            down_proj=_pack(new_mlp.down_proj.weight, new_mlp.down_proj.bias, "down", skip, qcfg),
        )
    # the MLP searches return the norm's multiplicative adjustment (1 / s_gu)
    x_next = x_mid + sublayer_out(mlp_out, blk.mlp_post_norm, cfg)

    new_attn = AttentionParams(
        qkv_proj=_pack(qkv_w, qkv_b, "qkv", skip, qcfg),
        o_proj=_pack(o_w, blk.attn.o_proj.bias, "o", skip, qcfg),
        q_norm=blk.attn.q_norm, k_norm=blk.attn.k_norm,
    )
    new_block = BlockParams(
        attn_norm=None if attn_norm is None else attn_norm.to(blk.attn_norm.dtype),
        attn=new_attn,
        mlp_norm=(None if blk.mlp_norm is None
                  else (blk.mlp_norm.to(torch.float32) * mlp_norm_scale).to(blk.mlp_norm.dtype)),
        mlp=new_mlp,
        # the post-norms act on sub-layer outputs: no scale folds into them
        attn_post_norm=blk.attn_post_norm, mlp_post_norm=blk.mlp_post_norm,
    )
    return AwqBlockResult(block=new_block, x_next=x_next)


def _glu(z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """act(gate) * up of a fused gate_up output: SwiGLU or GeGLU (:443)."""
    gate, up = torch.chunk(z, 2, dim=-1)
    return act(gate, cfg) * up


def _awq_mlp(mlp: MLPParams, cfg: ModelConfig, mlp_in, mlp_norm, qcfg: QuantConfig,
             apply_clips: bool):
    """Dense gated MLP (``_awq_mlp`` :424): the norm -> gate_up group
    searched against the whole MLP (not without a norm, ``mlp_norm`` None:
    unit scales), then the up -> down group. Returns the scaled float
    MLPParams, the MLP output and ``mlp_norm`` / s_gu."""
    G, zp = qcfg.q_group_size, qcfg.zero_point
    F = cfg.intermediate_size
    gu_w, gu_b = mlp.gate_up_proj.weight, mlp.gate_up_proj.bias
    dn_w = mlp.down_proj.weight

    def gate_up(h, gu, b):
        z = torch.matmul(h, gu.to(h.dtype))
        if b is not None:
            z = z + b.to(z.dtype)
        return _glu(z, cfg)

    if mlp_norm is not None:
        s_gu = search_scale(
            _flat(mlp_in), [gu_w],
            loss_forward=lambda ws: torch.matmul(gate_up(mlp_in, ws[0], gu_b),
                                                 dn_w.to(mlp_in.dtype)),
            group_size=G, zero_point=zp,
        )
        mlp_norm = mlp_norm / s_gu
        gu_w = _scale_rows(gu_w, s_gu)
        mlp_in = mlp_in / s_gu.to(mlp_in.dtype)

    # down group: prev_op = the up half (reference models/llama.py:64-71)
    dn_in = gate_up(mlp_in, gu_w, gu_b)
    s_dn = search_scale(
        _flat(dn_in), [dn_w], loss_forward=lambda ws: torch.matmul(dn_in, ws[0].to(dn_in.dtype)),
        group_size=G, zero_point=zp,
    )
    # the up half (weight AND bias) /= s_dn (reference scale_fc_fc)
    up_cols = slice(F, 2 * F)
    gu_w = _divide_cols(gu_w, up_cols, s_dn)
    if gu_b is not None:
        gu_b = _divide_cols(gu_b, up_cols, s_dn)
    dn_w = _scale_rows(dn_w, s_dn)
    dn_in = dn_in / s_dn.to(dn_in.dtype)

    if apply_clips:
        gu_w = apply_clip(gu_w, search_clip(gu_w, _flat(mlp_in), G, zp), G)
        dn_w = apply_clip(dn_w, search_clip(dn_w, _flat(dn_in), G, zp), G)

    mlp_out = torch.matmul(dn_in, dn_w.to(dn_in.dtype))
    if mlp.down_proj.bias is not None:
        mlp_out = mlp_out + mlp.down_proj.bias.to(mlp_out.dtype)
    return (MLPParams(gate_up_proj=Linear(gu_w, gu_b), down_proj=Linear(dn_w, mlp.down_proj.bias)),
            mlp_out, mlp_norm)


def _pack_stacked(w: torch.Tensor, qcfg: QuantConfig) -> QuantLinear:
    """Stacked experts [E, K, N], quantized and packed expert by expert."""
    qls = [QuantLinear.from_float(w[e], None, qcfg.q_group_size, qcfg.zero_point)
           for e in range(w.shape[0])]
    return QuantLinear(
        qweight=torch.stack([ql.qweight for ql in qls]),
        scales=torch.stack([ql.scales for ql in qls]),
        zeros_x_scales=torch.stack([ql.zeros_x_scales for ql in qls]),
        bias=None, group_size=qcfg.q_group_size,
    )


def _awq_moe(moe: MoEParams, cfg: ModelConfig, mlp_in, mlp_norm, qcfg: QuantConfig,
             apply_clips: bool, skip: frozenset = frozenset()):
    """MoE (``_awq_moe`` :506): every expert's gate_up, and the shared
    expert's, scaled JOINTLY from the shared input (reference
    models/mixtral.py:58-66), searched against ``moe_forward`` on float
    experts; then each expert's down group and clips, and the shared
    expert's own down group. The router is not in the scaling group: after
    the fold it reads the 1/s-scaled input, as in the reference and the
    JAX package. Returns the packed MoEParams, the MoE output (float scaled
    experts) and ``mlp_norm`` / s_gu."""
    G, zp = qcfg.q_group_size, qcfg.zero_point
    E = moe.gate_up_proj.weight.shape[0]
    gu = moe.gate_up_proj.weight  # [E, D, 2F]
    dn = moe.down_proj.weight     # [E, F, D]
    F = gu.shape[-1] // 2         # the expert width (deepseek's differs from
    # the dense layers' intermediate_size)
    sgu = None if moe.shared_gate_up is None else moe.shared_gate_up.weight
    sdn = None if moe.shared_down is None else moe.shared_down.weight

    def routed(gu_s, dn_s, h, sgu_s=None):
        # the shared expert is in the loss: its weights take the same s_gu
        return moe_forward(
            MoEParams(moe.router, Linear(gu_s), Linear(dn_s),
                      shared_gate_up=None if sgu_s is None else Linear(sgu_s),
                      shared_down=None if sgu_s is None else Linear(sdn),
                      score_bias=moe.score_bias, shared_gate=moe.shared_gate),
            cfg, h,
        )

    layers = [gu[e] for e in range(E)] + ([sgu] if sgu is not None else [])
    s_gu = search_scale(
        _flat(mlp_in), layers,
        loss_forward=lambda ws: routed(torch.stack(ws[:E]), dn, mlp_in,
                                       ws[E] if sgu is not None else None),
        group_size=G, zero_point=zp,
    )
    mlp_norm = mlp_norm / s_gu
    gu = (gu.to(torch.float32) * s_gu[None, :, None]).to(gu.dtype)
    if sgu is not None:
        sgu = _scale_rows(sgu, s_gu).to(gu.dtype)
    mlp_in = mlp_in / s_gu.to(mlp_in.dtype)

    def down_group(gu_e, dn_e, Fe):
        """One expert's up -> down fold and its clips."""
        dn_in = _glu(torch.matmul(mlp_in, gu_e.to(mlp_in.dtype)), cfg)
        s_dn = search_scale(
            _flat(dn_in), [dn_e],
            loss_forward=lambda ws: torch.matmul(dn_in, ws[0].to(dn_in.dtype)),
            group_size=G, zero_point=zp,
        )
        gu_e = _divide_cols(gu_e, slice(Fe, None), s_dn)
        dn_e = _scale_rows(dn_e, s_dn)
        dn_in = dn_in / s_dn.to(dn_in.dtype)
        if apply_clips:
            gu_e = apply_clip(gu_e, search_clip(gu_e, _flat(mlp_in), G, zp), G)
            dn_e = apply_clip(dn_e, search_clip(dn_e, _flat(dn_in), G, zp), G)
        return gu_e, dn_e

    new = [down_group(gu[e], dn[e], F) for e in range(E)]
    gu = torch.stack([g for g, _ in new])
    dn = torch.stack([d for _, d in new])
    if sgu is not None:  # the shared expert's own down group
        sgu, sdn = down_group(sgu, sdn, sgu.shape[-1] // 2)

    scaled = MoEParams(
        moe.router, Linear(gu), Linear(dn),
        shared_gate_up=None if sgu is None else Linear(sgu),
        shared_down=None if sdn is None else Linear(sdn),
        score_bias=moe.score_bias,
        shared_gate=moe.shared_gate,  # [D, 1] sigmoid gate: stays float
    )
    mlp_out = moe_forward(scaled, cfg, mlp_in)

    def shared(w, name):
        if w is None:
            return None
        return Linear(w) if name in skip else QuantLinear.from_float(w, None, G, zp)

    packed = MoEParams(
        router=moe.router,
        gate_up_proj=Linear(gu) if "gate_up" in skip else _pack_stacked(gu, qcfg),
        down_proj=Linear(dn) if "down" in skip else _pack_stacked(dn, qcfg),
        shared_gate_up=shared(sgu, "gate_up"),
        shared_down=shared(sdn, "down"),
        score_bias=moe.score_bias,
        shared_gate=moe.shared_gate,
    )
    return packed, mlp_out, mlp_norm


def awq_quantize_mla_block(
    blk: BlockParams,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    qcfg: QuantConfig,
    apply_clips: bool = True,
    skip: frozenset = frozenset(),
) -> AwqBlockResult:
    """AWQ for a DeepSeek MLA block (``awq_quantize_mla_block`` :644), with
    every scale fold the absorbed path exposes:

    - attn_norm -> (q or q_a, kv_a): the ln -> fcs rule (reference
      scale.py:71-98); both read the same normed input.
    - q_a_norm -> q_b (q-LoRA models): ln -> fc again.
    - kv_b's W_UV columns -> o: the fc -> fc rule (scale.py:100-117). kv_b
      stays float (an absorbed einsum operand), so dividing its v columns
      costs nothing.

    No clip for the q / kv projections (the q / k rule, quantizer.py:287),
    a clip for o (its input comes from ``return_pre_o``). The MLP, dense or
    MoE, gets the full search as in ``awq_quantize_block``."""
    from quick_tpu_torch.modules.mla import MLAParams, mla_attention_forward

    G, zp = qcfg.q_group_size, qcfg.zero_point
    eps = cfg.rms_norm_eps
    attn_in = rms_norm(x, blk.attn_norm, eps)
    a = blk.attn
    hq, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim

    # the residual stream takes the FLOAT attention; the folds below are
    # exact rewrites of the same function
    attn_out, _ = mla_attention_forward(a, cfg, attn_in, rope_cos, rope_sin, None, 0, positions)
    x_mid = x + attn_out

    f32 = torch.float32
    attn_norm = blk.attn_norm.to(f32)
    q_w = a.q_proj.weight.to(f32)
    kva_w = a.kv_a_proj.weight.to(f32)
    qb_w = None if a.q_b_proj is None else a.q_b_proj.weight.to(f32)
    kvb_w = a.kv_b_proj.weight.to(f32)
    o_w = a.o_proj.weight.to(f32)
    q_a_norm = None if a.q_a_norm is None else a.q_a_norm.to(f32)

    def attn_fwd(qw, kvaw, qbw, kvbw, h, pre_o):
        a2 = dataclasses.replace(
            a,
            q_proj=dataclasses.replace(a.q_proj, weight=qw.to(x.dtype)),
            kv_a_proj=dataclasses.replace(a.kv_a_proj, weight=kvaw.to(x.dtype)),
            q_b_proj=(None if qbw is None
                      else dataclasses.replace(a.q_b_proj, weight=qbw.to(x.dtype))),
            kv_b_proj=dataclasses.replace(a.kv_b_proj, weight=kvbw.to(a.kv_b_proj.weight.dtype)),
        )
        return mla_attention_forward(a2, cfg, h, rope_cos, rope_sin, None, 0, positions,
                                     return_pre_o=pre_o)[0]

    if "qkv" not in skip:
        # -- attn_norm -> (q(_a), kv_a) -------------------------------------
        s1 = search_scale(
            _flat(attn_in), [q_w, kva_w],
            loss_forward=lambda ws: attn_fwd(ws[0], ws[1], qb_w, kvb_w, attn_in, False),
            group_size=G, zero_point=zp,
        )
        attn_norm = attn_norm / s1
        q_w = q_w * s1[:, None]
        kva_w = kva_w * s1[:, None]
        attn_in = attn_in / s1.to(attn_in.dtype)

        if qb_w is not None:
            # -- q_a_norm -> q_b --------------------------------------------
            qb_in = rms_norm(torch.matmul(attn_in.to(f32), q_w).to(attn_in.dtype), q_a_norm, eps)
            s2 = search_scale(
                _flat(qb_in), [qb_w],
                loss_forward=lambda ws: attn_fwd(q_w, kva_w, ws[0], kvb_w, attn_in, False),
                group_size=G, zero_point=zp,
            )
            q_a_norm = q_a_norm / s2
            qb_w = qb_w * s2[:, None]

    if "o" not in skip:
        # -- kv_b's W_UV columns -> o, and o's clip ---------------------------
        pre_o = attn_fwd(q_w, kva_w, qb_w, kvb_w, attn_in, True)
        s3 = search_scale(
            _flat(pre_o), [o_w],
            loss_forward=lambda ws: torch.matmul(_flat(pre_o), ws[0].to(pre_o.dtype)),
            group_size=G, zero_point=zp,
        )
        # kv_b's columns are head-major [dn | dv] sections: head h's v
        # section divides by s3[h * dv:(h + 1) * dv]
        kvb3 = kvb_w.reshape(-1, hq, dn + dv).clone()
        kvb3[:, :, dn:] = kvb3[:, :, dn:] / s3.reshape(hq, dv)[None]
        kvb_w = kvb3.reshape(kvb_w.shape)
        o_w = o_w * s3[:, None]
        if apply_clips:
            pre_o = pre_o / s3.to(pre_o.dtype)
            o_w = apply_clip(o_w, search_clip(o_w, _flat(pre_o), G, zp), G)

    def pack_lin(w, lin, name):
        if lin is None:
            return None
        if name in skip:
            return lin
        return QuantLinear.from_float(w.to(lin.weight.dtype), lin.bias, G, zp)

    new_attn = MLAParams(
        q_proj=pack_lin(q_w, a.q_proj, "qkv"),
        kv_a_proj=pack_lin(kva_w, a.kv_a_proj, "qkv"),
        kv_a_norm=a.kv_a_norm,
        # float: the absorbed einsum operand, holding the 1/s3 fold
        kv_b_proj=dataclasses.replace(a.kv_b_proj, weight=kvb_w.to(a.kv_b_proj.weight.dtype)),
        o_proj=pack_lin(o_w, a.o_proj, "o"),
        q_b_proj=pack_lin(qb_w, a.q_b_proj, "qkv") if qb_w is not None else a.q_b_proj,
        q_a_norm=None if q_a_norm is None else q_a_norm.to(a.q_a_norm.dtype),
    )

    mlp_norm = blk.mlp_norm.to(f32)
    mlp_in = rms_norm(x_mid, blk.mlp_norm, eps)
    if isinstance(blk.mlp, MoEParams):
        new_mlp, mlp_out, mlp_norm = _awq_moe(blk.mlp, cfg, mlp_in, mlp_norm, qcfg, apply_clips,
                                              skip=skip)
    else:
        new_mlp, mlp_out, mlp_norm = _awq_mlp(blk.mlp, cfg, mlp_in, mlp_norm, qcfg, apply_clips)
        new_mlp = MLPParams(
            gate_up_proj=_pack(new_mlp.gate_up_proj.weight, new_mlp.gate_up_proj.bias,
                               "gate_up", skip, qcfg),
            down_proj=_pack(new_mlp.down_proj.weight, new_mlp.down_proj.bias, "down", skip, qcfg),
        )
    new_block = BlockParams(
        attn_norm=attn_norm.to(blk.attn_norm.dtype),  # holds the 1/s1 fold
        attn=new_attn, mlp_norm=mlp_norm.to(blk.mlp_norm.dtype), mlp=new_mlp,
    )
    return AwqBlockResult(block=new_block, x_next=x_mid + mlp_out)


# ---------------------------------------------------------------------------
# Model-level pipeline
# ---------------------------------------------------------------------------

def awq_quantize_model(
    params,  # float ModelParams
    cfg: ModelConfig,
    calib_tokens,  # [B, S] int: numpy or a tensor
    qcfg: Optional[QuantConfig] = None,
    apply_clips: bool = True,
    verbose: bool = True,
):
    """The whole pipeline: per-block scale / clip search, quantize and pack
    (``awq_quantize_model`` :838; reference BaseAWQForCausalLM.quantize,
    models/base.py:91), block by block on the params' device; the head is
    RTN-packed under ``quantize_lm_head``."""
    from quick_tpu_torch.models.model import canonical_skips, check_supported, embed_scaled

    check_supported(cfg)  # the LayerNorm families' switches: ROADMAP A12
    qcfg = qcfg or QuantConfig()
    skip = canonical_skips(qcfg.modules_to_not_convert)
    dev = params.embed.device
    if isinstance(calib_tokens, torch.Tensor):
        tokens = calib_tokens.to(device=dev, dtype=torch.int64)
    else:
        tokens = torch.from_numpy(np.asarray(calib_tokens, np.int64)).to(dev)
    B, S = tokens.shape
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    new_blocks = []
    with torch.no_grad():
        # model_forward's embedding path: gemma's sqrt(D) scale, granite's
        # and minicpm's multiplier (:861-864; learned positions and the
        # embedding norm are A12)
        x = embed_scaled(params.embed[tokens].to(torch.bfloat16), cfg)
        for i, blk in enumerate(params.blocks):
            if cfg.is_mla:
                res = awq_quantize_mla_block(blk, cfg, x, positions, params.rope_cos,
                                             params.rope_sin, qcfg, apply_clips, skip=skip)
            else:
                # gemma3's sliding layers rope with the local tables (:892-899)
                res = awq_quantize_block(blk, cfg, x, positions, *params.layer_tables(cfg, i),
                                         qcfg, apply_clips, skip=skip,
                                         sliding=cfg.layer_is_sliding(i))
            new_blocks.append(res.block)
            x = res.x_next
            if verbose:
                print(f"[awq] block {i + 1}/{len(params.blocks)} quantized", flush=True)
        lm_head = params.lm_head
        if qcfg.quantize_lm_head and not isinstance(lm_head, QuantLinear):
            # RTN: the head has no downstream op to fold a scale out of
            lm_head = QuantLinear.from_float(lm_head.weight, lm_head.bias, qcfg.q_group_size,
                                             qcfg.zero_point)
    return dataclasses.replace(params, blocks=new_blocks, lm_head=lm_head)
