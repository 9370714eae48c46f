"""Checkpoint IO: the native quantized format, HF float import and AutoAWQ
interop (port of ``quick_tpu/utils/checkpoint.py``, llama path, dense and MoE,
and DeepSeek-V2 / V3).

- **native save / load** (``save_quantized`` :270, ``_load_flat`` :432,
  ``load_quantized`` :555): safetensors shards of at most ``SHARD_BYTES``
  under the JAX package's flat names, ``model.safetensors.index.json`` when
  there is more than one shard, ``quant_config.json``, and ``config.json``
  with an embedded ``quantization_config``. A checkpoint saved by either
  package loads in the other.
- **HF float import** (``_LazyRaw`` :588, ``load_hf_float`` :673,
  ``_import_llama_family`` :708): the llama schema, q/k/v and gate/up fused
  offline, with qwen3's per-head ``q_norm`` / ``k_norm`` and its MoE
  branches: mixtral's ``block_sparse_moe`` and qwen2_moe's / qwen3_moe's
  ``mlp.experts`` (qwen2_moe's with the gated shared expert), experts
  stacked on a leading axis; an unmapped type whose tensors follow the
  llama schema imports through it (the generic fallback); gemma2's
  sandwich norms take its branch. gemma / gemma2 / gemma3 (the +1 norm
  fold, gemma3's multimodal layout), olmo2, baichuan, qwen v1, phi3,
  internlm2 and llava's language tower take schema importers of their own
  (:1322-1680); granite and minicpm the llama importer. The norm-bias
  branch and the JAX package's LayerNorm families raise, naming the ROADMAP
  item that ports them (A12); no tensor is dropped silently (gemma3's
  vision tower is dropped unread, as in the JAX package). DeepSeek-V2 / V3
  take ``_import_deepseek`` (:1731): MLA (the rope channels permuted from
  HF's interleaved order to rotate-half) and DeepSeekMoE (shared experts,
  v3's ``e_score_correction_bias``); like the JAX importer it reads the
  first ``num_hidden_layers`` layers (V3's extra prediction layer stays
  unread).
- **AutoAWQ** (``load_autoawq`` :1924 with GEMM / GEMV / exllama dispatch on
  ``QuantConfig.version``, ``export_autoawq`` :312), dense llama models of
  the JAX package's ``_AUTOAWQ_OK`` types only: it maps no MoE or MLA keys
  there either.

Everything streams one tensor at a time (``utils/safetensors_io.py``):
each tensor is read from its file, converted and moved to the device
before the next is read. Loaders take ``device=`` (the card unless
``"cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig, QuantConfig
from quick_tpu_torch.device import DeviceLike, resolve_device
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import ModelParams, _tables, check_supported
from quick_tpu_torch.modules.blocks import AttentionParams, BlockParams, MLPParams, MoEParams
from quick_tpu_torch.modules.linear import Linear, QuantLinear, concat_linears
from quick_tpu_torch.modules.mla import MLAParams
from quick_tpu_torch.utils.safetensors_io import SafeOpen, save_file

SHARD_BYTES = 4 * 1024**3
INDEX_FILE = "model.safetensors.index.json"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# native save / load
# ---------------------------------------------------------------------------

def save_quantized(params: ModelParams, cfg: ModelConfig, qcfg: QuantConfig, save_dir: str) -> None:
    """Write the native checkpoint (``save_quantized`` :270): shards filled
    in ``params_to_flat`` order up to ``SHARD_BYTES``, one tensor copied to
    the host at a time."""
    os.makedirs(save_dir, exist_ok=True)
    store = params_to_flat(params, cpu=False)  # device tensors, copied per shard
    shards: List[List[str]] = [[]]
    sizes = [0]
    for k, v in store.items():
        n = _nbytes(v)
        if sizes[-1] + n > SHARD_BYTES and shards[-1]:
            shards.append([])
            sizes.append(0)
        shards[-1].append(k)
        sizes[-1] += n
    index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    n = len(shards)
    for i, keys in enumerate(shards):
        name = "model.safetensors" if n == 1 else f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_file({k: store[k] for k in keys}, os.path.join(save_dir, name))
        for k in keys:
            index["weight_map"][k] = name
    if n > 1:
        with open(os.path.join(save_dir, INDEX_FILE), "w") as f:
            json.dump(index, f, indent=2)
    qcfg.save_pretrained(save_dir)
    model_cfg = cfg.to_dict()
    model_cfg["quantization_config"] = qcfg.to_transformers_dict()
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(model_cfg, f, indent=2)


def _load_flat(model_dir: str) -> Tuple["_LazyRaw", dict]:
    """(the checkpoint's flat tensors, config.json): the tensors as a lazy
    mapping over the index's shards, read one at a time on access."""
    with open(os.path.join(model_dir, "config.json")) as f:
        raw_cfg = json.load(f)
    return _LazyRaw(model_dir), raw_cfg


def load_quantized(
    model_dir: str, device: DeviceLike = None,
) -> Tuple[ModelParams, ModelConfig, QuantConfig]:
    """Load a native checkpoint (``load_quantized`` :555) onto ``device``."""
    dev = resolve_device(device)
    flat, raw_cfg = _load_flat(model_dir)
    cfg = ModelConfig.from_dict(raw_cfg)
    qcfg = QuantConfig.from_pretrained(model_dir)
    params = params_from_flat(flat, cfg, device=dev, group_size=qcfg.q_group_size)
    return params, cfg, qcfg


# ---------------------------------------------------------------------------
# streaming access to safetensors checkpoints
# ---------------------------------------------------------------------------

def _checkpoint_files(model_dir: str) -> List[str]:
    index_path = os.path.join(model_dir, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    return sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))


class _LazyRaw:
    """Mapping over a safetensors checkpoint that reads each tensor (as a
    CPU tensor) on access, the streaming contract of the JAX package's
    ``_LazyRaw`` (:588) and of its ``_hf_tensor_iter`` (:569), which every
    loader here uses: ``in``, ``[]``, ``pop`` and ``keys``."""

    def __init__(self, model_dir: str):
        self._open: Dict[str, SafeOpen] = {}
        self._where: Dict[str, str] = {}
        for fname in _checkpoint_files(model_dir):
            f = SafeOpen(os.path.join(model_dir, fname))
            self._open[fname] = f
            for key in f.keys():
                self._where[key] = fname

    def __contains__(self, key) -> bool:
        return key in self._where

    def __getitem__(self, key) -> torch.Tensor:
        return self._open[self._where[key]].get_tensor(key)

    def pop(self, key, *default):
        if key not in self._where and default:
            return default[0]
        t = self[key]
        del self._where[key]
        return t

    def discard(self, key) -> None:
        """Drop a tensor unread (gemma3's vision tower)."""
        del self._where[key]

    def keys(self) -> List[str]:
        return list(self._where)


# ---------------------------------------------------------------------------
# HF float import (llama schema, dense and MoE)
# ---------------------------------------------------------------------------

def load_hf_float(
    model_dir: str, dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
) -> Tuple[ModelParams, ModelConfig]:
    """Import an HF float checkpoint into ModelParams on ``device``, fusing
    q/k/v and gate/up (``load_hf_float`` :673): the llama schema (dense,
    mixtral, qwen2_moe, qwen3 / qwen3_moe, granite, minicpm), a schema
    importer of its own for gemma / gemma2 / gemma3, olmo2, baichuan, qwen
    v1, phi3, internlm2, llava and DeepSeek-V2 / V3, and the generic llama
    fallback for an unmapped type whose tensors follow the llama schema; the
    rope tables, and gemma3's local ones (:836-844). The JAX package's
    LayerNorm families raise (ROADMAP A12)."""
    from quick_tpu_torch.models.auto import MODEL_TYPE_MAP, check_not_a12

    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = ModelConfig.from_hf_config(hf_cfg)
    check_not_a12(cfg.model_type, "HF import")
    check_supported(cfg)
    raw = _LazyRaw(model_dir)  # tensor at a time
    importer = _HF_IMPORTERS.get(cfg.model_type)
    if importer is not None:
        return importer(raw, cfg, dtype, dev), cfg
    # the generic llama-schema fallback: unmapped types that are llama clones
    # with a new model_type string import; anything else names the missing
    # tensor
    try:
        return _import_llama_family(raw, cfg, dtype, dev), cfg
    except KeyError as e:
        if cfg.model_type in MODEL_TYPE_MAP:
            raise  # a mapped llama-family type: a real missing tensor
        raise NotImplementedError(
            f"model_type '{cfg.model_type}' has no schema importer and its "
            f"checkpoint does not match the generic llama schema (missing tensor "
            f"{e}). Add an importer to utils/checkpoint.py::_HF_IMPORTERS."
        ) from None


def _mk_wv(raw, dtype, dev):
    """(W, V, B) bound to one raw tensor mapping (``_mk_wv`` :854): W pops a
    linear weight as [in, out], V a vector, B a bias or None; each is cast
    on the host, as the JAX package casts it, then moved."""

    def W(key):  # HF stores [out, in]; the port uses [in, out]
        return raw.pop(key).transpose(-1, -2).to(dtype).contiguous().to(dev)

    def V(key):
        return raw.pop(key).to(dtype).to(dev)

    def B(base):
        k = base + ".bias"
        return V(k) if k in raw else None

    return W, V, B


def _check_consumed(raw, cfg: ModelConfig, what: str) -> None:
    """No tensor dropped silently: what an importer left unread raises."""
    left = [k for k in raw.keys() if not k.endswith("rotary_emb.inv_freq")]
    if left:
        raise NotImplementedError(
            f"{cfg.model_type}: the {what} importer has no place for "
            f"{len(left)} tensors, e.g. {left[:4]} (ROADMAP A12)")


def _import_llama_family(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """The llama branch of ``_import_llama_family`` (:708), with the
    per-head ``q_norm`` / ``k_norm`` (:739-746), its mixtral (:748) and
    qwen2_moe / qwen3_moe (:761) MoE layers and gemma2's sandwich norms
    (:798-812). The norm-bias branch raises (ROADMAP A12)."""
    W, V, maybe_bias = _mk_wv(raw, dtype, dev)

    for key in raw.keys():
        for part in ("layernorm.bias", "model.norm.bias"):
            if part in key:
                raise NotImplementedError(
                    f"{cfg.model_type}: tensor {key} belongs to a branch of the "
                    "llama importer that is not ported yet (LayerNorm biases, ROADMAP A12)")
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        qw = W(f"{p}.self_attn.q_proj.weight")
        kw = W(f"{p}.self_attn.k_proj.weight")
        vw = W(f"{p}.self_attn.v_proj.weight")
        qb = maybe_bias(f"{p}.self_attn.q_proj")
        kb = maybe_bias(f"{p}.self_attn.k_proj")
        vb = maybe_bias(f"{p}.self_attn.v_proj")
        bias = torch.cat([qb, kb, vb]) if qb is not None else None
        qkv = Linear(torch.cat([qw, kw, vw], dim=1), bias)
        o = Linear(W(f"{p}.self_attn.o_proj.weight"), maybe_bias(f"{p}.self_attn.o_proj"))
        qn_key, kn_key = f"{p}.self_attn.q_norm.weight", f"{p}.self_attn.k_norm.weight"
        if (qn_key in raw or kn_key in raw) and not cfg.use_qk_norm:
            # the JAX importer would carry them and its forward ignore them
            raise NotImplementedError(
                f"{cfg.model_type}: the checkpoint has q_norm / k_norm tensors but "
                "its config turns no qk-norm on: a family whose qk-norm is not "
                "mapped yet (ROADMAP A12)")
        qn = V(qn_key) if qn_key in raw else None
        kn = V(kn_key) if kn_key in raw else None
        mlp = _import_mlp(p, raw, cfg, W)
        attn = AttentionParams(qkv_proj=qkv, o_proj=o, q_norm=qn, k_norm=kn)
        if f"{p}.pre_feedforward_layernorm.weight" in raw:
            # gemma2 / gemma3's sandwich norms (:798-812): HF's
            # post_attention_layernorm is the attention OUTPUT norm here, and
            # the MLP has its own pre / post pair
            blocks.append(BlockParams(
                attn_norm=V(f"{p}.input_layernorm.weight"), attn=attn,
                mlp_norm=V(f"{p}.pre_feedforward_layernorm.weight"), mlp=mlp,
                attn_post_norm=V(f"{p}.post_attention_layernorm.weight"),
                mlp_post_norm=V(f"{p}.post_feedforward_layernorm.weight"),
            ))
            continue
        blocks.append(BlockParams(
            attn_norm=V(f"{p}.input_layernorm.weight"), attn=attn,
            mlp_norm=V(f"{p}.post_attention_layernorm.weight"), mlp=mlp,
        ))
    embed = V("model.embed_tokens.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in raw:
        raw.pop("lm_head.weight", None)
        lm_head = Linear(embed.T)
    else:
        lm_head = Linear(W("lm_head.weight"))
    final_norm = V("model.norm.weight")
    _check_consumed(raw, cfg, "llama")
    return ModelParams(embed=embed, blocks=blocks, final_norm=final_norm,
                       lm_head=lm_head, **_tables(cfg, dev))


def _import_mlp(p: str, raw: _LazyRaw, cfg: ModelConfig, W) -> "MLPParams | MoEParams":
    """Layer ``p``'s MLP, chosen by its keys as the JAX importer chooses:
    mixtral's ``block_sparse_moe`` (experts w1 | w3 fused, w2), qwen2_moe's
    and qwen3_moe's ``mlp.experts`` (qwen2_moe's with the shared expert and
    its [D, 1] gate, qwen3_moe's without), or the dense gate / up / down.
    ``W`` pops a weight as [in, out]."""

    def fused(gate_key, up_key):
        return torch.cat([W(gate_key), W(up_key)], dim=1)

    def experts(base, g, u, d):
        n = range(cfg.num_local_experts)
        gu = torch.stack([fused(f"{base}.{e}.{g}.weight", f"{base}.{e}.{u}.weight") for e in n])
        return Linear(gu), Linear(torch.stack([W(f"{base}.{e}.{d}.weight") for e in n]))

    if cfg.is_moe and f"{p}.block_sparse_moe.gate.weight" in raw:
        gu, dn = experts(f"{p}.block_sparse_moe.experts", "w1", "w3", "w2")
        return MoEParams(router=Linear(W(f"{p}.block_sparse_moe.gate.weight")),
                         gate_up_proj=gu, down_proj=dn)
    if cfg.is_moe and f"{p}.mlp.gate.weight" in raw:
        gu, dn = experts(f"{p}.mlp.experts", "gate_proj", "up_proj", "down_proj")
        shared = {}
        sh = f"{p}.mlp.shared_expert"
        if f"{sh}.gate_proj.weight" in raw:
            shared = dict(
                shared_gate_up=Linear(fused(f"{sh}.gate_proj.weight", f"{sh}.up_proj.weight")),
                shared_down=Linear(W(f"{sh}.down_proj.weight")),
                shared_gate=Linear(W(f"{p}.mlp.shared_expert_gate.weight")),  # [D, 1]
            )
        return MoEParams(router=Linear(W(f"{p}.mlp.gate.weight")), gate_up_proj=gu,
                         down_proj=dn, **shared)
    return MLPParams(gate_up_proj=Linear(fused(f"{p}.mlp.gate_proj.weight",
                                               f"{p}.mlp.up_proj.weight")),
                     down_proj=Linear(W(f"{p}.mlp.down_proj.weight")))


def _import_deepseek(raw: _LazyRaw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """DeepSeek-V2 / V3 (``_import_deepseek`` :1731; HF modeling_deepseek):
    MLA attention, the query projection full (V2-Lite) or LoRA-factored
    (q_a, q_a_layernorm, q_b), the latent through kv_a_proj_with_mqa, and
    DeepSeekMoE (dense first layers; routed experts with gate | up fused
    and stacked; ungated shared experts; v3's ``e_score_correction_bias``
    as ``score_bias`` in f32). The rope channels of q and kv_a are stored
    in HF's interleaved order and permuted here to rotate-half."""
    hq = cfg.num_attention_heads
    dn, dr, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])

    def W(key):  # HF stores [out, in]; the port uses [in, out]
        return raw.pop(key).transpose(-1, -2).to(dtype).contiguous()

    def V(key):
        return raw.pop(key).to(dtype).to(dev)

    def permute_q(w):  # [Din, hq*(dn+dr)]: each head's pe to rotate-half
        wh = w.reshape(w.shape[0], hq, dn + dr)
        return torch.cat([wh[:, :, :dn], wh[:, :, dn:][:, :, perm]], dim=2).reshape(w.shape[0], -1)

    def lin(w):
        return Linear(w.contiguous().to(dev))

    def fused(g, u):
        return torch.cat([W(g), W(u)], dim=1)

    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        if f"{a}.q_a_proj.weight" in raw:
            q = lin(W(f"{a}.q_a_proj.weight"))
            q_b = lin(permute_q(W(f"{a}.q_b_proj.weight")))
            q_a_norm = V(f"{a}.q_a_layernorm.weight")
        else:  # V2-Lite: the full q projection
            q, q_b, q_a_norm = lin(permute_q(W(f"{a}.q_proj.weight"))), None, None
        kva = W(f"{a}.kv_a_proj_with_mqa.weight")  # [D, R + dr]
        attn = MLAParams(
            q_proj=q,
            kv_a_proj=lin(torch.cat([kva[:, :R], kva[:, R:][:, perm]], dim=1)),
            kv_a_norm=V(f"{a}.kv_a_layernorm.weight"),
            kv_b_proj=lin(W(f"{a}.kv_b_proj.weight")),
            o_proj=lin(W(f"{a}.o_proj.weight")),
            q_b_proj=q_b, q_a_norm=q_a_norm,
        )
        if f"{p}.mlp.gate.weight" in raw:  # an MoE layer
            n = range(cfg.num_local_experts)
            ex = f"{p}.mlp.experts"
            gu = torch.stack([fused(f"{ex}.{e}.gate_proj.weight", f"{ex}.{e}.up_proj.weight")
                              for e in n])
            dn_w = torch.stack([W(f"{ex}.{e}.down_proj.weight") for e in n])
            sh = f"{p}.mlp.shared_experts"
            shared = {}
            if f"{sh}.gate_proj.weight" in raw:
                shared = dict(
                    shared_gate_up=lin(fused(f"{sh}.gate_proj.weight", f"{sh}.up_proj.weight")),
                    shared_down=lin(W(f"{sh}.down_proj.weight")))
            bias_key = f"{p}.mlp.gate.e_score_correction_bias"
            mlp = MoEParams(
                router=lin(W(f"{p}.mlp.gate.weight")), gate_up_proj=lin(gu), down_proj=lin(dn_w),
                score_bias=(raw.pop(bias_key).to(torch.float32).to(dev)
                            if bias_key in raw else None),
                **shared,
            )
        else:
            mlp = MLPParams(
                gate_up_proj=lin(fused(f"{p}.mlp.gate_proj.weight", f"{p}.mlp.up_proj.weight")),
                down_proj=lin(W(f"{p}.mlp.down_proj.weight")))
        blocks.append(BlockParams(attn_norm=V(f"{p}.input_layernorm.weight"), attn=attn,
                                  mlp_norm=V(f"{p}.post_attention_layernorm.weight"), mlp=mlp))
    embed = V("model.embed_tokens.weight")
    lm_head = lin(W("lm_head.weight")) if "lm_head.weight" in raw else Linear(embed.T)
    return ModelParams(embed=embed, blocks=blocks, final_norm=V("model.norm.weight"),
                       lm_head=lm_head, **_tables(cfg, dev))


def _degroup_falcon_qkv(w: torch.Tensor, hq: int, hkv: int, hd: int) -> torch.Tensor:
    """A grouped fused qkv (columns [kv groups, q per group + 2, hd]: falcon's
    new decoder, internlm2) -> straight [q | k | v] (``_degroup_falcon_qkv``
    :892)."""
    D = w.shape[0]
    g = hq // hkv
    w4 = w.reshape(D, hkv, g + 2, hd)
    return torch.cat([w4[:, :, :g].reshape(D, hq * hd), w4[:, :, g].reshape(D, hkv * hd),
                      w4[:, :, g + 1].reshape(D, hkv * hd)], dim=1)


def _import_baichuan(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """Baichuan (``_import_baichuan`` :1322): the llama layout with a fused
    ``W_pack`` qkv. Baichuan2 (vocab 125696, the same model_type) L2-normalizes
    each output row of its head at inference (NormHead): the normalization
    is folded into the stored weight in f32, as at :1352-1359."""
    W, V, _ = _mk_wv(raw, dtype, dev)
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        gate = W(f"{p}.mlp.gate_proj.weight")
        up = W(f"{p}.mlp.up_proj.weight")
        blocks.append(BlockParams(
            attn_norm=V(f"{p}.input_layernorm.weight"),
            attn=AttentionParams(qkv_proj=Linear(W(f"{p}.self_attn.W_pack.weight")),
                                 o_proj=Linear(W(f"{p}.self_attn.o_proj.weight"))),
            mlp_norm=V(f"{p}.post_attention_layernorm.weight"),
            mlp=MLPParams(gate_up_proj=Linear(torch.cat([gate, up], dim=1)),
                          down_proj=Linear(W(f"{p}.mlp.down_proj.weight"))),
        ))
    embed = V("model.embed_tokens.weight")
    if "lm_head.weight" in raw:
        hw = W("lm_head.weight")  # [D, vocab]
        if cfg.vocab_size == 125696:
            hf = hw.to(torch.float32)
            norm = torch.linalg.norm(hf, dim=0, keepdim=True)  # jnp.linalg.norm's sums
            hw = (hf / torch.clamp(norm, min=1e-7)).to(embed.dtype)
        lm_head = Linear(hw)
    else:
        lm_head = Linear(embed.T)
    final_norm = V("model.norm.weight")
    _check_consumed(raw, cfg, "baichuan")
    return ModelParams(embed=embed, blocks=blocks, final_norm=final_norm, lm_head=lm_head,
                       **_tables(cfg, dev))


def _import_qwen(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """Qwen v1 (``_import_qwen`` :1373): ``transformer.h.{i}`` with ln_1, the
    fused ``attn.c_attn`` with its bias, a bias-free ``attn.c_proj``, ln_2 and
    the SwiGLU ``mlp.w1`` / ``w2`` / ``c_proj``. HF Qwen computes
    c_proj(w1(x) * silu(w2(x))): w2 is the gate and w1 the up. Within the
    training sequence length only (no dynamic NTK / logn attention, as in
    the JAX package)."""
    W, V, B = _mk_wv(raw, dtype, dev)
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        w2 = W(f"{p}.mlp.w2.weight")
        w1 = W(f"{p}.mlp.w1.weight")
        blocks.append(BlockParams(
            attn_norm=V(f"{p}.ln_1.weight"),
            attn=AttentionParams(
                qkv_proj=Linear(W(f"{p}.attn.c_attn.weight"), B(f"{p}.attn.c_attn")),
                o_proj=Linear(W(f"{p}.attn.c_proj.weight"))),
            mlp_norm=V(f"{p}.ln_2.weight"),
            mlp=MLPParams(gate_up_proj=Linear(torch.cat([w2, w1], dim=1)),
                          down_proj=Linear(W(f"{p}.mlp.c_proj.weight"))),
        ))
    embed = V("transformer.wte.weight")
    lm_head = Linear(W("lm_head.weight")) if "lm_head.weight" in raw else Linear(embed.T)
    final_norm = V("transformer.ln_f.weight")
    _check_consumed(raw, cfg, "qwen")
    return ModelParams(embed=embed, blocks=blocks, final_norm=final_norm, lm_head=lm_head,
                       **_tables(cfg, dev))


class _Renamed:
    """The tensors of a raw mapping under other names (``names``: new name
    -> the file's key), read on access."""

    def __init__(self, raw, names: Dict[str, str]):
        self._raw, self._names = raw, names

    def __contains__(self, key) -> bool:
        return key in self._names

    def __getitem__(self, key):
        return self._raw[self._names[key]]

    def pop(self, key, *default):
        if key not in self._names and default:
            return default[0]
        return self._raw.pop(self._names.pop(key))

    def keys(self) -> List[str]:
        return list(self._names)


def _import_llava(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """LLaVA (``_import_llava`` :1425): the language tower only, the llama
    importer over the ``language_model.`` tensors. The vision tower's
    tensors stay unread (ROADMAP A16)."""
    n = len("language_model.")
    lang = _Renamed(raw, {k[n:]: k for k in raw.keys() if k.startswith("language_model.")})
    if not lang.keys():
        raise ValueError("no language_model.* tensors found in llava checkpoint")
    return _import_llama_family(lang, cfg, dtype, dev)


def _import_phi3(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """Phi-3 / 3.5 / 4 (``_import_phi3`` :1524): the llama tree with
    pre-fused ``qkv_proj`` ([q | k | v] rows) and ``gate_up_proj`` ([gate |
    up] rows), the port's fused column layout after the transpose. Rope over
    ``rotary_dim or head_dim``, longrope through ``cfg.rope_scaling``."""
    W, V, B = _mk_wv(raw, dtype, dev)
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        blocks.append(BlockParams(
            attn_norm=V(f"{p}.input_layernorm.weight"),
            attn=AttentionParams(
                qkv_proj=Linear(W(f"{p}.self_attn.qkv_proj.weight"), B(f"{p}.self_attn.qkv_proj")),
                o_proj=Linear(W(f"{p}.self_attn.o_proj.weight"), B(f"{p}.self_attn.o_proj"))),
            mlp_norm=V(f"{p}.post_attention_layernorm.weight"),
            mlp=MLPParams(gate_up_proj=Linear(W(f"{p}.mlp.gate_up_proj.weight")),
                          down_proj=Linear(W(f"{p}.mlp.down_proj.weight"))),
        ))
    embed = V("model.embed_tokens.weight")
    if "lm_head.weight" in raw and not cfg.tie_word_embeddings:
        lm_head = Linear(W("lm_head.weight"))
    else:
        raw.pop("lm_head.weight", None)
        lm_head = Linear(embed.T)
    final_norm = V("model.norm.weight")
    _check_consumed(raw, cfg, "phi3")
    return ModelParams(embed=embed, blocks=blocks, final_norm=final_norm, lm_head=lm_head,
                       **_tables(cfg, dev))


def _import_internlm2(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """InternLM2 (``_import_internlm2`` :1625): llama numerics with renamed
    tensors (attention.wqkv / wo, feed_forward.w1 / w3 / w2, attention_norm /
    ffn_norm, model.tok_embeddings, output) and a grouped fused ``wqkv``
    whose columns are [hkv, g + 2, hd], degrouped with its bias."""
    W, V, B = _mk_wv(raw, dtype, dev)
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        wqkv = _degroup_falcon_qkv(W(f"{p}.attention.wqkv.weight"), hq, hkv, hd)
        b = B(f"{p}.attention.wqkv")
        bqkv = None if b is None else _degroup_falcon_qkv(b[None, :], hq, hkv, hd)[0]
        gate = W(f"{p}.feed_forward.w1.weight")
        up = W(f"{p}.feed_forward.w3.weight")
        blocks.append(BlockParams(
            attn_norm=V(f"{p}.attention_norm.weight"),
            attn=AttentionParams(qkv_proj=Linear(wqkv, bqkv),
                                 o_proj=Linear(W(f"{p}.attention.wo.weight"),
                                               B(f"{p}.attention.wo"))),
            mlp_norm=V(f"{p}.ffn_norm.weight"),
            mlp=MLPParams(gate_up_proj=Linear(torch.cat([gate, up], dim=1)),
                          down_proj=Linear(W(f"{p}.feed_forward.w2.weight"))),
        ))
    embed = V("model.tok_embeddings.weight")
    lm_head = Linear(W("output.weight")) if "output.weight" in raw else Linear(embed.T)
    final_norm = V("model.norm.weight")
    _check_consumed(raw, cfg, "internlm2")
    return ModelParams(embed=embed, blocks=blocks, final_norm=final_norm, lm_head=lm_head,
                       **_tables(cfg, dev))


class _Folded:
    """A raw mapping whose zero-centered norm weights (``fold(key)``) read
    as w + 1.0, added in the file's own dtype before any cast, as the JAX
    importers add it to the raw array (:1447-1449, :1467-1469): folding
    after a bf16 cast would move a weight by an ulp."""

    def __init__(self, raw, fold):
        self._raw, self._fold = raw, fold

    def __contains__(self, key) -> bool:
        return key in self._raw

    def _folded(self, key, t):
        return t + 1.0 if self._fold(key) else t

    def __getitem__(self, key):
        return self._folded(key, self._raw[key])

    def pop(self, key, *default):
        if key not in self._raw and default:
            return default[0]
        return self._folded(key, self._raw.pop(key))

    def keys(self) -> List[str]:
        return self._raw.keys()


def _import_gemma(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """Gemma / Gemma2 (``_import_gemma`` :1439): the llama layout (gemma2's
    four sandwich norms through the llama importer's branch) with its
    RMSNorm weights stored zero-centered: every ``*layernorm.weight`` and
    ``model.norm.weight`` reads as w + 1. The sqrt(D) embedding scale is a
    config switch; the head is tied."""
    fold = _Folded(raw, lambda k: k.endswith("layernorm.weight") or k == "model.norm.weight")
    return _import_llama_family(fold, cfg, dtype, dev)


def _import_gemma3(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """Gemma3 (``_import_gemma3`` :1453): gemma2's layout plus per-head q / k
    RMSNorms, every ``*norm.weight`` stored zero-centered (q / k norms
    included). A multimodal checkpoint's language tower is under
    ``language_model.``, stripped here; its ``vision_tower.*`` and
    ``multi_modal_projector.*`` tensors are dropped unread, as the JAX
    importer drops them."""
    names = {}  # the language tower's names -> the file's keys
    n = len("language_model.")
    for k in raw.keys():
        if k.startswith("language_model."):
            names[k[n:]] = k
        elif k.startswith(("vision_tower.", "multi_modal_projector.")):
            raw.discard(k)
        else:
            names[k] = k
    lang = _Renamed(raw, names)
    return _import_llama_family(_Folded(lang, lambda k: k.endswith("norm.weight")), cfg, dtype,
                                dev)


def _import_olmo2(raw, cfg: ModelConfig, dtype, dev) -> ModelParams:
    """OLMo-2 (``_import_olmo2`` :1680): the llama tree whose only norms are
    the post-norms on each sub-layer's output (no pre-norms), plus the
    full-width q / k RMSNorm before the head reshape; the head untied where
    the file has one."""
    W, V, _ = _mk_wv(raw, dtype, dev)
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        qw, kw, vw = (W(f"{p}.self_attn.{n}_proj.weight") for n in "qkv")
        gate = W(f"{p}.mlp.gate_proj.weight")
        up = W(f"{p}.mlp.up_proj.weight")
        blocks.append(BlockParams(
            attn_norm=None,
            attn=AttentionParams(
                qkv_proj=Linear(torch.cat([qw, kw, vw], dim=1)),
                o_proj=Linear(W(f"{p}.self_attn.o_proj.weight")),
                q_norm=V(f"{p}.self_attn.q_norm.weight"),
                k_norm=V(f"{p}.self_attn.k_norm.weight")),
            mlp_norm=None,
            mlp=MLPParams(gate_up_proj=Linear(torch.cat([gate, up], dim=1)),
                          down_proj=Linear(W(f"{p}.mlp.down_proj.weight"))),
            attn_post_norm=V(f"{p}.post_attention_layernorm.weight"),
            mlp_post_norm=V(f"{p}.post_feedforward_layernorm.weight"),
        ))
    embed = V("model.embed_tokens.weight")
    lm_head = Linear(W("lm_head.weight")) if "lm_head.weight" in raw else Linear(embed.T)
    final_norm = V("model.norm.weight")
    _check_consumed(raw, cfg, "olmo2")
    return ModelParams(embed=embed, blocks=blocks, final_norm=final_norm, lm_head=lm_head,
                       **_tables(cfg, dev))


#: model types with an importer of their own (the ported part of the JAX
#: ``_HF_IMPORTERS``, :1890); every other type takes ``_import_llama_family``
#: (granite's and minicpm's multipliers are config switches)
_HF_IMPORTERS = {
    "gemma": _import_gemma,
    "gemma2": _import_gemma,
    "gemma3": _import_gemma3,
    "olmo2": _import_olmo2,
    "llava": _import_llava,
    "baichuan": _import_baichuan,
    "qwen": _import_qwen,
    "phi3": _import_phi3,
    "internlm2": _import_internlm2,
    "deepseek_v2": _import_deepseek,
    "deepseek_v3": _import_deepseek,
}


# ---------------------------------------------------------------------------
# AutoAWQ interop
# ---------------------------------------------------------------------------

#: the model types ``load_autoawq`` maps: the JAX package's ``_AUTOAWQ_OK``
#: (:1946-1949), the plain llama rmsnorm schema. Other families (qk-norms,
#: fused or renamed tensors, norm conventions) would load into garbage
_AUTOAWQ_OK = frozenset({
    "llama", "mistral", "vicuna", "yi", "aquila", "qwen2", "mixtral",
    "tinyllama", "deepseek",
})


def load_autoawq(
    model_dir: str, device: DeviceLike = None,
) -> Tuple[ModelParams, ModelConfig, QuantConfig]:
    """Convert an AutoAWQ quantized checkpoint to QTPU params on ``device``
    (``load_autoawq`` :1924): GEMM layout (qweight int32 [K, N//8], qzeros
    [K//G, N//8], fp16 scales [K//G, N]), GEMV layout or exllama / GPTQ
    layout, as ``QuantConfig.version`` says."""
    from quick_tpu_torch.quantize.packing import import_awq_gemm, import_awq_gemv, import_exllama

    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = ModelConfig.from_hf_config(hf_cfg)
    if cfg.model_type not in _AUTOAWQ_OK:
        raise NotImplementedError(
            f"AutoAWQ import supports the plain llama-schema families "
            f"{sorted(_AUTOAWQ_OK)}; '{cfg.model_type}' checkpoints carry "
            f"norm/attention conventions this loader does not map — "
            f"quantize from the float checkpoint instead "
            f"(AutoQuickModel.from_pretrained + .quantize)")
    check_supported(cfg)
    if cfg.is_moe or cfg.is_mla:
        raise NotImplementedError(
            f"{cfg.model_type}: AutoAWQ MoE and MLA checkpoints are not mapped (the "
            "JAX loader reads only the llama attention and dense mlp.*_proj keys, "
            ":2006-2010) — ROADMAP A10")
    qcfg = QuantConfig.from_pretrained(model_dir)
    G = qcfg.q_group_size
    version = qcfg.version.lower()
    if version.startswith("exllama"):
        importer = import_exllama
    elif version == "gemv":
        importer = import_awq_gemv
    else:
        importer = import_awq_gemm
    raw = _LazyRaw(model_dir)

    def qlin(base: str) -> QuantLinear:
        qw, s, zs = importer(
            raw.pop(base + ".qweight").numpy(),
            raw.pop(base + ".qzeros").numpy(),
            raw.pop(base + ".scales").numpy().astype(np.float32),
            G,
        )
        b = raw.pop(base + ".bias", None)
        return QuantLinear(
            qweight=torch.from_numpy(qw).to(dev), scales=torch.from_numpy(s).to(dev),
            zeros_x_scales=torch.from_numpy(zs).to(dev),
            bias=None if b is None else b.to(torch.float32).to(dev), group_size=G,
        )

    def V(key):
        return raw.pop(key).to(torch.bfloat16).to(dev)

    def W(key):
        return raw.pop(key).transpose(-1, -2).to(torch.bfloat16).contiguous().to(dev)

    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        qkv = concat_linears(qlin(f"{p}.self_attn.q_proj"), qlin(f"{p}.self_attn.k_proj"),
                             qlin(f"{p}.self_attn.v_proj"))
        o = qlin(f"{p}.self_attn.o_proj")
        gate_up = concat_linears(qlin(f"{p}.mlp.gate_proj"), qlin(f"{p}.mlp.up_proj"))
        down = qlin(f"{p}.mlp.down_proj")
        blocks.append(BlockParams(
            attn_norm=V(f"{p}.input_layernorm.weight"),
            attn=AttentionParams(qkv_proj=qkv, o_proj=o),
            mlp_norm=V(f"{p}.post_attention_layernorm.weight"),
            mlp=MLPParams(gate_up_proj=gate_up, down_proj=down),
        ))
    embed = V("model.embed_tokens.weight")
    lm_head = Linear(W("lm_head.weight")) if "lm_head.weight" in raw else Linear(embed.T)
    params = ModelParams(embed=embed, blocks=blocks, final_norm=V("model.norm.weight"),
                         lm_head=lm_head, **_tables(cfg, dev))
    return params, cfg, qcfg


def export_autoawq(params: ModelParams, cfg: ModelConfig, qcfg: QuantConfig, save_dir: str) -> None:
    """Write an AutoAWQ-GEMM checkpoint (``export_autoawq`` :312): per linear
    ``qweight`` int32 [K, N//8], ``qzeros`` int32 [K//G, N//8], ``scales``
    fp16 [K//G, N] under HF llama tensor names, the fused qkv / gate_up
    split back by column ranges; ``config.json`` in HF form, version
    "gemm". Dense llama layout only."""
    from quick_tpu_torch.quantize.packing import export_awq_gemm, unpack_qtpu

    if cfg.is_moe or cfg.is_mla:
        raise NotImplementedError(
            f"export_autoawq: MoE and MLA models are not exported, as in the JAX "
            f"package (:332; model_type={cfg.model_type}) — ROADMAP A10")
    if not cfg.gated_mlp or cfg.layernorm != "rmsnorm" or cfg.use_qk_norm:
        # AutoAWQ files carry no q / k norms (``load_autoawq`` refuses qwen3)
        raise NotImplementedError(
            f"export_autoawq supports the llama-family layout only (model_type={cfg.model_type})")
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    F = cfg.intermediate_size
    store: Dict[str, np.ndarray] = {}

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def f16(t: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(host(t.to(torch.float16)))

    def put_qlin(base: str, lin: QuantLinear, col0: int, col1: int) -> None:
        gw, gz, gs = export_awq_gemm(
            host(lin.qweight[:, col0:col1]), host(lin.scales[:, col0:col1]),
            host(lin.zeros_x_scales[:, col0:col1]), lin.group_size)
        store[base + ".qweight"] = gw
        store[base + ".qzeros"] = gz
        store[base + ".scales"] = gs
        if lin.bias is not None:
            store[base + ".bias"] = f16(lin.bias[col0:col1])

    def put_float_linear(base: str, lin) -> None:
        if isinstance(lin, QuantLinear):
            q = unpack_qtpu(host(lin.qweight), lin.group_size)
            s, zs = host(lin.scales), host(lin.zeros_x_scales)
            K = q.shape[0]
            ng = K // lin.group_size
            w = (q.astype(np.float32).reshape(ng, lin.group_size, -1) * s[:, None, :]
                 - zs[:, None, :]).reshape(K, -1)
        else:
            w = host(lin.weight.to(torch.float32))
        store[base + ".weight"] = np.ascontiguousarray(w.T.astype(np.float16))  # HF [out, in]
        if lin.bias is not None:
            store[base + ".bias"] = f16(lin.bias)

    for i, blk in enumerate(params.blocks):
        p = f"model.layers.{i}"
        qkv = blk.attn.qkv_proj
        if not isinstance(qkv, QuantLinear):
            raise ValueError("export_autoawq requires quantized block linears")
        put_qlin(f"{p}.self_attn.q_proj", qkv, 0, hq * hd)
        put_qlin(f"{p}.self_attn.k_proj", qkv, hq * hd, (hq + hkv) * hd)
        put_qlin(f"{p}.self_attn.v_proj", qkv, (hq + hkv) * hd, (hq + 2 * hkv) * hd)
        put_qlin(f"{p}.self_attn.o_proj", blk.attn.o_proj, 0, cfg.hidden_size)
        put_qlin(f"{p}.mlp.gate_proj", blk.mlp.gate_up_proj, 0, F)
        put_qlin(f"{p}.mlp.up_proj", blk.mlp.gate_up_proj, F, 2 * F)
        put_qlin(f"{p}.mlp.down_proj", blk.mlp.down_proj, 0, cfg.hidden_size)
        store[f"{p}.input_layernorm.weight"] = f16(blk.attn_norm)
        store[f"{p}.post_attention_layernorm.weight"] = f16(blk.mlp_norm)
    store["model.embed_tokens.weight"] = f16(params.embed)
    store["model.norm.weight"] = f16(params.final_norm)
    if not cfg.tie_word_embeddings:
        put_float_linear("lm_head", params.lm_head)

    os.makedirs(save_dir, exist_ok=True)
    save_file(store, os.path.join(save_dir, "model.safetensors"))
    qcfg = dataclasses.replace(qcfg, version="gemm")  # the artifact IS GEMM layout
    hf_cfg = {
        "model_type": cfg.model_type if cfg.model_type in ("llama", "mistral", "qwen2") else "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "head_dim": cfg.head_dim,
        "attention_bias": cfg.attention_bias,
        "torch_dtype": "float16",
        "quantization_config": qcfg.to_transformers_dict(),
    }
    if cfg.rope_scaling:
        hf_cfg["rope_scaling"] = dict(cfg.rope_scaling)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    qcfg.save_pretrained(save_dir)
