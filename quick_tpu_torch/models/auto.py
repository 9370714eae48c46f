"""High-level model API (port of ``quick_tpu/models/auto.py``, the RMSNorm
families with dense or MoE MLPs: llama, mistral, qwen2, qwen, baichuan,
phi3, internlm2, llava's language tower, mixtral, qwen2_moe, qwen3,
qwen3_moe, gemma, gemma2, gemma3, olmo2, granite and minicpm; and
DeepSeek-V2 / V3, MLA with DeepSeekMoE):

    model = AutoQuickModel.from_pretrained(hf_dir)             # float import
    model.quantize(calib_tokens, QuantConfig())                # AWQ search + pack
    model.quantize(quant_config=QuantConfig())                 # RTN + pack
    model.save_quantized(out_dir)                              # native QTPU
    model.save_quantized(awq_dir, awq_format=True)             # AutoAWQ GEMM
    model = AutoQuickModel.from_quantized(out_dir)             # QTPU or AutoAWQ
    model = AutoQuickModel.from_gguf(path)                     # llama.cpp, g=32
    out = model.generate(tokens, max_new_tokens=64)

Every constructor puts the weights on the card unless given
``device="cpu"``; the AWQ search runs where the weights are
(``quantize/awq.py``). Not ported: the tokenizer and ``generate_text`` (``transformers`` is not a dependency of
the port; a GGUF file's tokenizer waits for A14), the vision tower and
``shard`` (ROADMAP A7, A15, A16).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import torch

from quick_tpu_torch.config import ModelConfig, QuantConfig
from quick_tpu_torch.device import DeviceLike, resolve_device

#: the ported part of quick_tpu's MODEL_TYPE_MAP (:30-88), model_type ->
#: config switch overrides: the llama architecture types (baichuan, qwen v1,
#: phi3, internlm2 and llava's language tower import through schema
#: importers of their own), mixtral (MoE through ``num_local_experts``),
#: qwen2_moe, qwen3 / qwen3_moe (per-head q / k RMSNorm), deepseek_v2 / v3,
#: and gemma, gemma2, gemma3, olmo2, granite and minicpm (:57-81). The
#: LayerNorm families are ROADMAP A12.
MODEL_TYPE_MAP: Dict[str, dict] = {
    "llama": {},
    "mistral": {},
    "vicuna": {},
    "yi": {},
    "aquila": {},
    "qwen2": {},
    "qwen": {"attention_bias": True},
    "mixtral": {},
    "baichuan": {},
    "llava": {},  # the language tower; the vision tower is A16
    "qwen3": {"use_qk_norm": True},
    "qwen2_moe": {
        "moe_router": "softmax_all", "moe_freq_shifted": True,
        "attention_bias": True, "shared_expert_gate": True,
        "n_shared_experts": 1, "norm_topk_prob": False,
    },
    "qwen3_moe": {
        "use_qk_norm": True, "moe_router": "softmax_all",
        "moe_freq_shifted": True, "norm_topk_prob": True,
    },
    "phi3": {},
    "internlm2": {},
    "deepseek_v2": {"moe_router": "deepseek"},
    "deepseek_v3": {"moe_router": "deepseek", "scoring_func": "sigmoid"},
    # the RMSNorm families off the llama path: gemma's GeGLU, sqrt(D)
    # embedding scale and +1 norms, gemma2's sandwich norms and softcaps,
    # gemma3's per-head qk-norm and dual rope, olmo2's post-norms and
    # full-width qk-norm, granite's and minicpm's multipliers (their values
    # come from the HF config)
    "gemma": {"act_fn": "gelu", "embed_scale": True, "tie_word_embeddings": True},
    "gemma2": {"act_fn": "gelu", "embed_scale": True, "tie_word_embeddings": True,
               "use_post_norms": True, "attn_logit_softcap": 50.0,
               "final_logit_softcap": 30.0},
    "gemma3": {"act_fn": "gelu", "embed_scale": True, "tie_word_embeddings": True,
               "use_post_norms": True, "use_qk_norm": True},
    "granite": {"tie_word_embeddings": True},
    "olmo2": {"use_post_norms": True, "pre_norms": False, "use_qk_norm": True,
              "qk_norm_full": True},
    "minicpm": {"tie_word_embeddings": True},
}

#: the rest of quick_tpu's MODEL_TYPE_MAP and ``_HF_IMPORTERS``: the
#: LayerNorm, ALiBi and parallel-residual families, which the port does not
#: run yet. Their configs must not fall back to the llama path, which the JAX
#: package does not run them on
A12_TYPES = frozenset({
    "gpt_neox", "gptj", "opt", "bloom", "mpt", "falcon", "RefinedWeb", "RefinedWebModel",
    "gpt_bigcode", "phi", "cohere", "starcoder2", "stablelm",
})


def check_not_a12(model_type: str, what: str) -> None:
    """Refuse a family the JAX package maps that the port does not run yet."""
    if model_type in A12_TYPES:
        raise NotImplementedError(
            f"{what}: model_type {model_type!r} is not ported yet; the port maps "
            f"{sorted(MODEL_TYPE_MAP)} (ROADMAP A12)")


#: QuantConfig versions that name an AutoAWQ layout (converted at load)
AUTOAWQ_VERSIONS = ("gemm", "gemv", "exllama", "exllamav2")


def check_and_get_model_type(model_type: str, allow_fallback: bool = False) -> str:
    """Check a model type against the registry (``check_and_get_model_type``
    :92). With ``allow_fallback=True`` (the HF and quantized loaders) an
    unmapped type whose tensors imported through the generic llama schema
    runs with llama-family semantics and a warning; otherwise it raises
    ``TypeError``."""
    check_not_a12(model_type, "model type")
    if model_type not in MODEL_TYPE_MAP:
        if allow_fallback:
            warnings.warn(
                f"model_type '{model_type}' is not in the registry; it "
                "was imported via the generic llama-family fallback and "
                "will RUN with llama-family semantics. Verify outputs "
                "against the source model — family-specific switches "
                "(norm kind, softcaps, windows, qk-norm, ...) are NOT "
                "auto-detected.",
                stacklevel=2,
            )
            return model_type
        raise TypeError(f"{model_type} isn't supported yet. Supported: {sorted(MODEL_TYPE_MAP)}")
    return model_type


def apply_model_type(cfg: ModelConfig) -> ModelConfig:
    """The registry's switch overrides for ``cfg.model_type`` (none for an
    unmapped type, which runs the llama path: ``apply_model_type`` :125)."""
    check_not_a12(cfg.model_type, "model type")
    overrides = MODEL_TYPE_MAP.get(cfg.model_type, {})
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


class AutoQuickModel:
    """Stateful convenience wrapper over the functional core."""

    def __init__(self, params, cfg: ModelConfig, qcfg: Optional[QuantConfig] = None):
        from quick_tpu_torch.modules.linear import cast_scales_env

        # every load path passes here: QUICK_TPU_BF16_SCALES=1 rounds the
        # scales through bf16, as the JAX package's __init__ (:136-146)
        self.params = cast_scales_env(params)
        self.cfg = cfg
        self.qcfg = qcfg

    @property
    def device(self) -> torch.device:
        return self.params.embed.device

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_dir: str, dtype: torch.dtype = torch.bfloat16,
                        device: DeviceLike = None) -> "AutoQuickModel":
        """Import an HF float checkpoint of the llama schema (dense or MoE)
        or of DeepSeek-V2 / V3."""
        from quick_tpu_torch.utils.checkpoint import load_hf_float

        device = resolve_device(device)  # refuse before reading anything
        params, cfg = load_hf_float(model_dir, dtype, device=device)
        check_and_get_model_type(cfg.model_type, allow_fallback=True)
        return cls(params, cfg)

    @classmethod
    def from_quantized(cls, model_dir: str, device: DeviceLike = None) -> "AutoQuickModel":
        """Load a quantized checkpoint, native QTPU or AutoAWQ (GEMM, GEMV
        or exllama layout, converted to QTPU)."""
        from quick_tpu_torch.utils.checkpoint import load_autoawq, load_quantized

        device = resolve_device(device)  # refuse before reading anything
        qcfg = QuantConfig.from_pretrained(model_dir)
        if qcfg.version.lower() in AUTOAWQ_VERSIONS:
            params, cfg, qcfg = load_autoawq(model_dir, device=device)
            qcfg = dataclasses.replace(qcfg, version="qtpu")
        else:
            params, cfg, qcfg = load_quantized(model_dir, device=device)
        check_and_get_model_type(cfg.model_type, allow_fallback=True)
        return cls(params, cfg, qcfg)

    @classmethod
    def from_gguf(cls, path: str, device: DeviceLike = None) -> "AutoQuickModel":
        """Load a llama.cpp GGUF file (``from_gguf`` :207). Q4_0 / Q4_1 /
        Q4_K tensors import bit-exactly onto the (scales, zeros_x_scales)
        contract at group size 32, which the card runs on K9; other quant
        types re-quantize to int4 g=32 (``utils/gguf.py``)."""
        from quick_tpu_torch.utils.gguf import load_gguf

        device = resolve_device(device)  # refuse before reading anything
        params, cfg, qcfg = load_gguf(path, device=device)
        check_and_get_model_type(cfg.model_type)
        m = cls(params, cfg, qcfg)
        m.gguf_path = path  # the file a tokenizer would load (ROADMAP A14)
        return m

    @classmethod
    def from_random(cls, cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                    dtype: torch.dtype = torch.bfloat16) -> "AutoQuickModel":
        """Random-init float model (hermetic testing). For an
        already-quantized random model, construct from
        ``models.init_quant_params``."""
        from quick_tpu_torch.models.model import init_float_params

        cfg = apply_model_type(cfg)
        return cls(init_float_params(cfg, seed, dtype, device=device), cfg)

    # -- pipeline ------------------------------------------------------------
    def quantize(self, calib_tokens=None, quant_config: Optional[QuantConfig] = None,
                 use_awq_search: bool = True, verbose: bool = True) -> "AutoQuickModel":
        """AWQ scale / clip search + quantize + pack (reference
        base.py:91-121) on the weights' device, block by block. With
        ``use_awq_search=False`` or no calibration tokens: RTN."""
        from quick_tpu_torch.models.model import quantize_params
        from quick_tpu_torch.quantize.awq import awq_quantize_model

        qcfg = quant_config or QuantConfig()
        if use_awq_search and calib_tokens is not None:
            self.params = awq_quantize_model(self.params, self.cfg, calib_tokens, qcfg,
                                             verbose=verbose)
        else:
            self.params = quantize_params(self.params, self.cfg, qcfg.q_group_size,
                                          qcfg.zero_point,
                                          modules_to_not_convert=qcfg.modules_to_not_convert)
        self.qcfg = qcfg
        return self

    def save_quantized(self, save_dir: str, awq_format: bool = False) -> None:
        """Persist the quantized model: the native QTPU checkpoint, or with
        ``awq_format=True`` an AutoAWQ-GEMM one (loadable by AutoAWQ / vLLM
        and by ``from_quantized``)."""
        from quick_tpu_torch.utils.checkpoint import export_autoawq, save_quantized

        if self.qcfg is None:
            raise ValueError("model is not quantized; call .quantize() first")
        if awq_format:
            export_autoawq(self.params, self.cfg, self.qcfg, save_dir)
        else:
            save_quantized(self.params, self.cfg, self.qcfg, save_dir)

    # -- inference -----------------------------------------------------------
    def generate(self, tokens, max_new_tokens: int = 128, **kw) -> torch.Tensor:
        from quick_tpu_torch.runtime.generate import generate

        return generate(self.params, self.cfg, tokens, max_new_tokens, **kw)

    @torch.inference_mode()
    def forward(self, tokens, cache=None):
        from quick_tpu_torch.models.model import model_forward

        return model_forward(self.params, self.cfg, tokens.to(self.device), cache)
