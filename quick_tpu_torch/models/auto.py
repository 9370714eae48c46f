"""High-level model API (port of ``quick_tpu/models/auto.py``, llama path
with dense or MoE MLPs: llama, mistral, mixtral, qwen2_moe; and DeepSeek-V2
/ V3, MLA with DeepSeekMoE):

    model = AutoQuickModel.from_pretrained(hf_dir)             # float import
    model.quantize(quant_config=QuantConfig())                 # RTN + pack
    model.save_quantized(out_dir)                              # native QTPU
    model.save_quantized(awq_dir, awq_format=True)             # AutoAWQ GEMM
    model = AutoQuickModel.from_quantized(out_dir)             # QTPU or AutoAWQ
    model = AutoQuickModel.from_gguf(path)                     # llama.cpp, g=32
    out = model.generate(tokens, max_new_tokens=64)

Every constructor puts the weights on the card unless given
``device="cpu"``. Not ported: the AWQ scale / clip search (ROADMAP A9), the
tokenizer and ``generate_text`` (``transformers`` is not a dependency of
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

#: the ported part of quick_tpu's MODEL_TYPE_MAP (:30-88): the llama
#: architecture types, mixtral (MoE through ``num_local_experts``),
#: qwen2_moe and deepseek_v2 / v3 with their config switch overrides.
MODEL_TYPE_MAP: Dict[str, dict] = {
    "llama": {},
    "mistral": {},
    "vicuna": {},
    "yi": {},
    "aquila": {},
    "mixtral": {},
    "qwen2_moe": {
        "moe_router": "softmax_all", "moe_freq_shifted": True,
        "attention_bias": True, "shared_expert_gate": True,
        "n_shared_experts": 1, "norm_topk_prob": False,
    },
    "deepseek_v2": {"moe_router": "deepseek"},
    "deepseek_v3": {"moe_router": "deepseek", "scoring_func": "sigmoid"},
}

#: QuantConfig versions that name an AutoAWQ layout (converted at load)
AUTOAWQ_VERSIONS = ("gemm", "gemv", "exllama", "exllamav2")


def check_and_get_model_type(model_type: str) -> str:
    """Check a loaded model's type against the registry
    (``check_and_get_model_type`` :92, as its loaders call it): an unmapped
    type (a native checkpoint whose config passes ``check_supported``) runs
    with a warning; the HF and AutoAWQ importers refuse such types before
    this is asked."""
    if model_type not in MODEL_TYPE_MAP:
        warnings.warn(
            f"model_type '{model_type}' is not in the registry; it runs with "
            "llama-family semantics. Verify outputs against the source model.",
            stacklevel=2,
        )
    return model_type


def apply_model_type(cfg: ModelConfig) -> ModelConfig:
    if cfg.model_type not in MODEL_TYPE_MAP:
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet; supported: "
            f"{sorted(MODEL_TYPE_MAP)}"
        )
    overrides = MODEL_TYPE_MAP[cfg.model_type]
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
        check_and_get_model_type(cfg.model_type)
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
        check_and_get_model_type(cfg.model_type)
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
    def from_random(cls, cfg: ModelConfig, seed: int = 0,
                    device: DeviceLike = None) -> "AutoQuickModel":
        """Random-init float model (hermetic testing). For an
        already-quantized random model, construct from
        ``models.init_quant_params``."""
        from quick_tpu_torch.models.model import init_float_params

        cfg = apply_model_type(cfg)
        return cls(init_float_params(cfg, seed, device=device), cfg)

    # -- pipeline ------------------------------------------------------------
    def quantize(self, calib_tokens=None, quant_config: Optional[QuantConfig] = None,
                 use_awq_search: bool = True) -> "AutoQuickModel":
        """Quantize + pack the block linears (RTN). The AWQ scale / clip
        search (with calibration tokens and ``use_awq_search``) is not
        ported yet."""
        from quick_tpu_torch.models.model import quantize_params

        if use_awq_search and calib_tokens is not None:
            raise NotImplementedError(
                "the AWQ scale / clip search is not ported yet (ROADMAP A9); "
                "pass use_awq_search=False for RTN"
            )
        qcfg = quant_config or QuantConfig()
        self.params = quantize_params(self.params, self.cfg, qcfg.q_group_size, qcfg.zero_point,
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
