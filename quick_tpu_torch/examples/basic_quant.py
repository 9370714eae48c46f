"""Quantize a model (AWQ scale / clip search, or RTN) and save the packed
checkpoint; the port's counterpart of ``examples/basic_quant.py``:

    python -m quick_tpu_torch.examples.basic_quant --model_path <hf_dir> --quant_path out/
    python -m quick_tpu_torch.examples.basic_quant --random mistral-7b --n_calib_samples 32 --quant_path out/
    python -m quick_tpu_torch.examples.basic_quant --random debug --quant_path out/ --device cpu

The AWQ search calibrates on ``--calib_tokens`` (a .npy of token ids) or,
without them, on ``get_calib_tokens``' synthetic draw: ``--n_calib_samples``
blocks of ``--calib_block`` tokens; ``--no_awq_search`` packs RTN instead.
The float model must fit the device (on one 80 GB card: Mistral-7B,
DeepSeek-V2-Lite, Qwen1.5-MoE; not Mixtral-8x7B's 93 GB).
``--random <preset>`` builds a random-init float model from seed 0 instead
of reading a checkpoint (``--q_group_size 32`` or ``64`` quantizes it for
the card's small-group kernel; the group defaults to 128, or to 64 where a
linear's input width is no multiple of 128, as DeepSeek-V2-Lite's 10944-wide
dense FFN; ``benchmark.py --random --group`` makes the
packed weights directly, for the presets whose float model is too large); ``--awq_format`` writes an AutoAWQ-GEMM checkpoint
instead of the native QTPU one.
Runs on the card unless given ``--device cpu``.
"""
import argparse

import numpy as np

from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.quantize.calib import get_calib_tokens

#: deepseek-ai/DeepSeek-V2-Lite config.json, the fields the port reads
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
    intermediate_size=10944, moe_intermediate_size=1408, num_hidden_layers=27,
    num_attention_heads=16, num_key_value_heads=16, n_shared_experts=2,
    n_routed_experts=64, num_experts_per_tok=6, routed_scaling_factor=1.0,
    kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, topk_method="greedy", n_group=1, topk_group=1,
    scoring_func="softmax", norm_topk_prob=False, first_k_dense_replace=1,
    moe_layer_freq=1, max_position_embeddings=163840, rope_theta=10000.0,
    rope_scaling=dict(type="yarn", factor=40, original_max_position_embeddings=4096,
                      beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707),
    rms_norm_eps=1e-6, tie_word_embeddings=False,
)

#: Qwen/Qwen3-8B config.json, the fields the port reads: per-head q / k
#: RMSNorm, head_dim 128, GQA 32 / 8, untied head; about 6.4 GB at W4A16 g=128
QWEN3_8B = dict(
    model_type="qwen3", vocab_size=151936, hidden_size=4096, intermediate_size=12288,
    num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    max_position_embeddings=40960, rope_theta=1000000, rms_norm_eps=1e-6,
    attention_bias=False, tie_word_embeddings=False, sliding_window=None,
    use_sliding_window=False,
)

#: Qwen/Qwen3-30B-A3B config.json: 128 experts of 768, top-8 with
#: norm_topk_prob, no shared expert, per-head q / k RMSNorm, GQA 32 / 4
QWEN3_30B_A3B = dict(
    model_type="qwen3_moe", vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    moe_intermediate_size=768, num_hidden_layers=48, num_attention_heads=32,
    num_key_value_heads=4, head_dim=128, num_experts=128, num_experts_per_tok=8,
    norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
    max_position_embeddings=40960, rope_theta=1000000.0, rms_norm_eps=1e-6,
    attention_bias=False, tie_word_embeddings=False, sliding_window=None,
    use_sliding_window=False,
)

#: google/gemma-2-9b config.json: GeGLU (tanh), sandwich norms, head_dim
#: 256 with query_pre_attn_scalar 256, a 4,096-token window on the even
#: layers, attention softcap 50 and final softcap 30, a tied head over 256,000
#: tokens; 8.32 G linear weights, about 6.5 GB at W4A16 g=128 with the bf16
#: embedding
GEMMA2_9B = dict(
    model_type="gemma2", vocab_size=256000, hidden_size=3584, intermediate_size=14336,
    num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8, head_dim=256,
    query_pre_attn_scalar=256, sliding_window=4096, attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
    max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
    attention_bias=False,
)

#: google/gemma-3-12b-pt config.json's text_config: gemma2's block plus
#: per-head q / k RMSNorm, no softcaps, a 1,024-token window on five layers of
#: six, global rope theta 1e6 with linear scaling x8, local theta 1e4;
#: about 8.1 GB at W4A16 g=128 with the bf16 embedding
GEMMA3_12B = dict(
    model_type="gemma3_text", vocab_size=262208, hidden_size=3840, intermediate_size=15360,
    num_hidden_layers=48, num_attention_heads=16, num_key_value_heads=8, head_dim=256,
    query_pre_attn_scalar=256, sliding_window=1024, sliding_window_pattern=6,
    rope_theta=1000000.0, rope_local_base_freq=10000.0,
    rope_scaling={"factor": 8.0, "rope_type": "linear"}, max_position_embeddings=131072,
    rms_norm_eps=1e-6, final_logit_softcapping=None, attn_logit_softcapping=None,
    hidden_activation="gelu_pytorch_tanh",
)

PRESETS = {
    "tinyllama": ModelConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
        max_position_embeddings=2048,
    ),
    "mistral-7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=4096, model_type="mistral",
    ),
    # mistralai/Mixtral-8x7B-v0.1 config.json; ~26.4 GB at W4A16 (random
    # packed weights: benchmark.py --random). Its float model is 93 GB.
    "mixtral-8x7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-5,
        num_local_experts=8, num_experts_per_tok=2, model_type="mixtral",
    ),
    # Qwen/Qwen1.5-MoE-A2.7B config.json (the published vocab, 151936)
    "qwen1.5-moe-a2.7b": ModelConfig(
        vocab_size=151936, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=8192, rope_theta=1e6, rms_norm_eps=1e-6,
        num_local_experts=60, num_experts_per_tok=4, moe_intermediate_size=1408,
        shared_intermediate_size=5632, model_type="qwen2_moe",
        moe_router="softmax_all", moe_freq_shifted=True, attention_bias=True,
        shared_expert_gate=True, n_shared_experts=1, norm_topk_prob=False,
    ),
    # deepseek-ai/DeepSeek-V2-Lite config.json: MLA (kv_lora_rank 512, no
    # q-LoRA, qk 128 + 64, v 128) and DeepSeekMoE (64 routed experts of 1408,
    # top-6, 2 shared, a dense first layer), yarn rope x40; 15.7 B float
    # parameters, about 10.5 GB at W4A16 g=64
    "deepseek-v2-lite": ModelConfig.from_hf_config(DEEPSEEK_V2_LITE),
    "qwen3-8b": ModelConfig.from_hf_config(QWEN3_8B),
    "qwen3-30b-a3b": ModelConfig.from_hf_config(QWEN3_30B_A3B),
    "gemma2-9b": ModelConfig.from_hf_config(GEMMA2_9B),
    "gemma3-12b": ModelConfig.from_hf_config(GEMMA3_12B),
    "debug": ModelConfig(
        vocab_size=1024, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256,
    ),
}


def default_group(cfg: ModelConfig) -> int:
    """128, or 64 where 128 does not divide a linear's input width (the
    dense FFN, the MoE experts' or the shared experts')."""
    widths = [cfg.hidden_size, cfg.intermediate_size, cfg.moe_intermediate_size or 0,
              cfg.shared_intermediate_size or 0]
    return 128 if all(w % 128 == 0 for w in widths) else 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", help="HF float checkpoint directory")
    ap.add_argument("--random", choices=sorted(PRESETS),
                    help="random-init preset instead of a checkpoint")
    ap.add_argument("--quant_path", required=True)
    ap.add_argument("--zero_point", type=int, default=1)
    ap.add_argument("--q_group_size", type=int, default=None,
                    help="quant group (default 128, or 64 where 128 does not divide a width)")
    ap.add_argument("--w_bit", type=int, default=4)
    ap.add_argument("--awq_format", action="store_true",
                    help="write an AutoAWQ-GEMM checkpoint instead of QTPU")
    ap.add_argument("--calib_tokens", help=".npy of pre-tokenized calibration data")
    ap.add_argument("--no_awq_search", action="store_true",
                    help="plain RTN instead of the AWQ scale / clip search")
    ap.add_argument("--n_calib_samples", type=int, default=32)
    ap.add_argument("--calib_block", type=int, default=512)
    ap.add_argument("--device", default=None, help="'cpu' for the plain path (default: the card)")
    args = ap.parse_args(argv)

    if args.random:
        model = AutoQuickModel.from_random(PRESETS[args.random], device=args.device)
    elif args.model_path:
        model = AutoQuickModel.from_pretrained(args.model_path, device=args.device)
    else:
        ap.error("need --model_path or --random")
    group = args.q_group_size or default_group(model.cfg)
    qcfg = QuantConfig(zero_point=bool(args.zero_point), q_group_size=group, w_bit=args.w_bit)
    calib = None
    if not args.no_awq_search:
        data = np.load(args.calib_tokens) if args.calib_tokens else None
        calib = get_calib_tokens(
            data, n_samples=args.n_calib_samples,
            block_size=min(args.calib_block, model.cfg.max_position_embeddings),
            vocab_size=model.cfg.vocab_size,
        )
    model.quantize(calib, qcfg, use_awq_search=not args.no_awq_search)
    model.save_quantized(args.quant_path, awq_format=args.awq_format)
    print(f"quantized model saved to {args.quant_path}")


if __name__ == "__main__":
    main()
