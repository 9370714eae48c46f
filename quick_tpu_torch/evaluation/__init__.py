"""Scoring (port of ``quick_tpu/evaluation``): perplexity, KL divergence,
MMLU, HumanEval and WER."""
from quick_tpu_torch.evaluation.humaneval import (
    check_correctness,
    estimate_pass_at_k,
    eval_humaneval,
)
from quick_tpu_torch.evaluation.kl_divergence import KLReport, eval_kl_divergence
from quick_tpu_torch.evaluation.mmlu import eval_mmlu, score_choices
from quick_tpu_torch.evaluation.ppl import evaluate_perplexity
from quick_tpu_torch.evaluation.wer import eval_librispeech, word_error_rate

__all__ = [
    "evaluate_perplexity",
    "eval_kl_divergence",
    "KLReport",
    "eval_humaneval",
    "check_correctness",
    "estimate_pass_at_k",
    "eval_mmlu",
    "score_choices",
    "eval_librispeech",
    "word_error_rate",
]
