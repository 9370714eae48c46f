"""Scoring (port of the perplexity and KL parts of ``quick_tpu/evaluation``;
MMLU, HumanEval and WER are ROADMAP A13)."""
from quick_tpu_torch.evaluation.kl_divergence import KLReport, eval_kl_divergence
from quick_tpu_torch.evaluation.ppl import evaluate_perplexity

__all__ = ["evaluate_perplexity", "eval_kl_divergence", "KLReport"]
