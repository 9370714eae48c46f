"""MMLU by length-normalized multiple-choice loglikelihood (port of
``quick_tpu/evaluation/mmlu.py``; reference quick/awq/evaluation/
eval_utils.py:115-155, which shells out to lm_eval). Each (question,
choice) pair is scored by the mean next-token logprob of the choice
continuation given the few-shot context, and the argmax choice is compared
with the answer: lm_eval's ``hendrycksTest`` rule.

Tokenization is caller-provided (a callable str -> list[int]) and rows are
plain dicts. Each scoring forward is one ``model_forward`` without a cache
on the params' device (on the card: K1 / K9, K2 by ``_use_flash``'s gate or
the einsum path, K13)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.models.model import ModelParams, model_forward

CHOICE_LETTERS = ("A", "B", "C", "D")


def format_example(row: Dict, include_answer: bool = True) -> str:
    """hendrycksTest prompt format."""
    s = row["question"].strip()
    for letter, choice in zip(CHOICE_LETTERS, row["choices"]):
        s += f"\n{letter}. {choice}"
    s += "\nAnswer:"
    if include_answer:
        s += f" {CHOICE_LETTERS[int(row['answer'])]}\n\n"
    return s


def build_prompt(row: Dict, shots: Sequence[Dict] = (),
                 subject: Optional[str] = None) -> str:
    head = ""
    if subject:
        head = (
            "The following are multiple choice questions (with answers) "
            f"about {subject.replace('_', ' ')}.\n\n"
        )
    return head + "".join(format_example(s) for s in shots) + format_example(
        row, include_answer=False
    )


def _continuation_logprob(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor,
                          cont_start: int, total_len: int) -> torch.Tensor:
    """Sum logprob of tokens[cont_start:total_len] given the prefix, from a
    forward over the whole padded [1, S] row (log-softmax in f32)."""
    logits, _ = model_forward(params, cfg, tokens)
    logp = torch.log_softmax(logits[0, :-1].to(torch.float32), dim=-1)
    per_tok = torch.gather(logp, -1, tokens[0, 1:, None])[:, 0]
    idx = torch.arange(per_tok.shape[0], device=per_tok.device)
    keep = (idx >= cont_start - 1) & (idx < total_len - 1)
    return torch.where(keep, per_tok, torch.zeros_like(per_tok)).sum()


def _bucket(n: int, quantum: int = 64) -> int:
    return -(-n // quantum) * quantum


@torch.inference_mode()
def score_choices(
    params: ModelParams,
    cfg: ModelConfig,
    tokenize: Callable[[str], List[int]],
    prompt: str,
    choices: Sequence[str],
    max_len: int = 2048,
) -> np.ndarray:
    """Loglikelihood of each choice continuation given the prompt, per
    token. Rows are right-padded to 64-token buckets, as in the JAX
    package (whose jitted scorer compiles once a bucket): the padded
    forward is part of the result, since the bucket picks the attention
    route."""
    dev = params.embed.device
    scores = []
    ptoks = tokenize(prompt)
    for choice in choices:
        cont = tokenize(" " + choice.strip())
        full = (ptoks + cont)[-max_len:]
        cont_start = len(full) - len(cont)
        padded = full + [0] * (_bucket(len(full)) - len(full))
        toks = torch.tensor([padded], dtype=torch.long, device=dev)
        lp = float(_continuation_logprob(params, cfg, toks, max(cont_start, 1), len(full)))
        # length-normalize (mean per-token logprob): summed logprobs over
        # variable-length choice texts favor short choices (lm_eval's
        # acc_norm convention)
        scores.append(lp / max(len(full) - max(cont_start, 1), 1))
    return np.asarray(scores)


def eval_mmlu(
    params: ModelParams,
    cfg: ModelConfig,
    tokenize: Callable[[str], List[int]],
    rows: List[Dict],
    n_shot: int = 0,
    dev_rows: Optional[List[Dict]] = None,
    subject: Optional[str] = None,
    verbose: bool = False,
) -> Dict[str, float]:
    """Accuracy over rows = [{question, choices: [4], answer: 0..3}, ...]
    (reference eval_mmlu, eval_utils.py:115-155)."""
    shots = (dev_rows or [])[:n_shot]
    correct = 0
    for i, row in enumerate(rows):
        prompt = build_prompt(row, shots, subject)
        scores = score_choices(params, cfg, tokenize, prompt, row["choices"])
        if int(scores.argmax()) == int(row["answer"]):
            correct += 1
        if verbose and (i + 1) % 25 == 0:
            print(f"[mmlu] {i + 1}/{len(rows)} acc={correct / (i + 1):.4f}")
    return {"accuracy": correct / max(len(rows), 1), "n": len(rows)}


def load_mmlu_rows(subject: str, split: str = "test") -> List[Dict]:
    """Load a local copy of cais/mmlu (no download)."""
    try:
        from datasets import load_dataset

        ds = load_dataset("cais/mmlu", subject, split=split)
        return [dict(r) for r in ds]
    except Exception as e:  # pragma: no cover - environment dependent
        raise RuntimeError(
            f"cais/mmlu not available locally; pass `rows` explicitly ({e})"
        )
