"""Word error rate (WER): port of ``quick_tpu/evaluation/wer.py`` (reference
eval_librispeech, quick/awq/evaluation/eval_utils.py:63-113). A
self-contained WER metric (edit distance over words, jiwer-compatible
normalization hooks) and a driver that scores a caller's ``transcribe_fn``
on LibriSpeech rows. Imports neither torch nor jax.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def _edit_distance(a: List[str], b: List[str]) -> int:
    """Levenshtein distance over token lists (two-row DP)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, wa in enumerate(a, 1):
        cur = [i]
        for j, wb in enumerate(b, 1):
            cur.append(
                min(
                    prev[j] + 1,          # deletion
                    cur[j - 1] + 1,       # insertion
                    prev[j - 1] + (wa != wb),  # substitution
                )
            )
        prev = cur
    return prev[-1]


def default_normalize(text: str) -> List[str]:
    """Lowercase, strip punctuation, split on whitespace."""
    keep = [c.lower() if c.isalnum() or c.isspace() else " " for c in text]
    return "".join(keep).split()


def word_error_rate(
    references: Sequence[str],
    hypotheses: Sequence[str],
    normalize: Callable[[str], List[str]] = default_normalize,
) -> Dict[str, float]:
    """Corpus WER = total edit distance / total reference words."""
    if len(references) != len(hypotheses):
        raise ValueError("references and hypotheses must align")
    errors, words = 0, 0
    for ref, hyp in zip(references, hypotheses):
        r, h = normalize(ref), normalize(hyp)
        errors += _edit_distance(r, h)
        words += len(r)
    return {
        "wer": errors / max(words, 1),
        "errors": float(errors),
        "words": float(words),
    }


def eval_librispeech(
    transcribe_fn: Callable[[np.ndarray, int], str],
    dataset_rows: Optional[List[Dict]] = None,
    max_samples: Optional[int] = None,
    verbose: bool = False,
) -> Dict[str, float]:
    """Score an ASR callable on LibriSpeech rows
    ({"audio": {"array", "sampling_rate"}, "text": ...}).

    transcribe_fn(waveform, sampling_rate) -> text. Rows default to a local
    copy of librispeech_asr (``load_librispeech_rows``)."""
    if dataset_rows is None:
        dataset_rows = load_librispeech_rows()
    if max_samples is not None:
        dataset_rows = dataset_rows[:max_samples]
    refs, hyps = [], []
    for i, row in enumerate(dataset_rows):
        refs.append(row["text"])
        hyps.append(
            transcribe_fn(
                row["audio"]["array"], row["audio"]["sampling_rate"]
            )
        )
        if verbose and (i + 1) % 50 == 0:
            print(f"[librispeech] {i + 1}/{len(dataset_rows)}")
    return word_error_rate(refs, hyps)


def load_librispeech_rows(split: str = "test") -> List[Dict]:
    """Load a local copy of librispeech_asr's clean split (no download)."""
    try:
        from datasets import load_dataset

        return list(load_dataset("librispeech_asr", "clean", split=split))
    except Exception as e:  # pragma: no cover - environment dependent
        raise RuntimeError(
            f"librispeech_asr not available locally; pass rows ({e})"
        )
