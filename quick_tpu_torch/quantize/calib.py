"""Calibration data loading (port of ``quick_tpu/quantize/calib.py``; pure
numpy, the same values on every branch).

The reference pulls ``mit-han-lab/pile-val-backup`` and slices 512-token
blocks. Without network access the loader accepts, in priority order,
pre-tokenized arrays, lists of strings with a tokenizer, a local HF dataset
path, and finally a deterministic synthetic draw, so the pipeline always
runs hermetically.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


def get_calib_tokens(
    data: Union[None, np.ndarray, Sequence[str]] = None,
    tokenizer=None,
    n_samples: int = 128,
    block_size: int = 512,
    vocab_size: int = 32000,
    dataset_path: Optional[str] = None,
    text_column: str = "text",
    seed: int = 0,
) -> np.ndarray:
    """Return calibration tokens [n_blocks, block_size] int32.

    - ``data`` as an int array (or tensor): re-blocked to shape.
    - ``data`` as strings + ``tokenizer``: tokenized, concatenated, then
      split into blocks (reference calib_data.py:23-52).
    - ``dataset_path``: a local HF dataset (``datasets.load_from_disk``,
      imported only on this branch).
    - otherwise: synthetic zipf-distributed tokens from ``seed``.
    """
    if data is not None and not isinstance(data, (list, tuple)):
        arr = np.asarray(data, dtype=np.int32)
        flat = arr.reshape(-1)
        n_blocks = min(n_samples, len(flat) // block_size)
        if n_blocks == 0:
            raise ValueError(f"need at least {block_size} tokens, got {len(flat)}")
        return flat[: n_blocks * block_size].reshape(n_blocks, block_size)

    texts: Optional[List[str]] = None
    if isinstance(data, (list, tuple)):
        texts = list(data)
    elif dataset_path is not None:
        import datasets

        ds = datasets.load_from_disk(dataset_path)
        texts = [r[text_column] for r in ds.select(range(min(len(ds), 2 * n_samples)))]

    if texts is not None:
        if tokenizer is None:
            raise ValueError("tokenizer required for string calibration data")
        ids: List[int] = []
        for t in texts:
            ids.extend(tokenizer.encode(t))
            if len(ids) >= n_samples * block_size:
                break
        return get_calib_tokens(np.asarray(ids, np.int32), n_samples=n_samples,
                                block_size=block_size)

    # synthetic fallback: zipfian token draw (roughly language-like ranks)
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.3, size=(n_samples, block_size))
    return (ranks % vocab_size).astype(np.int32)
