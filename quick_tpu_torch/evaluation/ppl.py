"""Perplexity (port of ``quick_tpu/evaluation/ppl.py``; reference
eval_utils.py:21-61): exp of the mean next-token NLL over non-overlapping
windows of a pre-tokenized stream, each window one ``model_forward`` on
the params' device (on the card: K1 / K9, K2 and K13, K8 for MoE)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.models.model import ModelParams, model_forward


def _window_nll(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor,
                skip_rows: int = 0):
    """Sum of next-token NLLs and their count for one [B, S] window chunk,
    rows below ``skip_rows`` (already scored: the tail overlap) masked out.
    Both stay on the device."""
    logits, _ = model_forward(params, cfg, tokens)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    live = (torch.arange(nll.shape[0], device=nll.device) >= skip_rows).to(nll.dtype)[:, None]
    return (nll * live).sum(), (live * torch.ones_like(nll)).sum()


@torch.inference_mode()
def evaluate_perplexity(
    params: ModelParams,
    cfg: ModelConfig,
    tokens,                        # flat token stream [N] or [B, S]
    seqlen: int = 2048,
    max_windows: Optional[int] = None,
    verbose: bool = False,
    batch: int = 1,                # windows scored per forward
) -> float:
    """exp(mean NLL) over non-overlapping ``seqlen`` windows (reference
    eval_utils.py:38-57). ``batch`` > 1 scores several windows a forward;
    the last chunk slides back to keep the [batch, seqlen] shape and masks
    the windows it scores again (``evaluate_perplexity`` :35)."""
    flat = np.asarray(tokens, np.int64).reshape(-1)
    n_win = len(flat) // seqlen
    if max_windows is not None:
        n_win = min(n_win, max_windows)
    if n_win == 0:
        raise ValueError(f"need at least {seqlen} tokens, got {len(flat)}")
    dev = params.embed.device
    total, count = 0.0, 0
    for i in range(0, n_win, batch):
        nb = min(batch, n_win - i)
        lo = i
        if nb < batch and n_win >= batch:
            lo, nb = n_win - batch, batch
        w = torch.from_numpy(flat[lo * seqlen:(lo + nb) * seqlen].reshape(nb, seqlen)).to(dev)
        s, c = _window_nll(params, cfg, w, skip_rows=max(i - lo, 0))
        total += float(s)
        count += int(c)
        if verbose:
            print(f"[ppl] window {min(lo + nb, n_win)}/{n_win}: {np.exp(total / count):.4f}",
                  flush=True)
    return float(np.exp(total / count))
