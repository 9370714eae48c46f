"""KL divergence and top-k agreement between a reference and a test model
(port of ``quick_tpu/evaluation/kl_divergence.py``; reference
kl_divergence.py:38-124): per-position logit distributions of two models on
the same tokens, the mean KL and the top-1 / top-k agreement with
normal-approximation 95 % intervals. Both models run ``model_forward`` on
their params' device."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.models.model import ModelParams, model_forward
from quick_tpu_torch.modules.blocks import top_k


@dataclasses.dataclass
class KLReport:
    mean_kl: float
    kl_ci95: Tuple[float, float]
    top1_agreement: float
    top1_ci95: Tuple[float, float]
    topk_agreement: float  # the reference's top-1 within the test's top-k
    n_positions: int
    k: int

    def __str__(self):
        return (
            f"KL {self.mean_kl:.5f} [{self.kl_ci95[0]:.5f}, {self.kl_ci95[1]:.5f}] | "
            f"top-1 agree {self.top1_agreement:.3f} | "
            f"top-{self.k} contain {self.topk_agreement:.3f} | "
            f"n={self.n_positions}"
        )


def _kl_window(params_ref, cfg_ref, params_test, cfg_test, tokens, k: int):
    lr, _ = model_forward(params_ref, cfg_ref, tokens)
    lt, _ = model_forward(params_test, cfg_test, tokens.to(params_test.embed.device))
    pr = torch.log_softmax(lr.to(torch.float32), dim=-1)
    pt = torch.log_softmax(lt.to(torch.float32).to(pr.device), dim=-1)
    kl = torch.sum(torch.exp(pr) * (pr - pt), dim=-1).reshape(-1)  # [T]
    ref_top1 = torch.argmax(pr, dim=-1).reshape(-1)
    test_top1 = torch.argmax(pt, dim=-1).reshape(-1)
    top1 = (ref_top1 == test_top1).to(torch.float32)
    # lax.top_k's order: the lower index first among ties
    _, test_topk = top_k(pt.reshape(-1, pt.shape[-1]), k)
    topk = (test_topk == ref_top1[:, None]).any(dim=-1).to(torch.float32)
    return kl, top1, topk


@torch.inference_mode()
def eval_kl_divergence(
    params_ref: ModelParams,
    cfg_ref: ModelConfig,
    params_test: ModelParams,
    cfg_test: ModelConfig,
    tokens,
    seqlen: int = 512,
    k: int = 5,
) -> KLReport:
    """KL(ref || test) per position over windows of ``seqlen`` tokens
    (``eval_kl_divergence`` :56)."""
    flat = np.asarray(tokens, np.int64).reshape(-1)
    if len(flat) < 2:
        raise ValueError(f"need at least 2 tokens for a KL window, got {len(flat)}")
    n_win = max(len(flat) // seqlen, 1)
    seqlen = min(seqlen, len(flat))
    dev = params_ref.embed.device
    kls, top1s, topks = [], [], []
    for i in range(n_win):
        w = torch.from_numpy(flat[i * seqlen:(i + 1) * seqlen]).to(dev)[None]
        kl, t1, tk = _kl_window(params_ref, cfg_ref, params_test, cfg_test, w, k)
        kls.append(kl.cpu().numpy())
        top1s.append(t1.cpu().numpy())
        topks.append(tk.cpu().numpy())
    kl = np.concatenate(kls)
    top1 = np.concatenate(top1s)
    topk = np.concatenate(topks)
    n = len(kl)

    def ci(v):
        m = v.mean()
        half = 1.96 * v.std(ddof=1) / np.sqrt(n) if n > 1 else 0.0
        return float(m - half), float(m + half)

    return KLReport(
        mean_kl=float(kl.mean()), kl_ci95=ci(kl), top1_agreement=float(top1.mean()),
        top1_ci95=ci(top1), topk_agreement=float(topk.mean()), n_positions=n, k=k,
    )
