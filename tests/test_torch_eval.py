"""Port parity for the scoring functions ``evaluate_perplexity`` and
``eval_kl_divergence`` (``quick_tpu_torch/evaluation``) against
``quick_tpu.evaluation`` on the CPU: a tiny llama, float and RTN-packed,
the JAX weights carried over by name, the same token stream."""
import jax
import numpy as np
import pytest
import torch

import quick_tpu.utils.checkpoint as jck
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.evaluation import eval_kl_divergence as jax_kl, evaluate_perplexity as jax_ppl
from quick_tpu.evaluation.kl_divergence import _kl_window as jax_klw
from quick_tpu.models import init_float_params as jax_init_float
from quick_tpu.models.model import quantize_params as jax_quantize
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.evaluation import KLReport, eval_kl_divergence, evaluate_perplexity
from quick_tpu_torch.evaluation.kl_divergence import _kl_window as port_klw
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.models.model import model_forward

TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
SEQ = 32
#: mean NLL over hundreds of tokens: the logits of the two packages agree
#: within a bf16 step (tests/test_torch_model.py), which averages out to a
#: few 1e-4 of the perplexity
PPL_RTOL = 2e-3
#: mean KL of two close models: a difference of bf16 logit steps in either
#: model moves it by a few %
KL_RTOL = 5e-2
#: the agreement shares count positions: a position may count otherwise
#: only where the logits that decide it lie within TIE of each other (the
#: packages' logits differ by bf16 steps)
TIE = 1.0 / 32


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, float, RTN) and the port's copies."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jf = jax_init_float(jcfg, jax.random.PRNGKey(0))
    jq = jax_quantize(jf, jcfg, group_size=32)
    port = [params_from_flat(jck.params_to_flat(p), tcfg, device="cpu", group_size=32)
            for p in (jf, jq)]
    return jcfg, (jf, jq), tcfg, port


def _stream(n, seed=3):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], n).astype(np.int32)


@pytest.mark.parametrize("batch,max_windows", [(1, None), (3, None), (2, 3)])
def test_perplexity_matches_jax(models, batch, max_windows):
    """Five windows of 32 (and a 7-token tail, dropped): one window a
    forward; three a forward, the last chunk sliding back over two scored
    windows whose rows are masked; max_windows cutting to three with
    batch 2 (the tail slide again)."""
    jcfg, (_, jq), tcfg, (_, tq) = models
    toks = _stream(5 * SEQ + 7)
    ref = jax_ppl(jq, jcfg, toks, seqlen=SEQ, batch=batch, max_windows=max_windows)
    out = evaluate_perplexity(tq, tcfg, toks, seqlen=SEQ, batch=batch, max_windows=max_windows)
    assert np.isfinite(out) and abs(out - ref) <= PPL_RTOL * ref, (out, ref)
    if batch > 1:  # the slide masks the windows it scores twice
        one = evaluate_perplexity(tq, tcfg, toks, seqlen=SEQ, batch=1, max_windows=max_windows)
        assert abs(out - one) <= PPL_RTOL * one, (out, one)


def test_perplexity_refuses_short_streams(models):
    _, _, tcfg, (_, tq) = models
    with pytest.raises(ValueError, match="at least"):
        evaluate_perplexity(tq, tcfg, _stream(SEQ - 1), seqlen=SEQ)


def _gap(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Per position, the gap between the k-th and (k+1)-th best logit."""
    v = torch.sort(logits, dim=-1, descending=True).values
    return v[..., k - 1] - v[..., k]


@pytest.mark.parametrize("n", [3 * SEQ + 5, SEQ // 2])
def test_kl_divergence_matches_jax(models, n):
    """Float against RTN over three windows (and a dropped tail), and over
    a stream shorter than one window (scored whole): the mean KL within
    KL_RTOL, the same positions; per position, the top-1 agreement and the
    top-5 containment equal, except where a model's deciding logits (its
    best two; the test model's 5th and 6th) lie within TIE."""
    jcfg, (jf, jq), tcfg, (tf, tq) = models
    toks = _stream(n, seed=4)
    ref = jax_kl(jf, jcfg, jq, jcfg, toks, seqlen=SEQ, k=5)
    out = eval_kl_divergence(tf, tcfg, tq, tcfg, toks, seqlen=SEQ, k=5)
    assert isinstance(out, KLReport) and out.n_positions == ref.n_positions and out.k == 5
    assert out.mean_kl > 0 and abs(out.mean_kl - ref.mean_kl) <= KL_RTOL * ref.mean_kl
    assert out.kl_ci95[0] <= out.mean_kl <= out.kl_ci95[1] and "KL" in str(out)
    seqlen = min(SEQ, n)
    for i in range(max(n // SEQ, 1)):
        w = toks[i * seqlen:(i + 1) * seqlen][None]
        _, jt1, jtk = (np.asarray(a) for a in jax_klw(jf, jcfg, jq, jcfg, w, 5))
        wt = torch.from_numpy(w.astype(np.int64))
        _, tt1, ttk = (a.numpy() for a in port_klw(tf, tcfg, tq, tcfg, wt, 5))
        with torch.inference_mode():
            lr, lt = (model_forward(p, tcfg, wt)[0][0] for p in (tf, tq))
        tie1 = ((_gap(lr, 1) < TIE) | (_gap(lt, 1) < TIE)).numpy()
        tiek = ((_gap(lr, 1) < TIE) | (_gap(lt, 5) < TIE)).numpy()
        assert np.all((jt1 == tt1) | tie1) and np.all((jtk == ttk) | tiek)


def test_kl_of_a_model_with_itself(models):
    """KL 0 and full agreement, top-k with the lower index first among ties
    (``modules/blocks.py::top_k``)."""
    _, _, tcfg, (tf, _) = models
    rep = eval_kl_divergence(tf, tcfg, tf, tcfg, _stream(2 * SEQ, seed=5), seqlen=SEQ)
    assert rep.mean_kl == 0.0 and rep.top1_agreement == 1.0 and rep.topk_agreement == 1.0
    with pytest.raises(ValueError, match="at least 2"):
        eval_kl_divergence(tf, tcfg, tf, tcfg, _stream(1), seqlen=SEQ)
