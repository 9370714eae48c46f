"""Port parity for the task harnesses of ``quick_tpu_torch/evaluation``: WER
(``wer.py``), HumanEval (``humaneval.py``) and MMLU (``mmlu.py``), each
against its ``quick_tpu`` counterpart on the same inputs: hand-built rows
and problems, and a deterministic tokenizer (UTF-8 bytes modulo the
vocabulary). Nothing is loaded from a dataset.

The MMLU scorer's JAX side runs eagerly (``jax.disable_jit``): its jitted
forward rounds as XLA-CPU fuses it, which moves with the host (ROADMAP C,
known divergences)."""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import quick_tpu.evaluation as jeval
import quick_tpu_torch.evaluation as teval
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params as jax_init_quant
from quick_tpu.utils.checkpoint import params_to_flat
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.evaluation import mmlu as tmmlu
from quick_tpu_torch.models.convert import params_from_flat

TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
#: per-token mean logprob of a choice, port against eager JAX
SCORE_TOL = 1e-3


def _tokenize(text: str):
    return [b % TINY["vocab_size"] for b in text.encode("utf-8")]


# ------------------------------------------------------------ WER

PAIRS = [
    ("the cat sat on the mat", "the cat sat on mat"),
    ("Hello, World!", "hello world"),
    ("a b c d", "a x c d e"),
    ("", "extra words here"),
    ("it's  a   test.", "its a test"),
]


@pytest.mark.parametrize("case", ["corpus", "each", "custom_normalize"])
def test_word_error_rate_equals_jax(case):
    refs, hyps = [p[0] for p in PAIRS], [p[1] for p in PAIRS]
    if case == "corpus":
        assert teval.word_error_rate(refs, hyps) == jeval.word_error_rate(refs, hyps)
    elif case == "each":
        for r, h in PAIRS:
            assert teval.word_error_rate([r], [h]) == jeval.word_error_rate([r], [h])
    else:
        split = str.split
        assert (teval.word_error_rate(refs, hyps, normalize=split)
                == jeval.word_error_rate(refs, hyps, normalize=split))
    with pytest.raises(ValueError, match="align"):
        teval.word_error_rate(refs, hyps[:-1])


def test_eval_librispeech_equals_jax():
    """The driver over rows a caller passes, with a transcribe_fn of the
    caller's (Whisper is not ported): the same scores."""
    rng = np.random.default_rng(0)
    rows = [{"audio": {"array": rng.standard_normal(160).astype(np.float32),
                       "sampling_rate": 16000}, "text": r} for r, _ in PAIRS]
    hyps = {r: h for r, h in PAIRS}

    def transcribe(wave, sr):
        assert sr == 16000 and wave.shape == (160,)
        return hyps[next(row["text"] for row in rows if row["audio"]["array"] is wave)]

    for n in (None, 3):
        assert (teval.eval_librispeech(transcribe, rows, max_samples=n)
                == jeval.eval_librispeech(transcribe, rows, max_samples=n))


# ------------------------------------------------------------ HumanEval

PROBLEM = {
    "task_id": "t/0",
    "prompt": "def add(a, b):\n",
    "test": "def check(f):\n    assert f(2, 3) == 5\n    assert f(-1, 1) == 0\n",
    "entry_point": "add",
}
COMPLETIONS = {
    "passing": "    return a + b\n",
    "failing": "    return a - b\n",
    "timing_out": "    while True:\n        pass\n",
}


@pytest.mark.parametrize("case", list(COMPLETIONS))
def test_check_correctness_equals_jax(case):
    """The same ``passed`` (and result kind) on a passing, a failing and a
    timing-out completion, each run in its own subprocess."""
    args = (PROBLEM["prompt"], COMPLETIONS[case], PROBLEM["test"], PROBLEM["entry_point"])
    out = teval.check_correctness(*args, timeout=1.0)
    ref = jeval.check_correctness(*args, timeout=1.0)
    assert out["passed"] == ref["passed"] == (case == "passing")
    assert out["result"].split(":")[0] == ref["result"].split(":")[0]


@pytest.mark.parametrize("n,c,k", [(5, 0, 1), (5, 2, 1), (5, 2, 3), (10, 9, 5), (3, 3, 2),
                                   ([4, 6, 8], [1, 0, 8], 2)])
def test_estimate_pass_at_k_equals_jax(n, c, k):
    c = c if isinstance(c, list) else [c]
    out, ref = teval.estimate_pass_at_k(n, c, k), jeval.estimate_pass_at_k(n, c, k)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


def test_eval_humaneval_equals_jax(tmp_path):
    """Two problems, three completions each (one timing out): the same
    pass@1 / pass@2 in both packages, and the results file written."""
    probs = [PROBLEM, dict(PROBLEM, task_id="t/1", prompt="def sub(a, b):\n",
                           test="def check(f):\n    assert f(5, 3) == 2\n", entry_point="sub")]
    comps = {PROBLEM["prompt"]: ["    return a + b\n", "    return b + a\n", "    return 0\n"],
             probs[1]["prompt"]: ["    return a - b\n", "    return b - a\n",
                                  "    while True:\n        pass\n"]}

    def gen(prompt):
        return comps[prompt]

    out = teval.eval_humaneval(gen, probs, ks=(1, 2, 5), timeout=1.0,
                               out_path=str(tmp_path / "r.json"))
    ref = jeval.eval_humaneval(gen, probs, ks=(1, 2, 5), timeout=1.0)
    assert out == ref and set(out) == {"pass@1", "pass@2"}
    assert (tmp_path / "r.json").exists()


# ------------------------------------------------------------ MMLU

ROWS = [
    {"question": "What is two plus two?", "choices": ["three", "four", "five", "twenty-two"],
     "answer": 1},
    {"question": "Which planet is known as the red planet?",
     "choices": ["Venus", "Mars", "Jupiter", "Saturn"], "answer": 1},
    {"question": "The chemical symbol for gold is?", "choices": ["Ag", "Au", "Gd", "Go"],
     "answer": 0},
]


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = jax_init_quant(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_flat(params_to_flat(jparams), tcfg, device="cpu")


def test_prompt_format_equals_jax():
    for row in ROWS:
        assert tmmlu.format_example(row) == jeval.mmlu.format_example(row)
        assert (tmmlu.build_prompt(row, ROWS[:2], "high_school_physics")
                == jeval.mmlu.build_prompt(row, ROWS[:2], "high_school_physics"))
    assert tmmlu._bucket(65) == 128 and tmmlu._bucket(64) == 64


@pytest.mark.parametrize("shots", [0, 2], ids=["zero_shot", "two_shot"])
def test_score_choices_match_eager_jax(tiny, shots):
    """Per-choice scores of a tiny llama within SCORE_TOL of quick_tpu's
    (its scorer eager), over the 64- and 128-token buckets the zero- and
    two-shot prompts take."""
    jcfg, jparams, tcfg, tparams = tiny
    for row in ROWS:
        prompt = tmmlu.build_prompt(row, ROWS[:shots], "misc")
        out = teval.score_choices(tparams, tcfg, _tokenize, prompt, row["choices"])
        with jax.disable_jit():
            ref = jeval.score_choices(jparams, jcfg, _tokenize, prompt, row["choices"])
        assert out.shape == (4,)
        np.testing.assert_allclose(out, ref, rtol=0, atol=SCORE_TOL)


def test_eval_mmlu_matches_eager_jax(tiny):
    """eval_mmlu with two shots: the same accuracy as quick_tpu's, and each
    row's argmax equal wherever its two best scores are more than
    SCORE_TOL apart."""
    jcfg, jparams, tcfg, tparams = tiny
    out = teval.eval_mmlu(tparams, tcfg, _tokenize, ROWS[1:], n_shot=1, dev_rows=ROWS[:1],
                          subject="misc")
    with jax.disable_jit():
        ref = jeval.eval_mmlu(jparams, jcfg, _tokenize, ROWS[1:], n_shot=1, dev_rows=ROWS[:1],
                              subject="misc")
    assert out == ref and out["n"] == 2


def test_continuation_logprob_keeps_the_window():
    """The scorer sums exactly the continuation's tokens: a row of one
    token more than its prompt scores that token's logprob alone."""
    cfg = ModelConfig(**TINY)
    from quick_tpu_torch.models.model import init_quant_params, model_forward

    p = init_quant_params(cfg, seed=1, device="cpu")
    toks = torch.tensor([[3, 7, 11, 13] + [0] * 60])
    lp = float(tmmlu._continuation_logprob(p, cfg, toks, 3, 4))
    logits, _ = model_forward(p, cfg, toks)
    want = float(torch.log_softmax(logits[0, 2].to(torch.float32), -1)[13])
    assert lp == pytest.approx(want, abs=1e-6)


# ------------------------------------------------------------ imports

def test_humaneval_and_wer_import_without_jax():
    """``quick_tpu_torch.evaluation.humaneval`` and ``.wer`` (with the
    package they sit in) import neither jax nor quick_tpu."""
    code = ("import sys, quick_tpu_torch.evaluation.humaneval, quick_tpu_torch.evaluation.wer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'quick_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, timeout=120)
