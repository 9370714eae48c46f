"""HumanEval harness: sandboxed execution and unbiased pass@k (port of
``quick_tpu/evaluation/humaneval.py``; reference
quick/awq/evaluation/humaneval_utils.py:34-463). Each candidate runs in a
fresh subprocess with an rlimit'd address space and CPU time and a hard
wall-clock timeout that kills its whole process group.

Pass problems explicitly (dicts with prompt / test / entry_point) or load
a local copy of openai_humaneval. Imports neither torch nor jax.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

_RUNNER = r"""
import resource, sys
resource.setrlimit(resource.RLIMIT_AS, ({mem}, {mem}))
resource.setrlimit(resource.RLIMIT_CPU, ({cpu}, {cpu}))
import builtins
builtins.exit = None
builtins.quit = None
# candidate + test harness
{program}
"""


def check_correctness(
    prompt: str,
    completion: str,
    test: str,
    entry_point: str,
    timeout: float = 6.0,
    mem_bytes: int = 1 << 31,
) -> Dict[str, Union[bool, str]]:
    """Run one candidate against its unit tests in an isolated subprocess.

    Returns {"passed": bool, "result": str}. (Reference check_correctness,
    humaneval_utils.py:112-180, but with OS-level process isolation.)
    """
    import secrets

    nonce = secrets.token_hex(16)
    # prompt + completion concatenate DIRECTLY (the OpenAI/reference
    # protocol, humaneval_utils.py:137-143): an inserted newline splits a
    # continuation of the prompt's final line and fails correct candidates
    program = prompt + completion + "\n".join(
        [
            "",
            test,
            "",
            f"check({entry_point})",
            f"print('__QUICK_TPU_PASS_{{}}__'.format({nonce!r}))",
        ]
    )
    src = _RUNNER.format(
        mem=mem_bytes, cpu=int(timeout) + 1, program=program
    )
    with tempfile.NamedTemporaryFile(
        "w", suffix=".py", delete=False
    ) as f:
        f.write(src)
        path = f.name
    try:
        # own session => the timeout kills the whole PROCESS GROUP, so
        # candidate-spawned children don't outlive the evaluation
        proc = subprocess.Popen(
            [sys.executable, path],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env={"PATH": os.environ.get("PATH", ""), "HOME": tempfile.gettempdir()},
            cwd=tempfile.gettempdir(),
            start_new_session=True,
        )
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            import signal

            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()
            raise
        # the per-run nonce keeps candidate prints from spoofing the
        # pass sentinel
        if f"__QUICK_TPU_PASS_{nonce}__" in stdout:
            return {"passed": True, "result": "passed"}
        proc_stderr = stderr
        err = (proc_stderr or "").strip().splitlines()
        return {
            "passed": False,
            "result": f"failed: {err[-1] if err else 'no output'}",
        }
    except subprocess.TimeoutExpired:
        return {"passed": False, "result": "timed out"}
    finally:
        os.unlink(path)


def estimate_pass_at_k(
    num_samples: Union[int, Sequence[int], np.ndarray],
    num_correct: Union[Sequence[int], np.ndarray],
    k: int,
) -> np.ndarray:
    """Unbiased pass@k estimator: 1 - C(n-c, k)/C(n, k) per problem
    (reference humaneval_utils.py:268-293)."""

    def one(n: int, c: int) -> float:
        if n - c < k:
            return 1.0
        return 1.0 - float(
            np.prod(1.0 - k / np.arange(n - c + 1, n + 1, dtype=np.float64))
        )

    num_correct = np.asarray(num_correct)
    if isinstance(num_samples, int):
        ns: Iterable[int] = itertools.repeat(num_samples, len(num_correct))
    else:
        if len(num_samples) != len(num_correct):
            raise ValueError(
                f"num_samples ({len(num_samples)}) and num_correct "
                f"({len(num_correct)}) must align — zip truncation would "
                f"silently compute pass@k over the wrong population"
            )
        ns = iter(np.asarray(num_samples))
    return np.array([one(int(n), int(c)) for n, c in zip(ns, num_correct)])


def eval_humaneval(
    generate_fn: Callable[[str], List[str]],
    problems: Optional[List[Dict]] = None,
    ks: Sequence[int] = (1,),
    timeout: float = 6.0,
    out_path: Optional[str] = None,
    verbose: bool = False,
) -> Dict[str, float]:
    """End-to-end HumanEval (reference eval_humaneval, humaneval_utils.py:34-74).

    generate_fn(prompt) -> list of n completions (strings). ``problems``
    defaults to the local openai_humaneval dataset if available.
    """
    if problems is None:
        problems = load_humaneval_problems()
    results: List[Dict] = []
    n_per, c_per = [], []
    for i, prob in enumerate(problems):
        completions = generate_fn(prob["prompt"])
        outcomes = [
            check_correctness(
                prob["prompt"], comp, prob["test"], prob["entry_point"],
                timeout=timeout,
            )
            for comp in completions
        ]
        n_per.append(len(outcomes))
        c_per.append(sum(o["passed"] for o in outcomes))
        results.append(
            {"task_id": prob.get("task_id", i), "outcomes": outcomes}
        )
        if verbose:
            print(f"[humaneval] {i + 1}/{len(problems)}: "
                  f"{c_per[-1]}/{n_per[-1]} passed")
    scores = {
        f"pass@{k}": float(estimate_pass_at_k(n_per, c_per, k).mean())
        for k in ks
        if all(n >= k for n in n_per)
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"scores": scores, "results": results}, f, indent=2,
                      default=str)
    return scores


def load_humaneval_problems() -> List[Dict]:
    """Load openai_humaneval from a local HF datasets cache (zero-egress)."""
    try:
        from datasets import load_dataset

        ds = load_dataset("openai_humaneval", split="test")
        return [dict(r) for r in ds]
    except Exception as e:  # pragma: no cover - environment dependent
        raise RuntimeError(
            "openai_humaneval not available locally; pass `problems` "
            f"explicitly ({e})"
        )
