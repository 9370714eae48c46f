"""Compare the W4A16 GEMM kernels of this checkout with another checkout's
on one card, in one call:

    python -m quick_tpu_torch.examples.kernel_ab --other build/parent

The other tree (e.g. the parent commit unpacked with ``git archive`` into
a directory ``.gitignore`` lists) builds its own kernels. The script prints
the register lines of the other build's K1 (``quantized_matmul.cu``) and
K8 (``grouped_matmul.cu``) kernels beside this build's same entries, then
times K1 at M = 16, 64 and 512 on the
Mistral-7B-width projections and K8 at G=128 on Qwen1.5-MoE's routed
shapes with ``chip_smoke.py``'s timing (CUDA events behind a device sleep,
weights rotated past L2), in turns: other, this, this, other. Each row
ends with this tree's mean over the other's.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = r'''
import collections, contextlib, io, json, re, sys
sys.path.insert(0, ".")
import torch, chip_smoke as cs
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.examples.basic_quant import PRESETS
from quick_tpu_torch.ops import all_kernels
from quick_tpu_torch.ops._cuda import build_all
build_all(all_kernels())
regs = {}  # entry (build hash cut; K8's G=128 instantiation named as before G was a parameter)
for k in all_kernels():
    if k.name in ("quantized_matmul", "grouped_matmul"):
        entry = "?"
        for l in k.build_log.splitlines():
            m = re.search(r"Compiling entry function '\S+?_cu_[0-9a-f]{8}(\S+)'", l)
            if m:
                entry = m.group(1).replace("ELi128EE", "EE")
            elif "Used" in l:
                regs[entry] = l.split(":", 1)[-1].strip()
dev = torch.device("cuda", 0)
cfg = ModelConfig(**cs.MISTRAL_7B)
gen = torch.Generator(device=dev).manual_seed(0)
gemms = [(None, M, K, N) for M in (16, 64, 512) for K, N in cs.gemm_shapes(cfg).values()]
with contextlib.redirect_stdout(io.StringIO()):
    rows = cs.time_gemms(cfg, gen, dev, collections.defaultdict(float), gemms, "")
    rows += cs.grouped_rows("qwen1.5-moe-a2.7b", PRESETS["qwen1.5-moe-a2.7b"], gen, dev)
print(json.dumps({"registers": regs, "ms": {r["name"]: r["ms"] for r in rows}}))
'''


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args(argv)
    this = Path(__file__).resolve().parents[2]
    other = Path(args.other).resolve()
    res = [run(t) for t in (other, this, this, other)]
    for entry, used in res[0]["registers"].items():
        mine = res[1]["registers"].get(entry)
        print(f"{'same' if mine == used else 'DIFFERS'}: {entry[:60]}: other {used} | this {mine}")
    print("kernel | other | this | this | other | this / other")
    for n in res[0]["ms"]:
        v = [r["ms"][n] for r in res]
        print(f"{n} | " + " | ".join(f"{x:.4f}" for x in v) + f" | {(v[1] + v[2]) / (v[0] + v[3]):.4f}")


if __name__ == "__main__":
    main()
