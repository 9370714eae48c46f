"""Compare the hand-written kernels of this checkout with another
checkout's on one card, in one call:

    python -m quick_tpu_torch.examples.kernel_ab --other build/parent

The other tree (e.g. the parent commit unpacked with ``git archive`` into
a directory ``.gitignore`` lists) builds its own kernels. The script first
compiles every ``csrc/*.cu`` the two trees share to a cubin with ``nvcc``
and prints, per source, how many of the other tree's functions have an
instruction-for-instruction identical body here (``cuobjdump -sass``,
addresses and names aside), naming those that have none. It then prints
the register lines of the other build's K1 (``quantized_matmul.cu``), K2
(``flash_attention.cu``) and K8 (``grouped_matmul.cu``) kernels beside
this build's same entries, and this build's entries the other lacks (with
their spill lines), then times, in turns (other, this, this, other), with
``chip_smoke.py``'s timing (CUDA events behind a device sleep, weights
rotated past L2): K1 at M = 16, 32, 64, 128, 512 and 4096 on the
Mistral-7B-width projections and at the decode's M = 4 with its
prologues, K2 at the shapes of ``PERF.md`` §6 (B = 4, 32, 64 at S = 128,
T = 256; B = 4 at S = 1,900, T = 2,048; DeepSeek-V2-Lite's q / k 192, v
128 at B = 4, S = 128), and K8 at G=128 on Qwen1.5-MoE's routed shapes.
Each row ends with this tree's mean over the other's.
"""
import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from quick_tpu_torch.ops._cuda import NVCC_FLAGS, _nvcc

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
    if k.name in ("quantized_matmul", "grouped_matmul", "flash_attention"):
        entry = "?"
        for l in k.build_log.splitlines():
            m = re.search(r"Compiling entry function '\S+?_cu_[0-9a-f]{8}(\S+)'", l)
            if m:
                entry = m.group(1).replace("ELi128EE", "EE")
            elif "Used" in l:
                regs[entry] = regs.get(entry, "") + l.split(":", 1)[-1].strip()
            elif "spill" in l:
                regs[entry] = l.strip() + "; "
dev = torch.device("cuda", 0)
cfg = ModelConfig(**cs.MISTRAL_7B)
gen = torch.Generator(device=dev).manual_seed(0)
gemms = [(None, M, K, N) for M in (16, 32, 64, 128, 512, 4096)
         for K, N in cs.gemm_shapes(cfg).values()]
gemms += [g for g in cs.main_path_gemms(cfg) if g[1] == cs.BATCH]  # decode, with prologues
flash = [dict(B=B, S=128, T=256) for B in (4, 32, 64)] + [dict(B=4, S=1900, T=2048),
         dict(B=4, S=128, T=256, heads=(16, 16, 192, 128))]
with contextlib.redirect_stdout(io.StringIO()):
    rows = cs.time_gemms(cfg, gen, dev, collections.defaultdict(float), gemms, "")
    rows += [cs.flash_row(cfg, gen, dev, **kw) for kw in flash]
    rows += cs.grouped_rows("qwen1.5-moe-a2.7b", PRESETS["qwen1.5-moe-a2.7b"], gen, dev)
print(json.dumps({"registers": regs, "ms": {r["name"]: r["ms"] for r in rows}}))
'''


def sass_bodies(tree: Path, source: str, out_dir: Path) -> dict:
    """{function: its SASS instructions} of ``csrc/<source>`` in ``tree``,
    built with the port's flags as a cubin."""
    csrc = tree / "quick_tpu_torch" / "csrc"
    cubin = out_dir / f"{tree.name}-{source}.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_nvcc(), *flags, "-cubin", "-I", str(csrc), "-o", str(cubin),
                    str(csrc / source)], check=True, capture_output=True)
    objdump = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(objdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            funcs[name].append(m.group(1).strip())
    return {k: "\n".join(v) for k, v in funcs.items()}


def short_name(mangled: str) -> str:
    """A function's demangled name (``cu++filt`` beside ``nvcc``), else
    the mangled one."""
    filt = Path(_nvcc()).with_name("cu++filt")
    if filt.exists():
        out = subprocess.run([str(filt), mangled], capture_output=True, text=True)
        if out.returncode == 0:
            return re.sub(r"\(anonymous namespace\)::", "", out.stdout.strip())
    return mangled


def compare_sass(other: Path, this: Path) -> None:
    shared = sorted(f.name for f in (this / "quick_tpu_torch" / "csrc").glob("*.cu")
                    if (other / "quick_tpu_torch" / "csrc" / f.name).exists())
    with tempfile.TemporaryDirectory() as tmp:
        for source in shared:
            old = sass_bodies(other, source, Path(tmp))
            new = set(sass_bodies(this, source, Path(tmp)).values())
            differ = [name for name, body in old.items() if body not in new]
            print(f"SASS {source}: {len(old) - len(differ)} of the other tree's {len(old)} "
                  f"functions have an identical body here")
            for name in differ:
                print(f"  not here: {short_name(name)[:150]}")


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
    compare_sass(other, this)
    res = [run(t) for t in (other, this, this, other)]
    for entry, used in res[0]["registers"].items():
        mine = res[1]["registers"].get(entry)
        print(f"{'same' if mine == used else 'DIFFERS'}: {entry[:60]}: other {used} | this {mine}")
    for entry, used in res[1]["registers"].items():
        if entry not in res[0]["registers"]:
            print(f"new here: {entry[:90]}: {used}")
    print("kernel | other | this | this | other | this / other")
    for n in res[0]["ms"]:
        v = [r["ms"][n] for r in res]
        print(f"{n} | " + " | ".join(f"{x:.4f}" for x in v) + f" | {(v[1] + v[2]) / (v[0] + v[3]):.4f}")


if __name__ == "__main__":
    main()
