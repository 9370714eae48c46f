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
(``flash_attention.cu``), K3 (``fused_decode_step.cu``), K5 / K6
(``paged_attention.cu``), K5q / K6q (``paged_attention_int8.cu``), K8
(``grouped_matmul.cu``), K9
(``quantized_matmul_dequant.cu``), K11 / K11f
(``quantized_matmul_a8.cu``) and K12 (``grouped_matmul_a8.cu``) kernels
beside this build's same entries,
and this build's entries the other lacks (with their spill lines), then
times, in turns (other, this, this, other), with ``chip_smoke.py``'s
timing (CUDA events behind a device sleep, weights rotated past L2): K1 at
M = 16, 32, 64, 128, 512 and 4096 on the Mistral-7B-width projections and
at the decode's M = 4 with its prologues, K2 at the shapes of ``PERF.md``
§6 (B = 4, 32, 64 at S = 128, T = 256; B = 4 at S = 1,900, T = 2,048;
DeepSeek-V2-Lite's q / k 192, v 128 at B = 4, S = 128), K8 at G=128 on
Qwen1.5-MoE's and Mixtral-8x7B's routed shapes (Mp = 256, 288, 512, 2048)
and at G=64 on DeepSeek-V2-Lite's (Mp = 768, 5056), K12 on Mixtral-8x7B's
routed A8 shapes (Mp = 256 and 2048, its first kernel and split reduce
included, and checked at bm = 96), K5 / K6 at the
Mistral-7B-width Engine's shapes, K5q / K6q at the INT8 Engine's, K9 at
M = 1, 4, 8, 16, 128, 512 on the Mistral-7B projections at G = 32 and on
DeepSeek-V2-Lite's seven at M = 1, 4, 8, 512, G = 64,
K11 and K11f at M = 128 and 512 on the Mistral-7B projections, and K3
through its wrapper at B = 4, 1 and 8 with S = 256 (length 191) and at
B = 4, S = 1,536 (length 1,500), Mistral-7B's heads. Each row ends with
this tree's mean over the other's; a row only one tree times is
named apart. ``--sass-only`` stops after the SASS comparison; ``--only``
times only the named groups (k1 k2 k3 k5 k5q k8 k9 k11 k12; k5 is K5 / K6,
k5q K5q / K6q), e.g. ``--only k9 k5q``.
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
only = set(sys.argv[1:])  # the groups to time, all when empty
want = lambda group: not only or group in only
regs = {}  # entry (build hash cut; K8's G=128 instantiation named as before G was a parameter)
for k in all_kernels():
    if k.name in ("quantized_matmul", "grouped_matmul", "flash_attention", "paged_attention",
                  "quantized_matmul_dequant", "quantized_matmul_a8", "fused_decode_step",
                  "grouped_matmul_a8", "paged_attention_int8"):
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
ds = ModelConfig.from_hf_config(cs.DEEPSEEK_V2_LITE)
rows = []
with contextlib.redirect_stdout(io.StringIO()):
    if want("k1"):
        rows += cs.time_gemms(cfg, gen, dev, collections.defaultdict(float), gemms, "")
    if want("k2"):
        rows += [cs.flash_row(cfg, gen, dev, **kw) for kw in flash]
    if want("k8"):
        rows += cs.grouped_rows("qwen1.5-moe-a2.7b", PRESETS["qwen1.5-moe-a2.7b"], gen, dev)
        rows += cs.grouped_rows("mixtral-8x7b", PRESETS["mixtral-8x7b"], gen, dev)
        rows += cs.grouped_rows("deepseek-v2-lite", ds, gen, dev, group=cs.DS_G,
                                cases=[(cs.DS_GEN, cs.BATCH), (cs.DS_GEN, cs.BATCH * cs.PROMPT)])
    if want("k12"):
        rows += cs.grouped_rows("mixtral-8x7b", PRESETS["mixtral-8x7b"], gen, dev,
                                cases=cs.A8_K12_CASES, tag="12a", a8=True)
    if want("k5"):
        rows += cs.paged_attention_rows(cfg, gen, dev, cs.serving_trace(cfg.vocab_size))
    if want("k5q"):
        rows += cs.int8_attention_rows(cfg, gen, dev, cs.serve_bench_trace(cfg.vocab_size))
    if want("k9"):
        rows += cs.dequant_rows("", cs.gemm_shapes(cfg),
                                [("ab", M) for M in (1, 4, 8, 16, 128, 512)], 32, gen, dev)
        rows += cs.dequant_rows("", cs.ds_k9_shapes(ds), [("ab", M) for M in (1, 4, 8, 512)],
                                cs.DS_G, gen, dev)
    if want("k11"):
        rows += cs.a8_rows("", cs.gemm_shapes(cfg), [("ab", "ab", M) for M in (128, 512)], 128,
                           gen, dev)
# K3 through its wrapper (the same arguments in both trees) at PERF.md's shape
# and B = 1, 8 and S = 1,536: 32 layers of cache, one layer a launch
from quick_tpu_torch.ops import fused_decode_step as fs
Hq, Hkv, D, L = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, 32
if want("k3"):
    for B, S, length in ((4, 256, 191), (1, 256, 191), (8, 256, 191), (4, 1536, 1500)):
        g = torch.Generator(device=dev).manual_seed(B * S)
        q, kn, vn = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                     for sh in ((B, Hq, D), (B, Hkv, D), (B, Hkv, D)))
        kc, vc = (torch.randn((L, B, Hkv, S, D), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.28
        c, sn = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
        ln = torch.full((1,), length, dtype=torch.int32, device=dev)
        ms = cs.device_ms(lambda i: fs.fused_decode_attention_cuda(
            q, kn, vn, kc, vc, c, sn, ln, i % L, D ** -0.5), 100)
        rows.append(dict(name=f"fused_decode_step[B={B} S={S} length={length}]", ms=ms))
        del kc, vc
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
            here = sass_bodies(this, source, Path(tmp))
            new = set(here.values())
            by_name = {short_name(n): b for n, b in here.items()}
            differ = [name for name, body in old.items() if body not in new]
            print(f"SASS {source}: {len(old) - len(differ)} of the other tree's {len(old)} "
                  f"functions have an identical body here")
            for name in differ:
                print(f"  not here: {short_name(name)[:150]}")
                mine = by_name.get(short_name(name))
                if mine is not None:  # the same function here: its first differing instruction
                    a, b = old[name].splitlines(), mine.splitlines()
                    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
                    print(f"    {len(a)} / {len(b)} instructions, first difference at {i}: "
                          f"{a[i] if i < len(a) else '-'} | {b[i] if i < len(b) else '-'}")


def run(tree: Path, only) -> dict:
    out = subprocess.run([sys.executable, "-c", _RUN, *only], cwd=tree, capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--sass-only", action="store_true", help="compare the SASS and stop")
    ap.add_argument("--only", nargs="*", default=[], help="time only these groups")
    args = ap.parse_args(argv)
    this = Path(__file__).resolve().parents[2]
    other = Path(args.other).resolve()
    compare_sass(other, this)
    if args.sass_only:
        return
    res = [run(t, args.only) for t in (other, this, this, other)]
    for entry, used in res[0]["registers"].items():
        mine = res[1]["registers"].get(entry)
        print(f"{'same' if mine == used else 'DIFFERS'}: {entry[:60]}: other {used} | this {mine}")
    for entry, used in res[1]["registers"].items():
        if entry not in res[0]["registers"]:
            print(f"new here: {entry[:90]}: {used}")
    print("kernel | other | this | this | other | this / other")
    for n in res[0]["ms"]:
        if n not in res[1]["ms"]:
            print(f"only the other tree times: {n}")
            continue
        v = [r["ms"][n] for r in res]
        print(f"{n} | " + " | ".join(f"{x:.4f}" for x in v) + f" | {(v[1] + v[2]) / (v[0] + v[3]):.4f}")
    for n in res[1]["ms"]:
        if n not in res[0]["ms"]:
            print(f"only this tree times: {n}")


if __name__ == "__main__":
    main()
