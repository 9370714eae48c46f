"""Time K1's wgmma body (above 8 rows) and K2 with parts of their bodies
removed, on one card, to see where their time goes:

    python -m quick_tpu_torch.examples.kernel_ablate

Each variant is this checkout's source with one part cut (the results are
wrong; only the time means anything), built with the port's ``nvcc`` flags
into a scratch directory and swapped into the wrapper for its timing:

- K1: ``no_mma`` (no wgmma: the fragments are built and folded, the MMAs
  never run), ``no_fold`` (the group's dot added unscaled), ``no_build`` (the
  raw words as fragments, no dequantization);
- K2: ``no_softmax`` (the scores go to p v as they are), ``one_row_tile``
  (16 rows a warp at every length).

Times use ``chip_smoke.py``'s timing (CUDA events behind a device sleep), in
turns with the unchanged source, at K1's Mistral-7B gate_up (K 4096, N
28672) at M = 128, 512, 4096 and K2 at B = 4, S = 1,900 and B = 32, S =
128 (Hq 32, Hkv 8, D 128).
"""
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from quick_tpu_torch.ops import flash_attention as fa
from quick_tpu_torch.ops import quantized_matmul as qm
from quick_tpu_torch.ops._cuda import CSRC, NVCC_FLAGS, _nvcc

_K1_MMA = ("      Wgmma<BT>::mma(dot, a[j], desc_b(xb + (j >> 2) * (BT * 128) + (j & 3) * 32), "
           "j > 0);")
_K1_FOLD = """      acc[4 * i + 0] = fmaf(xv.x, z0, fmaf(dot[4 * i + 0], s0, acc[4 * i + 0]));
      acc[4 * i + 1] = fmaf(xv.y, z0, fmaf(dot[4 * i + 1], s0, acc[4 * i + 1]));
      acc[4 * i + 2] = fmaf(xv.x, z1, fmaf(dot[4 * i + 2], s1, acc[4 * i + 2]));
      acc[4 * i + 3] = fmaf(xv.y, z1, fmaf(dot[4 * i + 3], s1, acc[4 * i + 3]));"""
_K1_BUILD = """      a[j][0] = code_pair(w[0][0], w[1][0], j);  // channel c0, depths 2t, 2t + 1
      a[j][1] = code_pair(w[0][1], w[1][1], j);  // channel c0 + 8
      a[j][2] = code_pair(w[2][0], w[3][0], j);  // channel c0, depths 2t + 8, 2t + 9
      a[j][3] = code_pair(w[2][1], w[3][1], j);"""
_K2_SOFTMAX = """        if (masked) softmax_tile<true, kNT, kBK>(s[mt], o[mt], m[mt], l[mt], t0, tq, pos0, rw);
        else softmax_tile<false, kNT, kBK>(s[mt], o[mt], m[mt], l[mt], t0, tq, pos0, rw);"""
_K2_MT = "      if ((long)((S + 31) / 32) * (Hq / 4) * B >= 2L * sms)"

#: name -> (kernel, file, [(text, replacement)])
VARIANTS = {
    "K1 no_mma": (qm.KERNEL, "qmm_wgmma.cuh",
                  [(_K1_MMA, "      dot[j] += __uint_as_float(a[j][0] ^ a[j][3]);")]),
    "K1 no_fold": (qm.KERNEL, "qmm_wgmma.cuh", [(_K1_FOLD, """      acc[4 * i + 0] += dot[4 * i + 0];
      acc[4 * i + 1] += dot[4 * i + 1];
      acc[4 * i + 2] += dot[4 * i + 2];
      acc[4 * i + 3] += dot[4 * i + 3];""")]),
    "K1 no_build": (qm.KERNEL, "qmm_wgmma.cuh", [(_K1_BUILD, "      a[j][0] = w[0][0] + j; "
                                                  "a[j][1] = w[0][1]; a[j][2] = w[2][0]; "
                                                  "a[j][3] = w[2][1];")]),
    "K2 no_softmax": (fa.KERNEL, "flash_attention.cu", [(_K2_SOFTMAX, "        l[mt][0] += 1.f;")]),
    "K2 one_row_tile": (fa.KERNEL, "flash_attention.cu", [(_K2_MT, "      if (B < 0)")]),
}


def build(name: str, kernel, file: str, edits, root: Path):
    """Copy csrc/ into root/<name>, apply the edits, build the kernel's
    source; returns the loaded library."""
    d = root / name.replace(" ", "_")
    shutil.copytree(CSRC, d)
    text = (d / file).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the text to cut is not in {file} any more")
        text = text.replace(old, new)
    (d / file).write_text(text)
    so = d / "lib.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(d), "-o", str(so), str(d / kernel.source)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in kernel.functions.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.qtt_error_string.argtypes = [ctypes.c_int]
    lib.qtt_error_string.restype = ctypes.c_char_p
    return lib


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    print(cs.card_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    gemms = {M: (torch.randn((M, 4096), generator=gen, device=dev).to(torch.bfloat16),
                 cs.rand_qlinear(gen, dev, 4096, 28672, 2)) for M in (128, 512, 4096)}
    attn = {}
    for B, S, T in ((4, 1900, 2048), (32, 128, 256)):
        q, k, v = cs.attn_inputs(gen, dev, B, S, T, 32, 8, 128)
        attn[(B, S)] = (q, k, v, torch.zeros(B, dtype=torch.int32, device=dev),
                        torch.full((B,), S, dtype=torch.int32, device=dev))

    def times(kernel):
        if kernel is qm.KERNEL:
            return {f"gate_up M={M}": cs.device_ms(
                lambda i, x=x, ws=ws: qm.quantized_matmul_cuda(x, *ws[i % 2]), 10)
                for M, (x, ws) in gemms.items()}
        return {f"B={B} S={S}": cs.device_ms(
            lambda i, a=a: fa.flash_attention_cuda(*a, 128 ** -0.5), 10)
            for (B, S), a in attn.items()}

    with tempfile.TemporaryDirectory() as tmp:
        for name, (kernel, file, edits) in VARIANTS.items():
            kernel.lib()  # the unchanged build
            base = kernel._lib
            cut = build(name, kernel, file, edits, Path(tmp))
            res = []
            for lib in (base, cut, cut, base):
                kernel._lib = lib
                res.append(times(kernel))
            kernel._lib = base
            for shape in res[0]:
                ref = (res[0][shape] + res[3][shape]) / 2
                got = (res[1][shape] + res[2][shape]) / 2
                print(f"{name} {shape}: unchanged {ref:.4f} ms, cut {got:.4f} ms "
                      f"({got / ref:.3f}x)")


if __name__ == "__main__":
    main()
