"""Time the wgmma bodies above 8 rows (K1, K9, K11f), K8, K12 and K2 with parts
of their bodies removed or their launch changed, on one card, to see where
their time goes:

    python -m quick_tpu_torch.examples.kernel_ablate [--only K8 K9 K11f]

Each variant is this checkout's source with one part cut (the results are
wrong; only the time means anything), built with the port's ``nvcc`` flags
into a scratch directory and swapped into the wrapper for its timing:

- K1: ``no_mma`` (no wgmma: the fragments are built and folded, the MMAs
  never run), ``no_fold`` (the group's dot added unscaled), ``no_build`` (the
  raw words as fragments, no dequantization);
- K9: ``no_mma``, ``no_dequant`` (the raw words as fragments: no
  dequantization, no scales read);
- K11f: ``no_mma``, ``no_build`` (raw words as fragments: no transpose, no masks);
- K8: ``no_mma``, ``no_x`` (no activation rows copied), ``one_block_6_stages``
  (64-row passes at one block an SM with a 6-stage ring instead of two
  blocks with 4), ``pass_rows_32`` (32-row passes at bm = 32, three blocks
  an SM: an expert with two tiles is streamed twice), ``short_splits`` (no
  floor under a K split's length: ``MIN_SPLIT_STAGES`` = 1);
- K12: ``no_mma``, ``no_x`` (no int8 rows copied; the cut is in the
  skeleton it shares with K8, ``grouped_wgmma.cuh``);
- K2: ``no_softmax`` (the scores go to p v as they are), ``one_row_tile``
  (16 rows a warp at every length).

Times use ``chip_smoke.py``'s timing (CUDA events behind a device sleep), in
turns with the unchanged source, at the Mistral-7B gate_up (K 4096, N
28672): K1 at M = 128, 512, 4096, K9 (G = 32) and K11f at M = 128, 512; K2
at B = 4, S = 1,900 and B = 32, S = 128 (Hq 32, Hkv 8, D 128); K8 at
Mixtral-8x7B's decode (B = 4, Mp = 256) and Engine step (16 rows, Mp = 288),
gate_up and down, and Qwen1.5-MoE's decode down (E = 60, K = 1408); K12 at
Mixtral-8x7B's decode (Mp = 256) and B = 4 prefill (Mp = 2048), gate_up
and down; on one random routing each.
"""
import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from quick_tpu_torch.ops import flash_attention as fa
from quick_tpu_torch.ops import grouped_matmul as gm
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
_K9_MMA = "      Wgmma<BT>::mma(acc, a[j], desc_b(xb + (j >> 2) * (BT * 128) + (j & 3) * 32), 1);"
_K9_DEQUANT = """  const float flo = __uint_as_float(((lo >> sh) & 0xFu) | 0x4B000000u);
  const float fhi = __uint_as_float(((hi >> sh) & 0xFu) | 0x4B000000u);
  __nv_bfloat162 r = __floats2bfloat162_rn(__fsub_rn(fmaf(flo, s, c), zs),
                                           __fsub_rn(fmaf(fhi, s, c), zs));
  return *reinterpret_cast<uint32_t*>(&r);"""
_K11F_MMA = "        WgmmaS8<BT>::mma(dot, a[s], desc_b(xb + (c * kSteps + s) * 32), s > 0);"
_K11F_BUILD = "      a_fragments<G>(wsm, c, c0, t, a);"
_K2_SOFTMAX = """        if (masked) softmax_tile<true, kNT, kBK>(s[mt], o[mt], m[mt], l[mt], t0, tq, pos0, rw);
        else softmax_tile<false, kNT, kBK>(s[mt], o[mt], m[mt], l[mt], t0, tq, pos0, rw);"""
_K2_MT = "      if ((long)((S + 31) / 32) * (Hq / 4) * B >= 2L * sms)"

_K8_MMA = ["      mma_group<32, PR, G>(dot, a, xb, C);",
           "      mma_group<PR, PR, G>(dot, a, xb, C);"]
# the skeleton K8 and K12 share (grouped_wgmma.cuh): the rows' copies, the
# ring's stages, the blocks an SM, the pass height
_GROUPED_X = [("""        tma_load(xs + p * bm * 128, &maps.x, st * kKC, row, bar);
        if constexpr (B::kXBytes == 2)  // bf16 rows: depths 64 .. 127 in a second slice
          tma_load(xs + PR * 128 + p * bm * 128, &maps.x, st * kKC + 64, row, bar);""", ""),
              ("mbar_arrive_expect_tx(bar, np * bm * (kKC * B::kXBytes + kCG * 4) + L::kW + 2 * L::kS);",
               "mbar_arrive_expect_tx(bar, np * bm * kCG * 4 + L::kW + 2 * L::kS);")]
_K8_STAGES = "  static constexpr int kStages = PR == 128 ? 4 : ring_stages(kStage, B::kMaxStages);"
_K8_BOUNDS = "__launch_bounds__(kThreads, PR == 64 ? 2 : 1)"
_K8_PASS = "  if (bm == 128)\n    return launch_pg<B, 128, G>"
_K12_MMA = "  for (int s = 0; s < 4; ++s) WgmmaS8<W>::mma(d, a[s], desc_b(xb + s * 32), s > 0);"

#: name -> (kernel, file, [(text, replacement)], {(module, attribute): value}
#: set while the cut version runs)
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
    "K9 no_mma": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [(_K9_MMA, "      acc[j] += __uint_as_float("
                                                         "a[j][0] ^ a[j][3]);")]),
    "K9 no_dequant": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [(_K9_DEQUANT, "  return (lo >> sh) ^ hi;")]),
    "K11f no_mma": (qm.KERNEL_A8, "qmm_wgmma_a8.cuh", [(_K11F_MMA, "        dot[s] += (int)(a[s][0] "
                                                        "^ a[s][3]);")]),
    "K11f no_build": (qm.KERNEL_A8, "qmm_wgmma_a8.cuh", [(_K11F_BUILD, "      for (int s = 0; s < "
                                                          "kSteps; ++s) for (int i = 0; i < 4; ++i) "
                                                          "a[s][i] = wsm[c0 + 8 * i];")]),
    "K2 no_softmax": (fa.KERNEL, "flash_attention.cu", [(_K2_SOFTMAX, "        l[mt][0] += 1.f;")]),
    "K2 one_row_tile": (fa.KERNEL, "flash_attention.cu", [(_K2_MT, "      if (B < 0)")]),
    "K8 no_mma": (gm.KERNEL, "grouped_matmul.cu", [
        (m, "      dot[C] += __uint_as_float(a[0][0] ^ a[0][3]);") for m in _K8_MMA]),
    "K8 no_x": (gm.KERNEL, "grouped_wgmma.cuh", _GROUPED_X),
    "K8 one_block_6_stages": (gm.KERNEL, "grouped_wgmma.cuh", [
        (_K8_STAGES, "  static constexpr int kStages = PR == 128 ? 4 : 6;"),
        (_K8_BOUNDS, "__launch_bounds__(kThreads, 1)")]),
    "K8 pass_rows_32": (gm.KERNEL, "grouped_wgmma.cuh", [
        (_K8_STAGES, "  static constexpr int kStages = PR == 128 ? 4 : ring_stages(kStage, 4);"),
        (_K8_BOUNDS, "__launch_bounds__(kThreads, PR == 64 ? 2 : PR == 32 ? 3 : 1)"),
        (_K8_PASS, "  if (bm == 32)\n    return launch_pg<B, 32, G>(x, qw, s, zs, te, live, sx, xsumT, "
                   "partial, Mp, K, N, E, bm, splits, cps, out, st);\n  if (bm == 128)\n"
                   "    return launch_pg<B, 128, G>")]),
    "K8 short_splits": (gm.KERNEL, "grouped_matmul.cu", [], {(gm, "MIN_SPLIT_STAGES"): 1}),
    "K12 no_mma": (gm.KERNEL_A8, "grouped_matmul_a8.cu", [
        (_K12_MMA, "  for (int s = 0; s < 4; ++s) d[s] += (int)(a[s][0] ^ a[s][3]);")]),
    "K12 no_x": (gm.KERNEL_A8, "grouped_wgmma.cuh", _GROUPED_X),
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", help="kernels to cut (K1, K9, K11f, K8, K12, K2); all by default")
    args = ap.parse_args(argv)
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

    dq = cs.rand_qlinear(gen, dev, 4096, 28672, 2, group=32)
    moe = {}  # K8: "<model> <projection> Mp=..." -> (x, [weight stacks], te, live, bm)
    moe_a8 = {}  # K12: the same, x as its int8 codes and row scales
    if not args.only or "K8" in args.only or "K12" in args.only:
        from quick_tpu_torch.examples.basic_quant import PRESETS

        for model, Ts, projs in (("mixtral-8x7b", (4, 16, 512), ("gate_up", "down")),
                                 ("qwen1.5-moe-a2.7b", (4,), ("down",))):
            cfg = PRESETS[model]
            E, kk, D = cfg.num_local_experts, cfg.num_experts_per_tok, cfg.hidden_size
            F = cfg.moe_intermediate_size or cfg.intermediate_size
            for proj in projs:
                K, N = (D, 2 * F) if proj == "gate_up" else (F, D)
                stacks = []
                for _ in range(2):  # two copies: the touched experts exceed 2 x L2
                    ws = cs.rand_qlinear(gen, dev, K, N, copies=E)
                    stacks.append([torch.stack([w[j] for w in ws]) for j in range(3)])
                for T in Ts:
                    sel = torch.argsort(torch.rand((T, E), generator=gen, device=dev), 1)[:, :kk]
                    bm = gm.pick_grouped_bm(T * kk, E)
                    _, _, te, live, _ = gm.build_routing(sel, E, bm)
                    x = torch.randn((te.shape[0] * bm, K), generator=gen, device=dev)
                    name = f"{model} {proj} Mp={te.shape[0] * bm}"
                    if T in (4, 16):
                        moe[name] = (x.to(torch.bfloat16), stacks, te, live, bm)
                    if T in (4, 512) and model == "mixtral-8x7b":
                        moe_a8[name] = (qm.quantize_activations(x), stacks, te, live, bm)

    def times(kernel):
        if kernel is qm.KERNEL:
            return {f"gate_up M={M}": cs.device_ms(
                lambda i, x=x, ws=ws: qm.quantized_matmul_cuda(x, *ws[i % 2]), 10)
                for M, (x, ws) in gemms.items()}
        if kernel is qm.KERNEL_DEQUANT:
            return {f"gate_up G=32 M={M}": cs.device_ms(
                lambda i, x=x: qm.quantized_matmul_dequant_cuda(x, *dq[i % 2], 32), 10)
                for M, (x, _) in gemms.items() if M <= 512}
        if kernel is gm.KERNEL:
            return {name: cs.device_ms(lambda i, c=c: gm.quantized_matmul_grouped_cuda(
                c[0], *c[1][i % 2], c[2], c[3], c[4]), 20) for name, c in moe.items()}
        if kernel is gm.KERNEL_A8:
            return {name: cs.device_ms(lambda i, c=c: gm.launch_grouped_a8(
                *c[0], *c[1][i % 2], c[2], c[3], c[4]), 20) for name, c in moe_a8.items()}
        if kernel is qm.KERNEL_A8:
            return {f"fused gate_up M={M}": cs.device_ms(
                lambda i, x=x, ws=ws: qm.launch_a8(x, None, *ws[i % 2]), 10)
                for M, (x, ws) in gemms.items() if M <= 512}
        return {f"B={B} S={S}": cs.device_ms(
            lambda i, a=a: fa.flash_attention_cuda(*a, 128 ** -0.5), 10)
            for (B, S), a in attn.items()}

    with tempfile.TemporaryDirectory() as tmp:
        for name, (kernel, file, edits, *attrs) in VARIANTS.items():
            if args.only and name.split()[0] not in args.only:
                continue
            kernel.lib()  # the unchanged build
            base = kernel._lib
            cut = build(name, kernel, file, edits, Path(tmp)) if edits else base
            attrs = attrs[0] if attrs else {}
            saved = {key: getattr(*key) for key in attrs}
            res = []
            for is_cut in (False, True, True, False):
                kernel._lib = cut if is_cut else base
                for (mod, attr), value in (attrs if is_cut else saved).items():
                    setattr(mod, attr, value)
                res.append(times(kernel))
            for (mod, attr), value in saved.items():
                setattr(mod, attr, value)
            kernel._lib = base
            for shape in res[0]:
                ref = (res[0][shape] + res[3][shape]) / 2
                got = (res[1][shape] + res[2][shape]) / 2
                print(f"{name} {shape}: unchanged {ref:.4f} ms, cut {got:.4f} ms "
                      f"({got / ref:.3f}x)")


if __name__ == "__main__":
    main()
