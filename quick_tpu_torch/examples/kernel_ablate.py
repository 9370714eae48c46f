"""Time the wgmma bodies above 8 rows (K1, K9, K11f), K8, K12, K2 and the
attention and page-write kernels with parts of their bodies removed or their
launch changed, on one card, to see where their time goes:

    python -m quick_tpu_torch.examples.kernel_ablate [--only K8 K9 K11f]

Each variant is this checkout's source with one part cut (the results are
wrong; only the time means anything), built with the port's ``nvcc`` flags
into a scratch directory and swapped into the wrapper for its timing:

- K1's decode rows (``K1d``): ``pingpong`` (two group accumulators in turn,
  each stage's fold under the next stage's MMAs after ``wgmma.wait_group
  1``, three B tiles: the design the body tried first, which ptxas
  serializes), at M = 4 on the Mistral-7B projections with the path's
  prologues;
- K1: ``no_mma`` (no wgmma: the fragments are built and folded, the MMAs
  never run), ``no_fold`` (the group's dot added unscaled), ``no_build`` (the
  raw words as fragments, no dequantization);
- K9: ``no_mma``, ``no_dequant`` (the raw words as fragments: no
  dequantization, no scales read); at the decode rows (8 tokens a block)
  also ``no_merge`` (the splits' partials written, never summed),
  ``fence_all`` (every thread fences its partials before a plain atomic,
  and again after it, instead of one acq_rel atomic), ``no_pdl`` (a plain
  launch, not a programmatic dependent of the kernel before), ``fill_0`` (the plan's
  ``DQ_FILL_STAGES`` at 0: more splits), ``max_splits_4`` /
  ``max_splits_8`` (``DQ_MAX_SPLITS``: fewer splits);
- K11f: ``no_mma``, ``no_build`` (raw words as fragments: no transpose, no masks);
- K8: ``no_mma``, ``no_x`` (no activation rows copied), ``one_block_6_stages``
  (64-row passes at one block an SM with a 6-stage ring instead of two
  blocks with 4), ``pass_rows_32`` (32-row passes at bm = 32, three blocks
  an SM: an expert with two tiles is streamed twice), ``short_splits`` (no
  floor under a K split's length: ``MIN_SPLIT_STAGES`` = 1);
- K12: ``no_mma``, ``no_x`` (no int8 rows copied; the cut is in the
  skeleton it shares with K8, ``grouped_wgmma.cuh``);
- K2: ``no_softmax`` (the scores go to p v as they are), ``one_row_tile``
  (16 rows a warp at every length);
- K6q: ``no_convert`` (the staged codes never converted to bf16: the
  products read stale stages), the share of its time that converting each
  code once a tile takes;
- K5q: its split plan, no rebuild: ``k5_plan`` (K5's plan uncapped:
  ``INT8_DECODE_MAX_TILES`` = 16, one split at 64 slots x 8 kv heads),
  ``max_tiles_2`` and ``max_tiles_8`` (a split's chunk cut to 2 or 8
  64-key tiles), each against the kept cap of 4; and its body:
  ``every_split`` (the blocks of splits without a key run and count too, as
  K5's do), ``no_mma`` (neither product runs), ``no_convert`` (the staged
  codes never converted), ``no_wait`` (no wait for an item's copies);
- K10q: ``no_mma``, ``no_convert``, ``no_wait``, as K5q's;
- K10 (the same kernel over bf16 pages): ``no_mma``, ``no_wait`` (no wait
  for a tile's copies: the products read a stage still in flight);
- K4q: ``no_divide`` (x times the scale, not x over it: no IEEE division),
  ``scalar`` (every row on the scalar path: ``WRITE_MAX_UNITS`` = 0, a
  warp a row, values read twice, byte stores), ``lanes_64`` and
  ``lanes_1024`` (``WRITE_LANES``: blocks of fewer or more rows), and
  ``no_pdl`` (a plain launch, not a programmatic dependent of the kernel
  before); their cuts are in the row body K4q shares with K4,
  ``paged_write_rows.cuh``, built into K4q's library only;
- K4 (the same body's copy kind): ``no_pdl`` (``WRITE_PDL`` off: a plain
  launch), ``scalar`` (every row on the scalar path: ``WRITE_MAX_UNITS`` 0, a
  warp a row, byte copies), ``lanes_64`` and ``lanes_1024`` (``WRITE_LANES``);
- K14: ``drain`` (the producer never runs into the next GEMM's weights:
  the ring drains at each grid barrier, ``kAhead`` 0), ``no_pdl`` (a plain
  launch), ``one_block`` (120 KB more shared memory: one block an SM,
  half the grid), and, to see where its time goes, ``no_merge`` (no
  tile's sums merged or stored), ``no_barrier`` (the grid barriers cut to
  block barriers), ``no_mma`` (the shared body's MMAs cut), ``empty`` (no
  GEMM: the launch, both barriers and the norm's statistics alone) and
  ``o_only`` / ``gate_up_only`` / ``down_only`` (one GEMM's items kept, its
  stream started at its phase);
- K13: ``scalar`` (every row on the scalar path: ``NORM_MAX_UNITS`` 0),
  ``no_pdl`` (``NORM_PDL`` off: a plain launch) and ``block_a_row``
  (``NORM_MAX_ROWS`` 1).

Times use ``chip_smoke.py``'s timing (CUDA events behind a device sleep), in
turns with the unchanged source, at the Mistral-7B gate_up (K 4096, N
28672): K1 at M = 128, 512, 4096, K9 (G = 32) and K11f at M = 128, 512
(K9 also at M = 4 there, at the Mistral-7B qkv at G = 32 and at
DeepSeek-V2-Lite's q, kv_a and shared gate_up at G = 64); K2
at B = 4, S = 1,900 and B = 32, S = 128 (Hq 32, Hkv 8, D 128); K8 at
Mixtral-8x7B's decode (B = 4, Mp = 256) and Engine step (16 rows, Mp = 288),
gate_up and down, and Qwen1.5-MoE's decode down (E = 60, K = 1408); K12 at
Mixtral-8x7B's decode (Mp = 256) and B = 4 prefill (Mp = 2048), gate_up
and down; on one random routing each; K6q at the INT8 Engine's chunk (B = 8,
S = 16 at serve_bench's starts, 32 layers of INT8 pages); K5q at the INT8
Engine's decode (B = 64 at ``chip_smoke.py::trace_positions``' lengths, the
same pool); K10q and K10 at the DeepSeek-V2-Lite INT8 and bf16 Engines'
decode (B = 16, Hq = 16, 27 layers of latent pages); K4q at the INT8
Engine's decode (B = 64) and chunk (B = 8, S = 16), 32 layers of INT8
pages, on DeepSeek-V2-Lite's latent planes (B = 16, B = 8 x 16), 27
layers, and in a captured graph of the INT8 Engine's decode writes (32 x
K1's qkv projection at M = 64, then K4q); K4 at the bf16 Engine's decode
(B = 16) and chunk (B = 8, S = 16), 32 layers of bf16 pages, on the latent
planes, and in a captured graph of 32 x (K1's qkv projection at M = 16,
then K4); K14 at M = 1, 4, 8 on the
Mistral-7B widths (two weight copies rotated); K13 at ``chip_smoke.py``'s
five shapes (``K13_CASES``) and in a captured graph of 32 x (K13, then
K1's qkv projection) at M = 16.
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
from quick_tpu_torch.ops import fused_layer_tail as ft
from quick_tpu_torch.ops import grouped_matmul as gm
from quick_tpu_torch.ops import mla_paged_attention as ml
from quick_tpu_torch.ops import norms as nm
from quick_tpu_torch.ops import paged_attention as pa
from quick_tpu_torch.ops import paged_write as pw
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
# K1's decode rows: from the group dot's MMAs to the end of the shared body
# (qmm_decode_rows.cuh), and the ping-pong that replaces them (two
# accumulators in turn, each stage's fold under the next stage's MMAs after
# wgmma.wait_group 1, three B tiles; a stage is released a turn later, so
# the copies run one stage less ahead)
_K1D_LOOP = ("  // stage `it`'s group dot into dot: 8 MMAs, one commit group\n",
             "\n}\n\n}  // namespace qwk")
_K1D_PINGPONG = """  auto issue = [&](int it, const uint32_t (&a)[8][4], float (&d)[4]) {
    const uint32_t xb = sbase + L::oX + (it % kXStages) * L::kX;
    qwg::hold(d);
    qwg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      qwg::Wgmma<8>::mma(d, a[j], qwg::desc_b(xb + (j >> 2) * 1024 + (j & 3) * 32), j > 0);
    qwg::wgmma_commit();
  };
  auto fold = [&](int it, uint32_t (&a)[8][4], float (&d)[4]) {
    qwg::hold(d);
    qwg::hold(a);
    const int st = (base + it) % kStages;
    const float* ssm = reinterpret_cast<const float*>(smem + st * L::kStage + L::kW);
    const float s0 = ssm[c0], s1 = ssm[c0 + 8];
    const float z0 = -ssm[kBN + c0], z1 = -ssm[kBN + c0 + 8];
    const float2 xv = *reinterpret_cast<const float2*>(xsums + (it % kXStages) * 8 + 2 * t);
    acc[0] = fmaf(xv.x, z0, fmaf(d[0], s0, acc[0]));
    acc[1] = fmaf(xv.y, z0, fmaf(d[1], s0, acc[1]));
    acc[2] = fmaf(xv.x, z1, fmaf(d[2], s1, acc[2]));
    acc[3] = fmaf(xv.y, z1, fmaf(d[3], s1, acc[3]));
    qwg::mbar_arrive(empty + 8 * st);
  };
  auto head = [&](int it) {
    __syncthreads();
    if (it > 0) ahead(it - 1);
  };
  uint2 raw[2];
  if (nit > 0) {
    load_raw(0, raw);
    stage_x(0, raw);
    if (nit > 1) load_raw(1, raw);
  }
  uint32_t a0[8][4], a1[8][4];
  float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < nit; it += 2) {
    head(it);
    build(it, a0);
    issue(it, a0, d0);
    if (it > 0) {
      qwg::wgmma_wait1();
      fold(it - 1, a1, d1);
    }
    if (it + 1 == nit) {
      qwg::wgmma_wait0();
      fold(it, a0, d0);
      break;
    }
    stage_x(it + 1, raw);
    if (it + 2 < nit) load_raw(it + 2, raw);
    head(it + 1);
    build(it + 1, a1);
    issue(it + 1, a1, d1);
    qwg::wgmma_wait1();
    fold(it, a0, d0);
    if (it + 2 == nit) {
      qwg::wgmma_wait0();
      fold(it + 1, a1, d1);
      break;
    }
    stage_x(it + 2, raw);
    if (it + 3 < nit) load_raw(it + 3, raw);
  }"""
_K9_MMA = "      Wgmma<BT>::mma(acc, a[j], desc_b(xb + (j >> 2) * (BT * 128) + (j & 3) * 32), 1);"
_K9_MERGE = "    // the last split of this output tile to finish sums the splits' partials"
_K9_ATOM = """      int done;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\\n"
                   : "=r"(done) : "l"(cnt) : "memory");"""
_K9_PDL = "    attr[0].val.programmaticStreamSerializationAllowed = 1;"
_K9_FENCES = [("""    __syncthreads();  // every partial of this block is written; the ring is free
    if (tid == 0) {""", """    __threadfence();
    __syncthreads();
    if (tid == 0) {"""), (_K9_ATOM, "      const int done = atomicAdd(cnt, 1);"),
              ("    if (!*flag) return;\n", "    if (!*flag) return;\n    __threadfence();\n")]
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
_K6Q_CONVERT = """        *reinterpret_cast<uint4*>(kb + swz<D>(j, 2 * ch)) = codes_bf16(k4.x, k4.y);
        *reinterpret_cast<uint4*>(kb + swz<D>(j, 2 * ch + 1)) = codes_bf16(k4.z, k4.w);
        *reinterpret_cast<uint4*>(vb + swz<D>(j, 2 * ch)) = codes_bf16(v4.x, v4.y);
        *reinterpret_cast<uint4*>(vb + swz<D>(j, 2 * ch + 1)) = codes_bf16(v4.z, v4.w);"""
_K5Q_LIVE = """    nwait = wlo < end ? (end - 1) / chunk - first + 1 : 1;
    if (sp < first || sp >= first + nwait) return;"""
_K5Q_MMA = ["        mma16832(si[0], qa, kb[0], kb[1]);\n        mma16832(si[1], qa, kb[2], kb[3]);",
            "        mma16816(c0v, pa, vb[0], vb[1]);\n        mma16816(c1v, pa, vb[2], vb[3]);"]
_K5Q_CONVERT = """      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch)) = codes_bf16(w.x, w.y);
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch + 1)) = codes_bf16(w.z, w.w);"""
_K5Q_WAIT = "    cp_async_wait1();  // this thread's copies of item i + 1 landed\n"
_K10Q_MMA = ["      mma16816(sc[kk & 1][0], a, kb[0], kb[1]);\n      mma16816(sc[kk & 1][1], a, kb[2], kb[3]);",
             "      mma16816(spe[0], a, kb[0], kb[1]);\n      mma16816(spe[1], a, kb[2], kb[3]);",
             "        mma16816(o[2 * np], a, vb[0], vb[1]);\n        mma16816(o[2 * np + 1], a, vb[2], vb[3]);"]
_K10Q_CONVERT = """        *reinterpret_cast<uint4*>(smem + L::oC + swz<R>(r, 2 * ch)) = codes_bf16(w.x, w.y);
        *reinterpret_cast<uint4*>(smem + L::oC + swz<R>(r, 2 * ch + 1)) = codes_bf16(w.z, w.w);"""
_K10Q_WAIT = "      cp_async_wait1();  // this thread's copies of tile it (and q) landed\n"
_K10_WAIT = "      cp_async_wait_all();  // this thread's copies of tile it (and q) landed\n"
_K4Q_QUANT = "  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);"
_K4Q_PDL = "  attr[0].val.programmaticStreamSerializationAllowed = 1;"
_K14_PDL = "  attr[0].val.programmaticStreamSerializationAllowed = 1;"
_K14_SMEM = "constexpr size_t kSmemBytes = Layout::kBytes;"
# K14's three GEMM phases, and the block's work list made at its start
_K14_CALLS = [
    "  tail_phase<kNone, kEpiResid>(a, 0, a.ao, a.w[0].K, nullptr, smem, items, prod, k, base, "
    "stile,\n                               red, last);",
    "  tail_phase<kRmsNorm, kEpiStore>(a, 1, a.h, a.D, rstd, smem, items, prod, k, base, stile, "
    "red,\n                                  last);",
    "  tail_phase<kSiluGlu, kEpiOut>(a, 2, a.gub, 2 * a.w[2].K, nullptr, smem, items, prod, k, "
    "base,\n                                stile, red, last);"]
_K14_LIST = "  for (int q = 0; q < kPhases; ++q) {"


def _k14_only(p):
    """K14 with GEMM p's items alone (the other phases' calls cut, their
    items never listed, no stage issued before a phase starts)."""
    return [("constexpr int kAhead = 2;", "constexpr int kAhead = 0;"),
            (_K14_LIST, f"  for (int q = {p}; q <= {p}; ++q) {{")] + [
        (c, "") for q, c in enumerate(_K14_CALLS) if q != p]

_K14_MMA = ("      qwg::Wgmma<8>::mma(dot, a[j], qwg::desc_b(xb + (j >> 2) * 1024 + (j & 3) * 32), "
            "j > 0);")
_K12_MMA = "  for (int s = 0; s < 4; ++s) WgmmaS8<W>::mma(d, a[s], desc_b(xb + s * 32), s > 0);"

#: name -> (kernel, file, [(text, replacement)], {(module, attribute): value}
#: set while the cut version runs)
VARIANTS = {
    "K1d pingpong": (qm.KERNEL, "qmm_decode_rows.cuh", [
        (_K1D_LOOP, _K1D_PINGPONG),
        ("constexpr int kXStages = 2;", "constexpr int kXStages = 3;")]),
    "K1 no_mma": (qm.KERNEL, "qmm_wgmma.cuh",
                  [(_K1_MMA, "      dot[j] += __uint_as_float(a[j][0] ^ a[j][3]);")]),
    "K1 no_fold": (qm.KERNEL, "qmm_wgmma.cuh", [(_K1_FOLD, """      acc[4 * i + 0] += dot[4 * i + 0];
      acc[4 * i + 1] += dot[4 * i + 1];
      acc[4 * i + 2] += dot[4 * i + 2];
      acc[4 * i + 3] += dot[4 * i + 3];""")]),
    "K1 no_build": (qm.KERNEL, "qmm_wgmma.cuh", [(_K1_BUILD, "      a[j][0] = w[0][0] + j; "
                                                  "a[j][1] = w[0][1]; a[j][2] = w[2][0]; "
                                                  "a[j][3] = w[2][1];")]),
    "K9 no_mma": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [
        (_K9_MMA, "      acc[j % kNR] += __uint_as_float(a[j][0] ^ a[j][3]);")]),
    "K9 no_dequant": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [(_K9_DEQUANT, "  return (lo >> sh) ^ hi;")]),
    "K9 no_merge": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh",
                    [(_K9_MERGE, "    return;\n" + _K9_MERGE)]),
    "K9 fence_all": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", _K9_FENCES),
    "K9 no_pdl": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [(_K9_PDL, _K9_PDL.replace("= 1", "= 0"))]),
    "K9 fill_0": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [], {(qm, "DQ_FILL_STAGES"): 0}),
    "K9 max_splits_4": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [], {(qm, "DQ_MAX_SPLITS"): 4}),
    "K9 max_splits_8": (qm.KERNEL_DEQUANT, "qmm_wgmma_dq.cuh", [], {(qm, "DQ_MAX_SPLITS"): 8}),
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
    "K6q no_convert": (pa.KERNEL_INT8, "paged_chunk.cuh", [
        (_K6Q_CONVERT, "        kb[0] = k4.x ^ v4.y;  // read, never converted")]),
    "K5q every_split": (pa.KERNEL_INT8, "paged_decode.cuh", [(_K5Q_LIVE, "    (void)first;")]),
    "K5q no_mma": (pa.KERNEL_INT8, "paged_decode.cuh", [(m, "") for m in _K5Q_MMA]),
    "K5q no_convert": (pa.KERNEL_INT8, "paged_decode.cuh", [(_K5Q_CONVERT, "      dst[0] = w.x ^ w.w;")]),
    "K5q no_wait": (pa.KERNEL_INT8, "paged_decode.cuh", [(_K5Q_WAIT, "")]),
    "K10q no_mma": (ml.KERNEL, "mla_paged_attention.cu", [(m, "") for m in _K10Q_MMA]),
    "K10q no_convert": (ml.KERNEL, "mla_paged_attention.cu", [(_K10Q_CONVERT, "      smem[L::oC] = w.x ^ w.w;")]),
    "K10q no_wait": (ml.KERNEL, "mla_paged_attention.cu", [(_K10Q_WAIT, "")]),
    "K10 no_mma": (ml.KERNEL, "mla_paged_attention.cu", [(m, "") for m in _K10Q_MMA]),
    "K10 no_wait": (ml.KERNEL, "mla_paged_attention.cu", [(_K10_WAIT, "")]),
    "K4q no_divide": (pw.KERNEL_INT8, "paged_write_rows.cuh", [(_K4Q_QUANT, _K4Q_QUANT.replace("x / scale", "x * scale"))]),
    "K4q no_pdl": (pw.KERNEL_INT8, "paged_write_rows.cuh", [(_K4Q_PDL, _K4Q_PDL.replace("= 1", "= 0"))]),
    "K4q scalar": (pw.KERNEL_INT8, "paged_write_int8.cu", [], {(pw, "WRITE_MAX_UNITS"): 0}),
    "K4q lanes_64": (pw.KERNEL_INT8, "paged_write_int8.cu", [], {(pw, "WRITE_LANES"): 64}),
    "K4q lanes_1024": (pw.KERNEL_INT8, "paged_write_int8.cu", [], {(pw, "WRITE_LANES"): 1024}),
    "K4 no_pdl": (pw.KERNEL, "paged_write.cu", [], {(pw, "WRITE_PDL"): False}),
    "K4 scalar": (pw.KERNEL, "paged_write.cu", [], {(pw, "WRITE_MAX_UNITS"): 0}),
    "K4 lanes_64": (pw.KERNEL, "paged_write.cu", [], {(pw, "WRITE_LANES"): 64}),
    "K4 lanes_1024": (pw.KERNEL, "paged_write.cu", [], {(pw, "WRITE_LANES"): 1024}),
    "K14 drain": (ft.KERNEL, "fused_layer_tail.cu", [
        ("constexpr int kAhead = 2;", "constexpr int kAhead = 0;")]),
    "K14 no_pdl": (ft.KERNEL, "fused_layer_tail.cu", [(_K14_PDL, _K14_PDL.replace("= 1", "= 0"))]),
    "K14 one_block": (ft.KERNEL, "fused_layer_tail.cu", [
        (_K14_SMEM, _K14_SMEM.replace(";", " + 120 * 1024;"))]),
    "K14 no_merge": (ft.KERNEL, "fused_layer_tail.cu", [
        ("    if (last) {\n", "    if (false) {\n")]),
    "K14 no_barrier": (ft.KERNEL, "fused_layer_tail.cu", [
        ("  grid_barrier(a.bar);", "  __syncthreads();")]),
    "K14 no_mma": (ft.KERNEL, "qmm_decode_rows.cuh", [(_K14_MMA, "      dot[j & 3] += __uint_as_float(a[j][0] ^ a[j][3]);")]),
    "K14 empty": (ft.KERNEL, "fused_layer_tail.cu", [
        ("    if (!list_items(a, items, prod)) __trap();",
         "    if (!list_items(a, items, prod)) __trap();\n    prod.items = 0;")] + [
        (c, "") for c in _K14_CALLS]),
    "K14 o_only": (ft.KERNEL, "fused_layer_tail.cu", _k14_only(0)),
    "K14 gate_up_only": (ft.KERNEL, "fused_layer_tail.cu", _k14_only(1)),
    "K14 down_only": (ft.KERNEL, "fused_layer_tail.cu", _k14_only(2)),
    "K13 scalar": (nm.KERNEL, "rms_norm.cu", [], {(nm, "NORM_MAX_UNITS"): 0}),
    "K13 no_pdl": (nm.KERNEL, "rms_norm.cu", [], {(nm, "NORM_PDL"): False}),
    "K13 block_a_row": (nm.KERNEL, "rms_norm.cu", [], {(nm, "NORM_MAX_ROWS"): 1}),

    "K5q k5_plan": (pa.KERNEL_INT8, "paged_decode.cuh", [], {(pa, "INT8_DECODE_MAX_TILES"): 16}),
    "K5q max_tiles_2": (pa.KERNEL_INT8, "paged_decode.cuh", [], {(pa, "INT8_DECODE_MAX_TILES"): 2}),
    "K5q max_tiles_8": (pa.KERNEL_INT8, "paged_decode.cuh", [], {(pa, "INT8_DECODE_MAX_TILES"): 8}),
}


def build(name: str, kernel, file: str, edits, root: Path):
    """Copy csrc/ into root/<name>, apply the edits (text -> replacement;
    a (start, end) pair of texts replaces what lies from start up to end),
    build the kernel's source; returns the loaded library."""
    d = root / name.replace(" ", "_")
    shutil.copytree(CSRC, d)
    text = (d / file).read_text()
    for old, new in edits:
        if isinstance(old, tuple):
            i, j = text.find(old[0]), text.find(old[1])
            if i < 0 or j < i:
                raise SystemExit(f"{name}: the span to cut is not in {file} any more")
            text = text[:i] + new + text[j:]
            continue
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
    ap.add_argument("--only", nargs="*",
                    help="kernels to cut (K1d, K1, K9, K11f, K8, K12, K2, K6q, K5q, K10q, K10, "
                         "K4q, K4, K14, K13); all "
                         "by default")
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

    # K1's decode rows at M = 4 on the Mistral-7B projections, with the path's prologues
    nw = torch.ones(4096, device=dev, dtype=torch.bfloat16)
    decode1 = {}
    for name, K, N, kw in (("qkv norm", 4096, 6144, dict(norm_weight=nw)), ("o", 4096, 4096, {}),
                           ("gate_up norm", 4096, 28672, dict(norm_weight=nw)),
                           ("down glu", 14336, 4096, dict(glu=True))):
        x = torch.randn((4, 2 * K if kw.get("glu") else K), generator=gen, device=dev)
        decode1[name] = (x.to(torch.bfloat16), cs.rand_qlinear(gen, dev, K, N, 2), kw)
    dq = cs.rand_qlinear(gen, dev, 4096, 28672, 2, group=32)
    x4 = torch.randn((4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    dq4 = {f"{name} M=4": (x4[:, :K].contiguous(), cs.rand_qlinear(gen, dev, K, N, 2, group=G), G)
           for name, K, N, G in (("gate_up G=32", 4096, 28672, 32), ("qkv G=32", 4096, 6144, 32),
                                 ("DS q", 2048, 3072, 64), ("DS kv_a", 2048, 576, 64),
                                 ("DS shared gate_up", 2048, 5632, 64))}
    chunk6q = decode5q = None  # K6q / K5q: the INT8 Engine's chunk and decode, 32 layers
    if not args.only or "K6q" in args.only or "K5q" in args.only:
        from quick_tpu_torch import ModelConfig

        g = cs.paged_geometry(ModelConfig(**cs.MISTRAL_7B), cs.ENGINE_INT8)
        lens, starts = cs.trace_positions(cs.serve_bench_trace(32000), g)
        pool = cs.int8_pool(gen, dev, g, 32)
        q = torch.randn((g["Bp"], g["S"], g["Hq"], g["D"]), generator=gen, device=dev)
        chunk6q = (q.to(torch.bfloat16), *pool, cs.block_table(gen, dev, g, g["Bp"]),
                   torch.tensor(starts, dtype=torch.int32, device=dev))
        q = torch.randn((g["B"], g["Hq"], g["D"]), generator=gen, device=dev)
        decode5q = (q.to(torch.bfloat16), *pool, cs.block_table(gen, dev, g, g["B"]),
                    torch.tensor(lens, dtype=torch.int32, device=dev))
    decode10 = {}  # K10 / K10q: the DeepSeek-V2-Lite Engines' decode, 27 layers
    want10 = [k for k in ("K10", "K10q") if not args.only or k in args.only]
    if want10:
        from quick_tpu_torch import ModelConfig
        from quick_tpu_torch.modules.mla import mla_softmax_scale

        ds = ModelConfig.from_hf_config(cs.DEEPSEEK_V2_LITE)
        g = cs.paged_geometry(ds)
        lens, _ = cs.trace_positions(cs.serving_trace(ds.vocab_size), g)
        q = [torch.randn((g["B"], ds.num_attention_heads, w), generator=gen, device=dev)
             .to(torch.bfloat16) for w in (ds.kv_lora_rank, ds.qk_rope_head_dim)]
        for k in want10:
            pool = cs.mla_pool(gen, dev, ds.num_hidden_layers, g["P"], g["page"],
                               (ds.qk_rope_head_dim, ds.kv_lora_rank), k == "K10q")
            decode10[k] = (*q, pool[0], pool[1], cs.block_table(gen, dev, g, g["B"]),
                           torch.tensor(lens, dtype=torch.int32, device=dev), pool[2],
                           ds.num_hidden_layers, mla_softmax_scale(ds))
    # K4q: the INT8 Engine's decode and chunk, DeepSeek's latent planes; K4:
    # the bf16 Engine's decode and chunk, the latent planes
    writes4q, graph4q, writes4, graph4 = {}, None, {}, None
    if not args.only or "K4" in args.only:
        from quick_tpu_torch import ModelConfig

        for name, cfg4, dk, dv in (("", ModelConfig(**cs.MISTRAL_7B), None, None),
                                   ("latent ", ModelConfig.from_hf_config(cs.DEEPSEEK_V2_LITE),
                                    64, 512)):
            g = cs.paged_geometry(cfg4)
            dec, starts = cs.trace_positions(cs.serving_trace(cfg4.vocab_size), g)
            Hkv = 1 if dk else g["Hkv"]
            dk, dv = dk or g["D"], dv or g["D"]
            L = cfg4.num_hidden_layers
            pool = [torch.zeros((L, g["P"], Hkv, g["page"], d), dtype=torch.bfloat16, device=dev)
                    for d in (dk, dv)]
            bt = cs.block_table(gen, dev, g, g["B"]).long()
            for entry, n, pos in (("decode", 1, dec), ("chunk", g["S"], starts)):
                pids, offs = cs.span_addresses(bt, g, pos, n)
                if entry == "decode":
                    pids = pids[:, :1].contiguous()  # the kernel alone: no copy in the call
                rows = [torch.randn((len(pos), n, Hkv, d), generator=gen, device=dev)
                        .to(torch.bfloat16) for d in (dk, dv)]
                vt = torch.full((len(pos),), n, dtype=torch.int32, device=dev)
                writes4[f"{name}{entry} B={len(pos)}"] = (pool, rows, pids, offs, vt, entry, L)
        graph4 = (torch.randn((16, 4096), generator=gen, device=dev).to(torch.bfloat16),
                  cs.rand_qlinear(gen, dev, 4096, 6144)[0])
    if not args.only or "K4q" in args.only:
        from quick_tpu_torch import ModelConfig

        for name, cfg4, engine, dk, dv in (
                ("", ModelConfig(**cs.MISTRAL_7B), cs.ENGINE_INT8, None, None),
                ("latent ", ModelConfig.from_hf_config(cs.DEEPSEEK_V2_LITE), cs.ENGINE, 64, 512)):
            g = cs.paged_geometry(cfg4, engine)
            dec, starts = cs.trace_positions(cs.serve_bench_trace(cfg4.vocab_size), g)
            Hkv = 1 if dk else g["Hkv"]
            dk, dv = dk or g["D"], dv or g["D"]
            L = cfg4.num_hidden_layers
            pool = [torch.zeros((L, g["P"], Hkv, g["page"], d), dtype=torch.int8, device=dev)
                    for d in (dk, dv)]
            pool.append(torch.zeros((L, g["P"], 8, Hkv * g["page"]), device=dev))
            bt = cs.block_table(gen, dev, g, g["B"]).long()
            for entry, n, pos in (("decode", 1, dec), ("chunk", g["S"], starts)):
                pids, offs = cs.span_addresses(bt, g, pos, n)
                if entry == "decode":
                    pids = pids[:, :1].contiguous()  # the kernel alone: no copy in the call
                rows = [torch.randn((len(pos), n, Hkv, d), generator=gen, device=dev)
                        .to(torch.bfloat16) for d in (dk, dv)]
                vt = torch.full((len(pos),), n, dtype=torch.int32, device=dev)
                writes4q[f"{name}{entry} B={len(pos)}"] = (pool, rows, pids, offs, vt, entry, L)
        # the INT8 Engine's decode writes in a captured step: each layer's qkv
        # projection (K1, M = 64), then its K4q launch
        graph4q = (torch.randn((64, 4096), generator=gen, device=dev).to(torch.bfloat16),
                   cs.rand_qlinear(gen, dev, 4096, 6144)[0])
    tail = {}  # K14: M -> its arguments with each of two weight copies (Mistral-7B widths)
    if not args.only or "K14" in args.only:
        ws = [cs.rand_qlinear(gen, dev, K, N, copies=2)
              for K, N in ((4096, 4096), (4096, 28672), (14336, 4096))]
        nw = (1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(torch.bfloat16)
        for M in (1, 4, 8):
            ao, xr = (torch.randn((M, 4096), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(2))
            tail[M] = [(ao, xr, nw, *ws[0][c], *ws[1][c], *ws[2][c]) for c in range(2)]
    norm13 = {}  # K13: chip_smoke's shapes (K13_CASES), and [K13, K1 at M = 16] x 32
    if not args.only or "K13" in args.only:
        for _, M, D, ld in cs.K13_CASES:
            base = torch.randn((M, ld or D), generator=gen, device=dev).to(torch.bfloat16)
            w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
            norm13[f"M={M} D={D}{f' ld={ld}' if ld else ''}"] = (base[:, :D], w)
        norm13["graph"] = (torch.randn((16, 4096), generator=gen, device=dev).to(torch.bfloat16),
                           norm13["M=16 D=4096"][1], cs.rand_qlinear(gen, dev, 4096, 6144)[0])
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

    def times(kernel, group):
        if group == "K1d":
            return {f"{name} M=4": cs.device_ms(
                lambda i, c=c: qm.quantized_matmul_cuda(c[0], *c[1][i % 2], **c[2]), 100)
                for name, c in decode1.items()}
        if kernel is qm.KERNEL:
            return {f"gate_up M={M}": cs.device_ms(
                lambda i, x=x, ws=ws: qm.quantized_matmul_cuda(x, *ws[i % 2]), 10)
                for M, (x, ws) in gemms.items()}
        if kernel is qm.KERNEL_DEQUANT:
            out = {f"gate_up G=32 M={M}": cs.device_ms(
                lambda i, x=x: qm.quantized_matmul_dequant_cuda(x, *dq[i % 2], 32), 10)
                for M, (x, _) in gemms.items() if M <= 512}
            out.update({name: cs.device_ms(
                lambda i, c=c: qm.quantized_matmul_dequant_cuda(c[0], *c[1][i % 2], c[2]), 100)
                for name, c in dq4.items()})
            return out
        if kernel is gm.KERNEL:
            return {name: cs.device_ms(lambda i, c=c: gm.quantized_matmul_grouped_cuda(
                c[0], *c[1][i % 2], c[2], c[3], c[4]), 20) for name, c in moe.items()}
        if kernel is gm.KERNEL_A8:
            return {name: cs.device_ms(lambda i, c=c: gm.launch_grouped_a8(
                *c[0], *c[1][i % 2], c[2], c[3], c[4]), 20) for name, c in moe_a8.items()}
        if group in ("K10", "K10q"):
            qc, qp, kpe, c, bt, ln, tiles, L, scale = decode10[group]
            return {f"{group} decode B=16": cs.device_ms(
                lambda i: ml.mla_paged_decode_attention_cuda(qc, qp, kpe, c, bt, ln, i % L, scale,
                                                             tiles), 50)}
        if group in ("K4q", "K4"):
            writes, (x, wq), dec = ((writes4q, graph4q, "decode B=64") if group == "K4q" else
                                    (writes4, graph4, "decode B=16"))

            def write(i, w):
                pool, rows, pids, offs, vt, entry, L = w
                tiles = dict(kv_scales=pool[2]) if group == "K4q" else {}
                if entry == "decode":
                    pw.paged_write_decode(*pool[:2], rows[0][:, 0], rows[1][:, 0], pids[:, 0],
                                          offs, i % L, **tiles)
                else:
                    pw.paged_write_chunk(*pool[:2], *rows, pids, offs, vt, i % L, **tiles)
            out = {name: cs.device_ms(lambda i, w=w: write(i, w), 200)
                   for name, w in writes.items()}
            L = writes[dec][-1]

            def step():
                for layer in range(L):
                    qm.quantized_matmul_cuda(x, *wq)
                    write(layer, writes[dec])
            step()  # eager: makes any counters
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            out[f"graph {L} x (K1 qkv M={x.shape[0]}, {group} {dec})"] = cs.device_ms(
                lambda i: graph.replay(), 20)
            return out
        if group == "K14":
            return {f"K14 M={M}": cs.device_ms(
                lambda i, a=a: ft.fused_layer_tail_cuda(*a[i % 2], eps=1e-5), 50)
                for M, a in tail.items()}
        if group == "K13":
            out = {f"K13 {name}": cs.device_ms(
                lambda i, c=c: nm.rms_norm_cuda(c[0], c[1], 1e-5), 200)
                for name, c in norm13.items() if name != "graph"}
            x, w, wq = norm13["graph"]

            def step():
                for _ in range(32):
                    qm.quantized_matmul_cuda(nm.rms_norm_cuda(x, w, 1e-5), *wq)
            step()  # eager: makes any counters
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            out["graph 32 x (K13 M=16, K1 qkv M=16)"] = cs.device_ms(lambda i: graph.replay(), 20)
            return out
        if group == "K5q":
            q, kp, vp, tiles, bt, ln = decode5q
            return {"K5q decode B=64": cs.device_ms(lambda i: pa.paged_decode_attention_int8_cuda(
                q, kp, vp, tiles, bt, ln, i % 32, 128 ** -0.5), 50)}
        if kernel is pa.KERNEL_INT8:
            q, kp, vp, tiles, bt, st = chunk6q
            return {"K6q chunk B=8 S=16": cs.device_ms(lambda i: pa.paged_chunk_attention_int8_cuda(
                q, kp, vp, tiles, bt, st, i % 32, 128 ** -0.5), 50)}
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
                res.append(times(kernel, name.split()[0]))
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
