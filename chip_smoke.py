#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (quick_tpu_torch) runs on an NVIDIA
card. Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels K1-K14, K4q,
     K5q / K6q, K10q and K11f from csrc/ (one nvcc per source, in parallel)
     and print ptxas' register summary and warnings;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the main paths, in bf16, with the tolerance stated (K1 at
     every decode row count, M = 1-8, with each prologue, and at N % 4 ==
     2, timed beside N - 2: the cost of padding N; K3 at B=4, 1 and 8 and
     at S = 1,536, lengths 0 to S - 1; K4 byte-equal over bf16 and f32
     pages and on its scalar path); (2c) the dense-dequant route of
     QUICK_TPU_DENSE_M (torch ops, no kernel of its own) against its plain
     version, and timed beside K1 at M = 128, 512, 4096: the crossover;
  3. each kernel's time (CUDA events over many launches queued behind a
     device sleep, weights and KV pages rotated past the 50 MB L2), its
     bound from bytes and operations, its plain version's time and a
     one-call PyTorch yardstick where one exists; K4 in a captured graph of
     32 x (K1, K4) with and without its programmatic dependent launch;
  4. the generate() path: AutoQuickModel at Mistral-7B width, 32 layers,
     random QTPU weights from a seed, 4 prompts of 128 tokens plus 64
     greedy tokens; the kernels' launch counts must be exactly those of
     the path; (4b) generate() at K3's other timed shapes (B=8; B=4 with
     1,496-token prompts in a 1,536-token cache), counted, and the graphed
     B=4 decode with K3 beside the same decode under
     QUICK_TPU_FUSED_STEP=0 (K7), in turns, each run's greedy tokens equal;
  5. the serving path: the continuous-batching Engine over the paged KV
     cache, the same model's first ENGINE_LAYERS layers, 32 ShareGPT-like
     requests that share a one-page
     system prefix; a warm-up run (no host sync allowed while a decode
     window or prefill sub-batch is dispatched; a few decode windows
     profiled) and a timed run; every request at its exact length, the
     same greedy streams in both runs, launch counts exactly those the
     Engine's recorded schedule implies; then one more run, untimed and
     uncounted, under QUICK_TPU_ENGINE_TIMING=1: the host seconds of each
     phase of the Engine's turns (Engine.timing);
  6. the kernel path against the plain path (on the CPU) for a 2-layer
     model at full width: dense cache (prefill logits, 4 decode steps), at
     B=4 through K3 and at B=16 with max_seq 512 through K7, and paged
     cache (one 16-token chunk for 4 slots at different starts, 4 decode
     steps);
  7. the checkpoint path: the phase-4 weights saved with save_quantized
     under build/, loaded with AutoQuickModel.from_quantized and compared
     byte for byte, then the 128/128 protocol of examples/benchmark.py
     (quick_tpu_torch.examples.benchmark.run_round) at B=32 and B=64 (one
     timed trial each) and one long-context stream (B=4, ~1,900 tokens of
     context); launch counts
     exactly those of the calls made, identical greedy tokens in every
     timed run; the checkpoint is deleted afterwards;
  8. the MoE path: K8 (grouped expert GEMM) against its plain version and
     timed at the routed shapes of Mixtral-8x7B and Qwen1.5-MoE-A2.7B; then
     Mixtral-8x7B at full width and depth (random QTPU weights, seed 0)
     through generate() (as phase 4) and, at MOE_ENGINE_LAYERS layers of
     full width, the Engine (as phase 5), a 2-layer checkpoint round trip,
     the kernel path against the plain path for 2-layer Mixtral and
     Qwen1.5-MoE models (a token routed differently must have had a router
     gap under ROUTE_GAP), and Qwen1.5-MoE's generate() at full depth;
     launch counts exactly those of each path;
  9. INT8 KV pages: (a) K4q (decode and chunk writes, codes and scale tiles
     byte-equal; every input kind, rows of zeros and of exact halves, and
     the scalar path for rows off 16 bytes or of no whole unit), K5q and
     K6q (within tol, K5q also row-scaled) against their plain versions
     at the INT8 Engine's shapes, K5q also at pages of 16 and 256 keys,
     with window, softcap and ALiBi, on a skewed batch
     (one slot at the whole 1,024-key table, so that its splits merge) and
     captured in a CUDA graph replayed after the lengths moved; (b) their times,
     bounds and yardsticks; (c) the Engine over INT8 pages, as phase 5, on
     tools/serve_bench.py's INT8 command (128 requests, 64 slots; the
     first ENGINE_LAYERS layers); (d) the
     2-layer full-width check over INT8 pages, as phase 6's paged one,
     with the written codes and scale tiles held to the CPU scatter's;
 10. small-group W4A16: (a) K9 (small-group GEMM) against its plain version
     (at the g=32 shapes at every decode row count, M = 1-8, one 8-token
     wgmma tile) and timed at the g=32 Mistral-7B shapes (M = 1 and 4 the
     decode rows) and Qwen1.5-MoE's g=64
     attention and shared-expert shapes, K8 at G=64 at Qwen1.5-MoE's
     routed shapes; (b) a Q4_K GGUF file at Mistral-7B width (GGUF_LAYERS
     layers) written under build/ by the test writer (tests/_torch_port.py),
     loaded onto the card
     with AutoQuickModel.from_gguf (tensors byte-equal to the CPU decode),
     generate() as phase 4 and the 128/128 protocol at B=1, then deleted;
     (c) Qwen1.5-MoE at full width with g=64 weights through generate();
     (d) 2-layer full-width checks of both models, as phases 6 and 8, with
     K9's plain version on the CPU side;
 11. DeepSeek-V2-Lite (MLA with DeepSeekMoE, g=64, the published widths,
     27 layers): (a) K10 / K10q (paged MLA decode) at the Engine's decode,
     both also at DeepSeek-V3's 128 heads (8 head groups) and at 20 (a
     partial group), K10 also over pages of 48 tokens,
     K4 / K4q on the latent planes (byte-equal; K4q at every input kind), K2 at q / k 192, v 128, K9
     and K8 at its shapes, against their plain versions; (b) their times,
     bounds and yardsticks; (c) generate() at full width and depth, as
     phase 4 (random weights, seed 0; an untied bf16 head); (d) the Engine
     over bf16, then INT8 latent pages at 4 of its 27 layers
     (``--depth-costs`` runs them at 27) on phase 5's trace, one sync-checked, profiled, counted
     and timed run each, the INT8 pool 0.528x the bf16 pool; (e) a 2-layer checkpoint round
     trip, and the
     2-layer kernel path against the plain path for generate() and for
     the paged path over bf16 and INT8 pages, with phase 8's routing rule;
 12. W4A8 and the standalone RMSNorm: (a) K11 and K11f (W4A8 GEMM) at the
     Mistral-7B projections (M = 512, 128 and a ragged 200; K11f equal to
     K11 bit for bit) and K11 at DeepSeek-V2-Lite's g=64 shapes, K12
     (grouped W4A8) at Mixtral-8x7B's decode and prefill and at bm = 96
     (QUICK_TPU_MOE_BM's 32-row sub-tiles; also timed, with its bound and
     torch._grouped_mm), K13 (RMSNorm) at
     the paths' shapes and on the strided latent slice, each against its
     plain version; (b) their times,
     bounds and yardsticks, K13 in a captured graph of 32 x (K13, K1 at M =
     16) with and without its programmatic dependent launch, and the aten
     calls per layer and busy share of
     the norms as K13 and as plain torch ops in the same call (Mistral's
     Engine, DeepSeek-V2-Lite's decode and bf16 Engine); (c)
     phase 4's model through generate() under QUICK_TPU_A8=1, then with
     QUICK_TPU_A8_FUSED=1 added; (d) phase 8's Mixtral-8x7B through
     generate() under QUICK_TPU_A8=1 QUICK_TPU_MOE_A8=1; (e) the INT8 Engine
     of phase 9c under QUICK_TPU_A8=1 at A8_ENGINE_LAYERS layers; (f) the
     2-layer full-width kernel path against the plain path under A8
     (dense, and Mixtral with MOE_A8);
 13. the decode layer tail and the decode step as one CUDA graph: (a) K14
     at Mistral-7B width and M = 1-8 against its plain version, timed
     beside the unfused K1 chain and three torch.matmul on bf16 weights;
     (b) phase 4's generate() under QUICK_TPU_LAYER_TAIL=1, its graphed
     step's device ms printed beside phase 4's; (c) phase 6's
     dense (K3) and paged checks under the switch; (d) graphed against
     eager decode: every generate() path compares its eager loop's tokens
     with the graphed one's (phases 4, 8, 10, 11, 12c, 13b), B=32 decode
     through K7, and the Engines (Mistral width over bf16 and INT8 pages,
     Mixtral, DeepSeek-V2-Lite over bf16 and INT8 latent pages) at
     ENGINE_AB_LAYERS layers with graphed and with eager windows: the same
     streams and launch counts; (e) penalised greedy generate() at 2
     layers, graphed against eager, then against the plain path;
 14. beam search: (a) beam_generate() at Mistral-7B width and depth on
     phase 4's weights, 128-token prompts, 32 new tokens and an EOS token,
     at B=2 x 4 beams (K3) and B=4 x 4 (K7): exact launch counts, graphed
     and eager searches equal, ms a step of each and the beam reorder's
     share; (b) at 2 layers, the kernel path against the plain path;
 15. the Engine under enable_penalties=True on phase 5's trace and model
     (half the requests penalised, a quarter with a logit_bias): as phase 5
     (counted, timed, beside phase 5's run), its greedy windows replayed,
     then graphed against eager windows over bf16 and INT8 pages;
 16. AWQ: (a) AutoQuickModel.quantize(calib) at Mistral-7B width, 4 of 32
     layers (random float weights, 8 embedding channels x 8), 32 x 512
     synthetic calibration tokens: K2 and K13 at their exact counts, each
     block's seconds, the peak memory; (b) each block's search again on the
     plain route (QUICK_TPU_FLASH=0, plain norms) from the same input: scale
     picks, clip-pick agreement, the packed codes before the first moved
     pick, x_next with the kernel route's clips imposed; (c) the float, RTN
     and AWQ models scored on 4 held-out windows of 512 (evaluate_perplexity,
     eval_kl_divergence: K1, K2, K13), KL_AWQ < 2.5 x KL_RTN; (d) one block
     each of Mixtral-8x7B and DeepSeek-V2-Lite (layer 1's shapes, g=64) at
     full width, timed, the packed block's forward (K8, K9) against the
     plain path on the CPU;
 17. Qwen3 (per-head q / k RMSNorm on K13): (a) K1 at Qwen3-8B's four
     projections and K13 at its qk-norm shapes held and timed (and the copy
     the qk-norm's column slices take), then Qwen3-8B at full width and
     depth (random g=128 QTPU weights and q / k norms, an untied bf16 head)
     through generate() as phase 4; (b) 2-layer dense and paged checks as
     phase 6, K13's launches exact; (c) eval_mmlu on 8 synthetic 4-choice
     rows at full depth, timed, and a 2-layer model's per-choice scores
     against the plain route on the CPU; (d) eval_humaneval on two
     hand-written problems, generate() on the card, pass@1 0.5 and pass@2
     1.0 by construction; (e) K8 at Qwen3-30B-A3B's 128 experts held and
     timed, 2 layers of it against the plain path with phase 8's routing
     rule; (f) one Qwen3-8B block of AWQ through quantize(calib) on phase
     16's calibration, against the plain route as 16b.
     On the card generate()'s decode loop and the Engine's greedy windows
     replay a captured step; a replay adds the launches counted at capture.
     Launch counts exact throughout, K13's in every phase.
 18. the RMSNorm families off the llama path (random g=128 QTPU weights, every
     norm weight random): (a) K1 at Gemma2-9B's four projections, K2 / K3
     at head_dim 256 with softcap 50 and K13 at its post-norm shapes held
     and timed, then Gemma2-9B at full width and depth through generate()
     as phase 4 (K13's post-norm launches exact); (b) one 4,400-token
     stream in a 4,608-token cache at full depth (K2 with the 4,096 window
     and softcap 50 on the sliding layers, K7 on the global ones, both held
     and timed at its shapes), then 2-layer dense (the 4,400-token prompt)
     and paged (a 16-token chunk at 4,400 over random context, K4-K6 with
     the window) checks against the plain path on the CPU; (c) Gemma3-12B
     as (a) (K13 also at its per-head qk-norm shapes), and a 6-layer check
     (five sliding layers with their local rope tables, one global) dense
     (B = 1, a 1,280-token prompt, 1,536-token cache, 4 steps) and paged,
     held by each row's relative RMS (TOL_DEEP_RMS);
     (d) OLMo-2-7B, Granite-3.1-8B and MiniCPM-2B at 2 layers of full width
     against the plain path (a 64-token prompt: K2 at MiniCPM's head_dim 64
     and K3, held and timed); (e) one Gemma2-9B block of AWQ through
     quantize(calib) on phase 16's calibration, against the plain route
     (x_next by its relative RMS).
The line before the last three is free text; then the kernels' JSON line,
the card line, and last {"ok": true, "device": {...}}.

``python3 chip_smoke.py --depth-costs`` runs, after phase 1, only the
depth-cut phases at full depth and prints their seconds (``depth_costs``);
``python3 chip_smoke.py --phase18`` runs, after phase 1, only phase 18 and
prints its report and kernel rows (a measurement: no kernels line, no
``ok`` line).
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: mistralai/Mistral-7B-v0.1 config.json (tools/e2e_bench.py SHAPES["mistral7b"])
MISTRAL_7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=4096, model_type="mistral",
)
BATCH, PROMPT, NEW_TOKENS, MAX_SEQ = 4, 128, 64, 256
#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 and bf16 tensor
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
L2_BYTES = 50 * 2**20
# kernel vs plain: atol = rtol (|out - ref| <= tol * (1 + |ref|)). Both sum
# in f32 in different orders and round the output to bf16; the attention
# kernels also round p to bf16 against a running rather than final max.
# K7 is also held to tol * max|ref| of each query row (row_scaled_err).
TOL = {"quantized_matmul": 2e-2, "flash_attention": 2e-2, "fused_decode_step": 2e-2,
       "paged_attention": 2e-2, "decode_attention": 2e-2, "grouped_matmul": 2e-2,
       "quantized_matmul_dequant": 2e-2, "mla_paged_attention": 2e-2,
       # W4A8: the same int8 codes and exact integer dots; the f32 sums in
       # other orders, then one bf16 rounding
       "quantized_matmul_a8": 1e-2, "grouped_matmul_a8": 1e-2}
TOL_CACHE = 1e-2   # K3's written k row: one bf16 step (f32 fma contraction)
#: phase 6 logits, 2 layers at full width, bf16 activations: the paths differ
#: by single bf16 steps of the logits, d / (1 + |ref|) <= 2^-7 per step
TOL_MODEL = 1e-2
PHASE6_DECODE = 4  # decode steps after phase 6's prefill or chunk
#: the serving phase: the JAX Engine's defaults (quick_tpu/runtime/
#: serving.py:130-185) with 16 slots of up to 1024 tokens; the default pool
#: is 16 x 16 + 1 = 257 pages of 64 tokens (2.2 GB of bf16 K/V at 32 layers).
#: chunk 16, not 64: supports_chunk(64, 32, 8, 64) is false (25 MB of TPU
#: VMEM temporaries), so a 64-token chunk would never reach the chunk kernel
ENGINE = dict(max_slots=16, max_seq=1024, page_size=64, chunk=16,
              decode_window=8, prefill_rows=8, reserve="full", prefix_cache=True)
N_REQUESTS, SYSTEM_PREFIX = 32, 64
#: phase 9, INT8 KV pages: the JAX package's documented INT8 serving
#: command, tools/serve_bench.py --requests 128 --slots 64 --kv int8 (:11;
#: its defaults :37-44: page 64, max_seq 1024, decode window 16, prefix
#: cache on, no shared prefix; prefill_rows is the Engine's default 8), with
#: chunk 16 for the reason above; 64 x 16 + 1 = 1025 pages
ENGINE_INT8 = dict(max_slots=64, max_seq=1024, page_size=64, chunk=16, decode_window=16,
                   prefill_rows=8, reserve="full", prefix_cache=True, dtype=torch.int8)
INT8_REQUESTS = 128
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor rate (NVIDIA data sheet)
#: phase 9d logits, 2 layers over INT8 pages: the card quantizes q per
#: head and p per (head, page) to int8 (K5q) where the CPU path attends
#: over bf16-dequantized pages, on top of phase 6's bf16 steps
TOL_INT8_MODEL = 2e-2
#: the Mixtral Engine (phase 8) and the Mistral-7B-width Engines (phases 5
#: and 9c) run their first MOE_ENGINE_LAYERS / ENGINE_LAYERS layers of full
#: width, the GGUF file of phase 10b holds GGUF_LAYERS layers and phase
#: 12e's INT8 Engine under A8 runs A8_ENGINE_LAYERS, so that the script
#: keeps room for a slower host within its time limit (on one H100 80GB
#: HBM3 at 700 W, with graphed decode windows, the bf16, INT8 and Mixtral
#: Engines took 38, 72 and 88 s at 32 layers and the 32-layer GGUF phase
#: 51 s, against a 621 s script at these depths; --depth-costs measures
#: them)
MOE_ENGINE_LAYERS = 4
ENGINE_LAYERS = 4
GGUF_LAYERS = 8
A8_ENGINE_LAYERS = 2
#: the checkpoint phase: examples/benchmark.py's 128/128 protocol (:39-79,
#: batches 1,8,32,64,... :87) at B=32 and B=64 (1 timed trial each), and
#: one long-context stream: B=4, a 1,900-token prompt, 8 new tokens in a
#: 2,048-token cache (4 MiB of K/V per row: past the fused step's 3 MiB)
PROTOCOL_CTX, PROTOCOL_GEN = 128, 128
PROTOCOL_ROUNDS = ((32, 1), (64, 1))  # (batch, trials)
LONG_B, LONG_PROMPT, LONG_NEW, LONG_SEQ = 4, 1900, 8, 2048
#: K7 shapes checked and timed (B, T, lengths): the protocol's decode
#: (lengths 129-255), the long stream (~1,900) and ragged rows at B=64
#: (lengths 1 .. 256); each key is launched on the checkpoint path
DENSE_B_T = {"protocol": (32, 256), "long": (LONG_B, LONG_SEQ), "ragged": (64, 256)}
CKPT_DIR = ROOT / "build" / "chip_smoke_checkpoint"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    """Max |out - ref|; fail unless |out - ref| <= tol * (1 + |ref|)."""
    o, r = out.float(), ref.float()
    if o.shape != r.shape or not torch.isfinite(o).all():
        fail(f"{what}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
    d = (o - r).abs()
    worst = float((d - tol * (1 + r.abs())).max())
    err = float(d.max())
    print(f"  {what}: max_abs_err {err:.3e}, max |err| / (1 + |ref|) "
          f"{float((d / (1 + r.abs())).max()):.3e} (tol {tol}), "
          f"max|ref| {float(r.abs().max()):.3e}")
    if worst > 0:
        fail(f"{what}: kernel disagrees with its plain version")
    return err


def row_scaled_err(out: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    """Max |out - ref| / max|ref| over each row (the last dim); fail above
    ``tol``. For outputs far below 1, where tol * (1 + |ref|) is loose: a
    long row's attention output is ~0.03 per element."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    rmax = r.abs().amax(dim=-1, keepdim=True)
    ratio = float(torch.where(d > 0, d / rmax, torch.zeros_like(d)).max())
    print(f"  {what}: max |err| / max|ref of its row| {ratio:.3e} (tol {tol}), "
          f"least row max|ref| {float(rmax.min()):.3e}")
    if not ratio <= tol:  # a row with max|ref| = 0 must match exactly (inf fails)
        fail(f"{what}: kernel disagrees with its plain version, row-scaled")
    return ratio


def device_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of fn(i) over n calls: CUDA events around launches
    queued behind a device sleep, so host dispatch time does not enter."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * (0.005 + n * 3e-4)))  # ~5 ms + 0.3 ms/call
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> tuple:
    """(least ms, "bytes" or "operations"): bytes over the HBM rate, or
    operations over the tensor-core ``rate`` of their type."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# Phase 1: card and build
# ---------------------------------------------------------------------------

def phase1_build():
    from quick_tpu_torch.ops import all_kernels
    from quick_tpu_torch.ops._cuda import build_all

    t0 = time.perf_counter()
    build_all(all_kernels())
    print(f"[1] built {len(all_kernels())} kernels in {time.perf_counter() - t0:.1f} s")
    for k in all_kernels():
        entry = "?"
        for line in k.build_log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)[:72]
            elif "Used" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {k.source} {entry}: {line.split(':', 1)[-1].strip()}")
            elif "warning" in line:  # e.g. ptxas serializing wgmma instructions
                print(f"  {k.source}: {line.strip()[:300]}")


# ---------------------------------------------------------------------------
# Phase 2 / 3: kernels against their plain versions; timing
# ---------------------------------------------------------------------------

def gemm_shapes(cfg):
    D, F = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    return {"qkv": (D, (hq + 2 * hkv) * hd), "o": (hq * hd, D),
            "gate_up": (D, 2 * F), "down": (F, D)}


def main_path_gemms(cfg):
    """(prologue, M, K, N) of every kind of K1 launch on the generate()
    path of a dense model: the four projections at prefill (M = B * S),
    then at decode (M = B) with their prologues (k1_projections)."""
    M0, M1 = BATCH * PROMPT, BATCH
    return ([(None, M0, K, N) for K, N, _ in k1_projections(cfg)]
            + [(pro, M1, K, N) for K, N, pro in k1_projections(cfg)])


def engine_gemms(cfg):
    """(prologue, M, K, N) of the K1 launches of the serving path: the four
    projections at decode windows (M = max_slots, past the 8-row prologue
    limit) and at prefill sub-batches (M = prefill_rows * chunk)."""
    rows = (ENGINE["max_slots"], ENGINE["prefill_rows"] * ENGINE["chunk"])
    return [(None, M, K, N) for M in rows for K, N in gemm_shapes(cfg).values()]


def checkpoint_gemms(cfg):
    """(prologue, M, K, N) of the K1 launches of the checkpoint phase: the
    protocol rounds' prefill (M = B * 128) and decode (M = B, past the
    8-row prologue limit) and the long stream's prefill (M = 4 * 1,900).
    The long stream's decode rows (M = 4, with prologues) are the generate
    path's shapes and rows."""
    Ms = [M for B, _ in PROTOCOL_ROUNDS for M in (B * PROTOCOL_CTX, B)]
    Ms.append(LONG_B * LONG_PROMPT)
    return [(None, M, K, N) for M in Ms for K, N in gemm_shapes(cfg).values()]


def checkpoint_flash_shapes():
    """(B, S, T) of the K2 launches of the checkpoint phase: each protocol
    round's prefill into its 256-token cache, and the long stream's."""
    T = PROTOCOL_CTX + PROTOCOL_GEN
    return [(B, PROTOCOL_CTX, T) for B, _ in PROTOCOL_ROUNDS] + [(LONG_B, LONG_PROMPT, LONG_SEQ)]


def rand_qlinear(gen, dev, K, N, copies=1, group=128):
    """QTPU weights with O(1) outputs: full-range int32 words, scales in
    [0.001, 0.011), integer zero points, one per ``group`` input channels."""
    out = []
    for _ in range(copies):
        qw = torch.randint(-2**31, 2**31, (K // 8, N), generator=gen, device=dev,
                           dtype=torch.int32)
        s = torch.rand((K // group, N), generator=gen, device=dev) * 0.01 + 0.001
        z = torch.round(torch.rand((K // group, N), generator=gen, device=dev) * 15)
        out.append((qw, s, z * s))
    return out


def check_gemm(prologue, M, K, N, gen, dev):
    """K1 at (prologue, M, K, N) on random weights against its plain
    version: (launch key, max |err|, (x, qw, s, zs))."""
    from quick_tpu_torch.ops import quantized_matmul as qm
    from quick_tpu_torch.ops.norms import rms_norm_plain

    (qw, s, zs), = rand_qlinear(gen, dev, K, N)
    x = torch.randn((M, 2 * K if prologue == "glu" else K), generator=gen,
                    device=dev).to(torch.bfloat16)
    nw = (1 + 0.1 * torch.randn(K, generator=gen, device=dev)).to(torch.bfloat16)
    out = qm.quantized_matmul_cuda(
        x, qw, s, zs, norm_weight=nw if prologue == "rmsnorm" else None,
        norm_eps=1e-5, glu=prologue == "glu")
    xp = qm.glu_plain(x) if prologue == "glu" else (
        rms_norm_plain(x, nw, 1e-5) if prologue == "rmsnorm" else x)
    ref = qm.quantized_matmul_plain(xp, qw, s, zs)
    torch.cuda.synchronize()
    key = qm.launch_key(prologue, M, K, N)
    return key, max_err(out, ref, TOL["quantized_matmul"], f"K1 {key}"), (x, qw, s, zs)


def check_gemms(cfg, gen, dev):
    from quick_tpu_torch.ops import quantized_matmul as qm

    print("[2] K1 (W4A16 GEMM) against its plain version, bf16")
    errs = {}
    shapes = list(gemm_shapes(cfg).values())
    cases = [(p, M, K, N) for p in (None, "rmsnorm", "glu") for M in range(1, 9)
             for K, N in shapes]
    cases += [(None, BATCH * PROMPT, K, N) for K, N in shapes] + engine_gemms(cfg)
    cases += checkpoint_gemms(cfg)
    # N % 4 == 2 above 8 rows: the wrapper pads the weight for the tensor copies
    cases += [(None, M, 4096, N) for M in (16, BATCH * PROMPT) for N in (130, 4098)]
    for prologue, M, K, N in cases:
        key, err, (x, qw, s, zs) = check_gemm(prologue, M, K, N, gen, dev)
        errs[key] = err
        if M > 8 and N % 4:  # what the padding costs: beside the width 2 narrower
            w4 = (qw[:, :N - 2].contiguous(), s[:, :N - 2].contiguous(),
                  zs[:, :N - 2].contiguous())
            t = [device_ms(lambda i, w=w: qm.quantized_matmul_cuda(x, *w), 10)
                 for w in ((qw, s, zs), w4)]
            b_ms, b_by = bound(K * N // 2 + 2 * (K // 128) * N * 4 + M * K * 2 + M * N * 2,
                               2.0 * M * K * N)
            # the plain version, and torch.matmul on the bf16 weight (the yardstick)
            plain_ms = device_ms(lambda i: qm.quantized_matmul_plain(x, qw, s, zs), 3, warmup=1)
            codes = qm.unpack_qtpu_tensor(qw).float().reshape(K // 128, 128, N)
            wd = (codes * s[:, None] - zs[:, None]).reshape(K, N).to(torch.bfloat16)
            lib_ms = device_ms(lambda i: torch.matmul(x, wd), 10)
            print(f"    N={N} (padded) {t[0] * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}); "
                  f"N={N - 2} {t[1] * 1e3:.1f} us; plain {plain_ms * 1e3:.1f} us, "
                  f"torch.matmul bf16 {lib_ms * 1e3:.1f} us")
            del wd
    return errs


def time_gemms(cfg, gen, dev, errs, gemms, path):
    """K1's rows at ``gemms``; their launches are read from ``path``'s run
    ("generate" or "engine")."""
    from quick_tpu_torch.ops import quantized_matmul as qm
    from quick_tpu_torch.ops.norms import rms_norm_plain

    print(f"[3] K1 timing at the {path} path's shapes (weights rotated past L2)")
    rows = []
    for prologue, M, K, N in gemms:
        wbytes = K * N // 2 + 2 * (K // 128) * N * 4
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / wbytes)))
        ws = rand_qlinear(gen, dev, K, N, copies)
        x = torch.randn((M, 2 * K if prologue == "glu" else K), generator=gen,
                        device=dev).to(torch.bfloat16)
        nw = torch.ones(K, device=dev, dtype=torch.bfloat16)
        kw = dict(norm_weight=nw if prologue == "rmsnorm" else None,
                  norm_eps=1e-5, glu=prologue == "glu")
        n = 10 if M > 8 else 100

        def kern(i):
            qm.quantized_matmul_cuda(x, *ws[i % copies], **kw)

        def plain(i):
            xp = qm.glu_plain(x) if prologue == "glu" else (
                rms_norm_plain(x, nw, 1e-5) if prologue == "rmsnorm" else x)
            qm.quantized_matmul_plain(xp, *ws[i % copies])

        # yardstick: one torch.matmul on a pre-dequantized bf16 weight
        wd = []
        for qw, s, zs in ws[: max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))]:
            codes = qm.unpack_qtpu_tensor(qw).float().reshape(K // 128, 128, N)
            wd.append((codes * s[:, None] - zs[:, None]).reshape(K, N).to(torch.bfloat16))
        xl = x[:, :K] if prologue == "glu" else x

        def lib(i):
            torch.matmul(xl, wd[i % len(wd)])

        ms = device_ms(kern, n)
        plain_ms = device_ms(plain, 3, warmup=1)
        lib_ms = device_ms(lib, n)
        nbytes = wbytes + M * x.shape[1] * 2 + M * N * 2 + (K * 2 if prologue == "rmsnorm" else 0)
        b_ms, b_by = bound(nbytes, 2.0 * M * K * N)
        key = qm.launch_key(prologue, M, K, N)
        src = {None: 115, "rmsnorm": 160, "glu": 204}[prologue]
        rows.append(dict(
            name=f"quantized_matmul[{key}]", route="cuda",
            source="quick_tpu_torch/csrc/quantized_matmul.cu",
            replaces=f"quick_tpu/ops/quantized_matmul.py:{src}",
            launches=(path, "quantized_matmul", key), max_abs_err=errs[key],
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
        ))
        print(f"  {key}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by {b_by}), "
              f"plain {plain_ms * 1e3:.1f} us, torch.matmul bf16 {lib_ms * 1e3:.1f} us")
        del ws, wd
    return rows


#: rows at which the dense-dequant route (QUICK_TPU_DENSE_M) is timed beside K1
DENSE_ROUTE_ROWS = (128, 512, 4096)


def dense_route_rows(cfg, gen, dev) -> dict:
    """[2c] The dense-dequant route (QUICK_TPU_DENSE_M, off by default):
    torch ops that dequantize the weight to bf16, then one bf16
    torch.matmul; no kernel of the port, so no row in the kernels line. On
    the four projections: the route against its plain version (the f32
    product of the same bf16 values) at M = 128, within TOL; then the route,
    its dequantization alone and K1, each timed at M = 128, 512 and 4096
    (weights rotated past L2), in turns: the measured crossover."""
    from quick_tpu_torch.ops import quantized_matmul as qm

    print("[2c] the dense-dequant route (QUICK_TPU_DENSE_M) against its plain version, "
          "then timed beside K1 (weights rotated past L2)")
    out = {}
    for name, (K, N) in gemm_shapes(cfg).items():
        wbytes = K * N // 2 + 2 * (K // 128) * N * 4
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / wbytes)))
        ws = rand_qlinear(gen, dev, K, N, copies)
        x = torch.randn((DENSE_ROUTE_ROWS[0], K), generator=gen, device=dev).to(torch.bfloat16)
        got = qm.quantized_matmul_dense(x, *ws[0])
        ref = qm.quantized_matmul_dense_plain(x, *ws[0])
        torch.cuda.synchronize()
        err = max_err(got, ref, TOL["quantized_matmul"], f"dense route {name} M={x.shape[0]}")
        dq_ms = device_ms(lambda i: qm.dense_weight(*ws[i % copies], 128), 10)
        for M in DENSE_ROUTE_ROWS:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            t = {"route": [], "k1": []}
            for which in ("route", "k1", "k1", "route"):
                fn = qm.quantized_matmul_dense if which == "route" else qm.quantized_matmul_cuda
                t[which].append(device_ms(lambda i: fn(x, *ws[i % copies]), 10))
            route, k1 = sum(t["route"]) / 2, sum(t["k1"]) / 2
            out[f"{name} M={M} K={K} N={N}"] = dict(route_ms=route, k1_ms=k1,
                                                    dequant_ms=dq_ms, max_abs_err=err)
            print(f"  {name} M={M} K={K} N={N}: route {route * 1e3:.1f} us (its dequantization "
                  f"{dq_ms * 1e3:.1f} us), K1 {k1 * 1e3:.1f} us, route / K1 {route / k1:.3f}")
        del ws
    return out


def attn_inputs(gen, dev, B, S, T, Hq, Hkv, D, Dv=None):
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, T, Dv or D), generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v


def flash_row(cfg, gen, dev, B=BATCH, S=PROMPT, T=MAX_SEQ, path="generate", heads=None,
              tag="2", path_kw=None):
    """K2 against its plain version and timed at a prefill of B x S tokens
    into a T-token cache; ``heads`` (Hq, Hkv, D, Dv) overrides cfg's (MLA's
    expanded prefill: q / k 192, v 128). ``path_kw``: the window and softcap
    the path runs K2 with (gemma2's softcap 50, its bound window), checked
    too and timed (the yardstick, SDPA, takes neither)."""
    import torch.nn.functional as F

    from quick_tpu_torch.ops import flash_attention as fa

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    Hq, Hkv, D, Dv = heads or (Hq, Hkv, D, D)
    path_kw = path_kw or {}
    print(f"[{tag}] K2 (flash attention) against its plain version, B={B} S={S} T={T} "
          f"D={D} Dv={Dv}{f', path {path_kw}' if path_kw else ''}")
    q, k, v = attn_inputs(gen, dev, B, S, T, Hq, Hkv, D, Dv)
    qoff = torch.zeros(B, dtype=torch.int32, device=dev)
    klen = torch.full((B,), S, dtype=torch.int32, device=dev)  # prefill into the cache
    scale = D ** -0.5
    out = fa.flash_attention_cuda(q, k, v, qoff, klen, scale)
    ref = fa.flash_attention_plain(q, k, v, qoff, klen, scale)
    torch.cuda.synchronize()
    err = max_err(out, ref, TOL["flash_attention"], "K2 prefill")
    cases = [("window 48", dict(window=48), None),
             ("softcap 30 + offsets", dict(logit_softcap=30.0), 1)]
    if path_kw:
        cases.append((f"path {path_kw}", path_kw, None))
    for name, kw, r in cases:
        qo = qoff + 40 if r else qoff
        kl = klen + 40 if r else klen
        e = max_err(fa.flash_attention_cuda(q, k, v, qo, kl, scale, **kw),
                    fa.flash_attention_plain(q, k, v, qo, kl, scale, **kw),
                    TOL["flash_attention"], f"K2 {name}")
        err = max(err, e)
    copies = 8
    kvs = [attn_inputs(gen, dev, B, S, T, Hq, Hkv, D, Dv) for _ in range(copies)]
    ms = device_ms(lambda i: fa.flash_attention_cuda(*kvs[i % copies], qoff, klen, scale,
                                                     **path_kw), 50)
    plain_ms = device_ms(lambda i: fa.flash_attention_plain(*kvs[i % copies], qoff, klen, scale,
                                                            **path_kw), 5)
    qb = [x[0].transpose(1, 2) for x in kvs]
    kb = [x[1][:, :, :S] for x in kvs]
    vb = [x[2][:, :, :S] for x in kvs]
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        qb[i % copies], kb[i % copies], vb[i % copies], is_causal=True,
        enable_gqa=True), 50)
    w = path_kw.get("window")
    # (query, key) pairs the causal mask (and a window of w keys) keeps
    pairs = S * (S + 1) / 2 if not w or w >= S else w * (w + 1) / 2 + (S - w) * w
    nbytes = B * S * Hq * (D + Dv) * 2 + B * Hkv * S * (D + Dv) * 2
    b_ms, b_by = bound(nbytes, 2.0 * B * Hq * pairs * (D + Dv))
    print(f"  {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by {b_by}), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.1f} us")
    key = fa.launch_key(B, S, T, Hq, Hkv, D, Dv)
    return dict(
        name=f"flash_attention[{key}]", route="cuda",
        source="quick_tpu_torch/csrc/flash_attention.cu",
        replaces="quick_tpu/ops/flash_attention.py:40",
        launches=(path, "flash_attention", key), max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    )


FUSED_SHAPES_PATH = "fused_shapes"  # phase 4b's generate() calls
#: K3's timed shapes (B, S, length, path): generate()'s decode (B=4, the
#: last step's length), the GGUF 128/128 protocol at B=1, and phase 4b's
#: generate() calls at B=8 and at S = 1,536 (3 MiB a row, the gate's edge)
FUSED_SHAPES = ((BATCH, MAX_SEQ, PROMPT + NEW_TOKENS - 1, "generate"),
                (1, MAX_SEQ, PROMPT + NEW_TOKENS - 1, "gguf_protocol"),
                (8, MAX_SEQ, PROMPT + NEW_TOKENS - 1, FUSED_SHAPES_PATH),
                (BATCH, 1536, 1500, FUSED_SHAPES_PATH))


def fused_row(cfg, gen, dev, B=BATCH, S=MAX_SEQ, length=PROMPT + NEW_TOKENS - 1,
              path="generate", path_kw=None, tag="2"):
    """[2, 3] K3 against its plain version at lengths 0, 1, 63, 64, 65, the
    timed length and S - 1, then timed at ``length`` beside SDPA's attention
    alone over the same cache rows; the bound from the bytes (the cache rows
    read, the new rows written, q, k/v_new, cos/sin and the output).
    ``path_kw``: the window and softcap the path runs K3 with, in the checks
    and the timing."""
    from quick_tpu_torch.ops import fused_decode_step as fs

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    L = cfg.num_hidden_layers
    path_kw = path_kw or {}
    print(f"[{tag}] K3 (fused decode step) against its plain version, B={B} S={S} D={D}"
          f"{f', path {path_kw}' if path_kw else ''}")

    def inputs():
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn((B, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        vn = torch.randn((B, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        ang = torch.rand((B, D // 2), generator=gen, device=dev) * 6.28
        return q, kn, vn, torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)

    kc = torch.randn((L, B, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((L, B, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
    scale = D ** -0.5
    err = 0.0
    for ln in sorted(n for n in {0, 1, 63, 64, 65, PROMPT, length, S - 1} if n < S):
        q, kn, vn, c, s = inputs()
        k1, v1 = kc[3:4].clone(), vc[3:4].clone()  # one layer: the check reads layer 0 of it
        k2, v2 = k1.clone(), v1.clone()
        lt = torch.full((1,), ln, dtype=torch.int32, device=dev)  # as the path's length_dev
        out = fs.fused_decode_attention_cuda(q, kn, vn, k1, v1, c, s, lt, 0, scale, **path_kw)
        ref = fs.fused_decode_attention_plain(q, kn, vn, k2, v2, c, s, ln, 0, scale, **path_kw)
        torch.cuda.synchronize()
        err = max(err, max_err(out, ref, TOL["fused_decode_step"], f"K3 B={B} S={S} length={ln}"))
        max_err(k1[0, :, :, ln], k2[0, :, :, ln], TOL_CACHE, "K3 written k row")
        k1[0, :, :, ln] = k2[0, :, :, ln]
        if not torch.equal(v1, v2) or not torch.equal(k1, k2):
            fail("K3 changed the cache outside the new row")
    q, kn, vn, c, s = inputs()
    ln = torch.full((1,), length, dtype=torch.int32, device=dev)  # as the path's length_dev
    ms = device_ms(lambda i: fs.fused_decode_attention_cuda(
        q, kn, vn, kc, vc, c, s, ln, i % L, scale, **path_kw), 100)
    plain_ms = device_ms(lambda i: fs.fused_decode_attention_plain(
        q, kn, vn, kc, vc, c, s, length, i % L, scale, **path_kw), 5)
    # no one PyTorch call does rope, the cache write and attention together:
    # the yardstick is SDPA's attention alone over the same cache rows
    q4 = q[:, :, None, :]
    lib_ms = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q4, kc[i % L][:, :, :length + 1], vc[i % L][:, :, :length + 1], scale=scale,
        enable_gqa=True), 100)
    nbytes = ((B * Hq * D + 2 * B * Hkv * D) * 2 + 2 * B * Hkv * length * D * 2
              + 2 * B * Hkv * D * 2 + B * Hq * D * 2 + 2 * B * D * 4)
    b_ms, b_by = bound(nbytes, 4.0 * B * Hq * (length + 1) * D)
    chunk, splits = fs.split_plan(B, Hkv, Hq // Hkv, S, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    print(f"  length {length}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by "
          f"{b_by}; {splits} splits of {chunk} keys), plain {plain_ms * 1e3:.1f} us, SDPA's "
          f"attention alone over the same cache {lib_ms * 1e3:.1f} us")
    key = f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D}"
    return dict(
        name=f"fused_decode_step[{key} length={length}]", route="cuda",
        source="quick_tpu_torch/csrc/fused_decode_step.cu",
        replaces="quick_tpu/ops/fused_decode_step.py:45",
        launches=(path, "fused_decode_step", key), max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    )


# ---------------------------------------------------------------------------
# Phase 2 / 3: the paged kernels K4-K6, at the serving path's shapes
# ---------------------------------------------------------------------------

def serving_trace(vocab: int, seed: int = 0):
    """(prompt, max_new_tokens) of the serving phase's requests: lengths
    from the lognormal fit of ShareGPT in tools/serve_bench.py (:26-30),
    random token ids, and one shared SYSTEM_PREFIX-token system prompt
    before each request's own tokens (serve_bench's --shared_prefix)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    plen = np.clip(rng.lognormal(5.0, 0.9, N_REQUESTS).astype(int), 4, 512)
    olen = np.clip(rng.lognormal(4.9, 0.8, N_REQUESTS).astype(int), 4, 256)
    prefix = [int(t) for t in rng.integers(0, vocab, SYSTEM_PREFIX)]
    return [(prefix + [int(t) for t in rng.integers(0, vocab, int(p))], int(o))
            for p, o in zip(plen, olen)]


def paged_geometry(cfg, engine=ENGINE) -> dict:
    page = engine["page_size"]
    n_pt = engine["max_seq"] // page
    return dict(B=engine["max_slots"], Bp=engine["prefill_rows"], S=engine["chunk"],
                page=page, n_pt=n_pt, P=engine["max_slots"] * n_pt + 1,
                Hq=cfg.num_attention_heads, Hkv=cfg.num_key_value_heads, D=cfg.head_dim)


def trace_positions(trace, g):
    """Per-slot positions the serving path gives the paged kernels: decode
    lengths mid-output (prompt + max_new // 2) of requests 0-15, and chunk
    starts mid-prompt of requests 16-23 (chunks start at multiples of 16)."""
    dec = [len(p) + n // 2 for p, n in trace[: g["B"]]]
    chunk = [len(p) // 2 // g["S"] * g["S"] for p, _ in trace[g["B"]: g["B"] + g["Bp"]]]
    return dec, chunk


def page_pool(gen, dev, g, layers):
    shape = (layers, g["P"], g["Hkv"], g["page"], g["D"])
    return [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2)]


def block_table(gen, dev, g, rows):
    """``rows`` slots with n_pt own pages each, drawn from 1..P-1."""
    perm = torch.randperm(g["P"] - 1, generator=gen, device=dev)[: rows * g["n_pt"]] + 1
    return perm.reshape(rows, g["n_pt"]).to(torch.int32)


def span_addresses(bt, g, pos, n):
    """(page_ids [rows, 2], offs [rows]) of an n-token write at each slot's
    ``pos`` through block table ``bt``, aimed as PagedKVCache.update aims
    them."""
    page = g["page"]
    pos = torch.tensor(pos, dtype=torch.int64, device=bt.device)
    rows = len(pos)
    first = torch.gather(bt[:rows], 1, (pos // page)[:, None])[:, 0]
    nxt = torch.gather(bt[:rows], 1, torch.clamp(pos // page + 1, max=g["n_pt"] - 1)[:, None])[:, 0]
    off = pos % page
    second = torch.where(off + n > page, nxt, torch.zeros_like(nxt))
    return torch.stack([first, second], 1).to(torch.int32), off.to(torch.int32)


def paged_write_rows(cfg, gen, dev, trace):
    from quick_tpu_torch.ops import paged_write as pw

    g = paged_geometry(cfg)
    B, Bp, S, page, Hkv, D = (g[k] for k in ("B", "Bp", "S", "page", "Hkv", "D"))
    L = cfg.num_hidden_layers
    dec, chunk = trace_positions(trace, g)
    print("[2] K4 (paged write) against its plain scatter, bf16 and f32 pages, and bf16 rows "
          "handed over off 16 bytes (its scalar path): equal outside the trash page 0")
    bt = block_table(gen, dev, g, B).long()

    def addresses(pos, n):
        return span_addresses(bt, g, pos, n)

    def new_rows(rows, n, dtype=torch.bfloat16):
        return [torch.randn((rows, n, Hkv, D), generator=gen, device=dev).to(dtype)
                for _ in range(2)]

    # (entry, tokens, positions, valid): the serving path's decode and
    # prefill sub-batch writes, then unaligned chunks of all 16 slots that
    # cross page boundaries, with masked tails
    span = g["n_pt"] * page - S
    cases = [("decode", 1, dec, None), ("chunk", S, chunk, [S] * Bp),
             ("chunk", S, [(p * 7) % span for p in dec], [S - i % 5 for i in range(B)])]
    small = {torch.bfloat16: page_pool(gen, dev, g, 2)}
    small[torch.float32] = [t.float() for t in small[torch.bfloat16]]
    err = {}
    for dtype, scalar in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True)):
        for entry, n, pos, valid in cases:
            rows = len(pos)
            pids, offs = addresses(pos, n)
            if entry == "decode":
                pids[-3:] = 0  # idle slots: colliding writes to the trash page
            vt = torch.tensor(valid or [1] * rows, dtype=torch.int32, device=dev)
            kn, vn = new_rows(rows, n, dtype)
            kg, vg = (off16(kn), off16(vn)) if scalar else (kn, vn)
            got = [t.clone() for t in small[dtype]]
            ref = [t.clone() for t in small[dtype]]
            before = pw.KERNEL.launches
            if entry == "decode":
                pw.paged_write_decode(*got, kg[:, 0], vg[:, 0], pids[:, 0], offs, 1)
                pw.paged_write_plain(*ref, kn, vn, pids[:, :1].expand(rows, 2), offs, vt, 1)
            else:
                pw.paged_write_chunk(*got, kg, vg, pids, offs, vt, 1)
                pw.paged_write_plain(*ref, kn, vn, pids, offs, vt, 1)
            torch.cuda.synchronize()
            key = pw.launch_key(entry, rows, n, Hkv, page, D, dtype)
            e = max(float((a[:, 1:].float() - b[:, 1:].float()).abs().max())
                    for a, b in zip(got, ref))
            if pw.KERNEL.launches != before + 1:
                fail(f"K4 {key}: not launched once")
            if not all(same_bytes(a[:, 1:], b[:, 1:]) for a, b in zip(got, ref)) or \
                    torch.equal(got[0][:, 1:], small[dtype][0][:, 1:]):
                fail(f"K4 {key}: pages differ from the plain scatter (max {e}) or nothing written")
            print(f"  K4 {key}{', scalar path' if scalar else ''}, "
                  f"{'crossing' if pids[:, 1].any() else 'aligned'}: pages 1.. byte-equal to "
                  "the plain scatter")
            if dtype == torch.bfloat16 and not scalar:
                err[key] = max(err.get(key, 0.0), e)
    del small

    print("[3] K4 timing at the serving shapes (page pool of all 32 layers)")
    big = page_pool(gen, dev, g, L)
    out = []
    for entry, n, pos, _ in cases[:2]:
        rows = len(pos)
        pids, offs = addresses(pos, n)
        vt = torch.full((rows,), n, dtype=torch.int32, device=dev)
        kn, vn = new_rows(rows, n)
        r = offs.long()[:, None] + torch.arange(n, device=dev)
        pg = torch.where(r >= page, pids[:, 1:2], pids[:, 0:1]).long()
        row = torch.where(r >= page, r - page, r)
        if entry == "decode":
            pid0 = pids[:, 0].contiguous()  # the kernel alone: no copy of a strided column

            def kern(i):
                pw.paged_write_decode(*big, kn[:, 0], vn[:, 0], pid0, offs, i % L)
        else:
            def kern(i):
                pw.paged_write_chunk(*big, kn, vn, pids, offs, vt, i % L)

        def plain(i):
            pw.paged_write_plain(*big, kn, vn, pids, offs, vt, i % L)

        def lib(i):  # yardstick: index_put_ of the k rows and of the v rows
            big[0][i % L, pg, :, row] = kn
            big[1][i % L, pg, :, row] = vn

        ms, plain_ms, lib_ms = device_ms(kern, 200), device_ms(plain, 20), device_ms(lib, 200)
        b_ms, b_by = bound(2 * 2 * rows * n * Hkv * D * 2 + 3 * rows * 4, 0.0)
        key = pw.launch_key(entry, rows, n, Hkv, page, D, torch.bfloat16)
        print(f"  {key}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us by {b_by}), "
              f"plain {plain_ms * 1e3:.1f} us, index_put_ k + v {lib_ms * 1e3:.1f} us")
        out.append(dict(
            name=f"paged_write[{key}]", route="cuda",
            source="quick_tpu_torch/csrc/paged_write.cu",
            replaces=f"quick_tpu/ops/paged_write.py:{76 if entry == 'decode' else 211}",
            launches=("engine", "paged_write", key), max_abs_err=err[key],
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        ))
    del big
    torch.cuda.empty_cache()
    return out


def k4_graph_pdl(cfg, gen, dev, trace, layers: int = 32) -> dict:
    """[3] K4 in a captured graph of ``layers`` x (K1's qkv projection at the
    Engine's M = 16 decode rows, then that layer's K4 decode write of the 16
    slots), captured with K4's programmatic dependent launch and with a plain
    one: the pages after one replay of each byte-equal to the plain
    scatter's; then ms a replay of each, in turns (on, off, off, on), and
    their ratio."""
    from quick_tpu_torch.ops import paged_write as pw
    from quick_tpu_torch.ops import quantized_matmul as qm

    g = paged_geometry(cfg)
    B, Hkv, D = g["B"], g["Hkv"], g["D"]
    pool = [torch.zeros((layers, g["P"], Hkv, g["page"], D), dtype=torch.bfloat16, device=dev)
            for _ in range(2)]
    dec, _ = trace_positions(trace, g)
    pids, offs = span_addresses(block_table(gen, dev, g, B).long(), g, dec, 1)
    pid0 = pids[:, 0].contiguous()
    kn, vn = (torch.randn((B, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    x = torch.randn((B, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    wq = rand_qlinear(gen, dev, *gemm_shapes(cfg)["qkv"])[0]

    def step():
        for layer in range(layers):
            qm.quantized_matmul_cuda(x, *wq)
            pw.paged_write_decode(*pool, kn, vn, pid0, offs, layer)

    graphs = {}
    for pdl in (True, False):
        pw.WRITE_PDL = pdl
        try:
            step()  # eager: makes any counters
            graphs[pdl] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[pdl]):
                step()
        finally:
            pw.WRITE_PDL = True
    ref = [torch.zeros_like(t) for t in pool]
    for layer in range(layers):
        pw.paged_write_plain(*ref, kn[:, None], vn[:, None], pids[:, :1].expand(B, 2), offs,
                             None, layer)
    for pdl in (True, False):
        for t in pool:
            t.zero_()
        graphs[pdl].replay()
        torch.cuda.synchronize()
        if not all(same_bytes(a[:, 1:], b[:, 1:]) for a, b in zip(pool, ref)):
            fail(f"K4 in a captured graph ({'PDL' if pdl else 'plain launch'}): pages differ "
                 "from the plain scatter")
    ms = {True: [], False: []}
    for pdl in (True, False, False, True):
        ms[pdl].append(device_ms(lambda i, gr=graphs[pdl]: gr.replay(), 20))
    out = dict(layers=layers, rows=B, pdl_ms=sum(ms[True]) / 2,
               plain_launch_ms=sum(ms[False]) / 2)
    out["plain_over_pdl"] = out["plain_launch_ms"] / out["pdl_ms"]
    print(f"[3] a graph of {layers} x (K1 qkv, K4 decode) at M = {B}, pages byte-equal to the "
          "plain scatter with and without K4's PDL: " + json.dumps(out))
    del graphs, pool, ref
    torch.cuda.empty_cache()
    return out


def paged_attention_rows(cfg, gen, dev, trace):
    import torch.nn.functional as F

    from quick_tpu_torch.ops import paged_attention as pa

    g = paged_geometry(cfg)
    B, Bp, S, page, n_pt = (g[k] for k in ("B", "Bp", "S", "page", "n_pt"))
    Hq, Hkv, D = g["Hq"], g["Hkv"], g["D"]
    L = cfg.num_hidden_layers
    scale = D ** -0.5
    dec, chunk = trace_positions(trace, g)
    tol = TOL["paged_attention"]
    print(f"[2] K5 / K6 (paged attention) against gather + einsum attention, bf16, "
          f"decode lengths {dec}, chunk starts {chunk}")
    bt = block_table(gen, dev, g, B)
    lens = torch.tensor(dec, dtype=torch.int32, device=dev)
    starts = torch.tensor(chunk, dtype=torch.int32, device=dev)
    # all 16 slots at unaligned starts: chunks that cross page boundaries
    starts16 = torch.tensor([(p * 7) % (n_pt * page - S) for p in dec],
                            dtype=torch.int32, device=dev)
    qd = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    qc = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    small = page_pool(gen, dev, g, 2)
    err = {"decode": 0.0, "chunk": 0.0}
    slopes = 2.0 ** (-8.0 * torch.arange(1, Hq + 1, device=dev, dtype=torch.float32) / Hq)
    for name, kw in (("", {}), (", window 100", dict(window=100)),
                     (", softcap 30", dict(logit_softcap=30.0)),
                     (", ALiBi", dict(alibi_slopes=slopes))):
        err["decode"] = max(err["decode"], max_err(
            pa.paged_decode_attention_cuda(qd, *small, bt, lens, 1, scale, **kw),
            pa.paged_decode_attention_plain(qd, *small, bt, lens, 1, scale, **kw),
            tol, f"K5 B={B}{name}"))
        err["chunk"] = max(err["chunk"], max_err(
            pa.paged_chunk_attention_cuda(qc[:Bp], *small, bt[:Bp], starts, 1, scale, **kw),
            pa.paged_chunk_attention_plain(qc[:Bp], *small, bt[:Bp], starts, 1, scale, **kw),
            tol, f"K6 B={Bp} S={S}{name}"))
        max_err(pa.paged_chunk_attention_cuda(qc, *small, bt, starts16, 1, scale, **kw),
                pa.paged_chunk_attention_plain(qc, *small, bt, starts16, 1, scale, **kw),
                tol, f"K6 B={B} S={S} crossing pages{name}")
    del small

    print("[3] K5 / K6 timing at the serving shapes (pages of all 32 layers)")
    big = page_pool(gen, dev, g, L)
    ar = torch.arange(n_pt * page, device=dev)
    copies = 4  # pre-gathered dense K/V for the yardstick, > 2x L2 in all

    def dense(rows, T):
        return [[pa.gather_pages(big[j], bt[:rows], layer)[:, :, :T].contiguous()
                 for j in (0, 1)] for layer in range(copies)]

    # K5: one query per slot at lengths - 1
    T = max(dec)
    kv = dense(B, T)
    mask = (ar[None, :T] < lens[:, None])[:, None, None, :]
    q4 = qd[:, :, None, :]
    ms = device_ms(lambda i: pa.paged_decode_attention_cuda(qd, *big, bt, lens, i % L, scale), 50)
    plain_ms = device_ms(lambda i: pa.paged_decode_attention_plain(
        qd, *big, bt, lens, i % L, scale), 5, warmup=1)
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        q4, *kv[i % copies], attn_mask=mask, scale=scale, enable_gqa=True), 50)
    keys = sum(dec)
    b_ms, b_by = bound(2 * keys * Hkv * D * 2 + 2 * B * Hq * D * 2 + B * (n_pt + 1) * 4,
                       4.0 * Hq * D * keys)
    key5 = pa.launch_key(B, None, Hq, Hkv, page, D, n_pt)
    print(f"  {key5}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa on gathered K/V {lib_ms * 1e3:.1f} us")
    rows = [dict(
        name=f"paged_attention[{key5}]", route="cuda",
        source="quick_tpu_torch/csrc/paged_attention.cu",
        replaces="quick_tpu/ops/paged_attention.py:32",
        launches=("engine", "paged_attention", key5), max_abs_err=err["decode"],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    )]
    del kv

    # K6: a prefill sub-batch's chunk, query i at starts + i
    T = max(chunk) + S
    kv = dense(Bp, T)
    qpos = starts[:, None] + torch.arange(S, device=dev)
    mask = (ar[None, None, :T] <= qpos[:, :, None])[:, None]
    q4 = qc[:Bp].transpose(1, 2)
    ms = device_ms(lambda i: pa.paged_chunk_attention_cuda(
        qc[:Bp], *big, bt[:Bp], starts, i % L, scale), 50)
    plain_ms = device_ms(lambda i: pa.paged_chunk_attention_plain(
        qc[:Bp], *big, bt[:Bp], starts, i % L, scale), 5, warmup=1)
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        q4, *kv[i % copies], attn_mask=mask, scale=scale, enable_gqa=True), 50)
    keys = sum(c + S for c in chunk)
    pairs = sum(c * S + S * (S + 1) // 2 for c in chunk)
    b_ms, b_by = bound(2 * keys * Hkv * D * 2 + 2 * Bp * S * Hq * D * 2 + Bp * (n_pt + 1) * 4,
                       4.0 * Hq * D * pairs)
    key6 = pa.launch_key(Bp, S, Hq, Hkv, page, D, n_pt)
    print(f"  {key6}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa on gathered K/V {lib_ms * 1e3:.1f} us")
    rows.append(dict(
        name=f"paged_attention[{key6}]", route="cuda",
        source="quick_tpu_torch/csrc/paged_attention.cu",
        replaces="quick_tpu/ops/paged_attention.py:179",
        launches=("engine", "paged_attention", key6), max_abs_err=err["chunk"],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    ))
    del kv, big
    return rows


# ---------------------------------------------------------------------------
# Phase 2 / 3: K7, the dense-cache decode attention
# ---------------------------------------------------------------------------

def dense_lengths(gen, dev, name, B, T):
    if name == "protocol":  # prompt 128 + 1 .. 127 generated tokens
        return torch.randint(PROTOCOL_CTX + 1, T, (B,), generator=gen, device=dev)
    if name == "long":
        return LONG_PROMPT + torch.randint(0, LONG_NEW, (B,), generator=gen, device=dev)
    ln = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
    ln[0], ln[1] = 1, T  # a length-1 row and a full row
    return ln


def dense_decode_rows(cfg, gen, dev):
    """K7 against its plain version at the shapes of DENSE_B_T (softcap 30
    and ALiBi slopes at the protocol shape too), on the checkpoint path."""
    Hq = cfg.num_attention_heads
    slopes = 2.0 ** (-8.0 * torch.arange(1, Hq + 1, device=dev, dtype=torch.float32) / Hq)
    rows = []
    for name, (B, T) in DENSE_B_T.items():
        cases = [("", {})]
        if name == "protocol":
            cases += [(", softcap 30", dict(logit_softcap=30.0)),
                      (", ALiBi", dict(alibi_slopes=slopes)),
                      (", softcap 30 + ALiBi", dict(logit_softcap=30.0, alibi_slopes=slopes))]
        rows.append(k7_row(cfg, gen, dev, name, B, T, dense_lengths(gen, dev, name, B, T),
                           cases, "checkpoint"))
    return rows


def k7_row(cfg, gen, dev, name, B, T, lengths, cases, path, timed_kw=None, tag="2"):
    """K7 against its plain version at B rows of a T-key cache with
    ``lengths``, each of ``cases`` ((label, kwargs)), within tol * (1 +
    |ref|) and tol * max|ref| of each query row, then timed (with
    ``timed_kw``, the path's softcap) over a 4-layer stack rotated past L2,
    against its byte bound and SDPA (enable_gqa) over the cache view with a
    length mask; its launches read from ``path``'s run."""
    import torch.nn.functional as F

    from quick_tpu_torch.ops import decode_attention as dda
    from quick_tpu_torch.ops._cuda import sm_count

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    scale = D ** -0.5
    L = 4
    timed_kw = timed_kw or {}
    lengths = lengths.to(torch.int32)
    print(f"[{tag}] K7 (dense decode attention) against its plain version, {name}: B={B} "
          f"T={T} D={D}, lengths {int(lengths.min())}-{int(lengths.max())}")
    k, v = [torch.randn((L, B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2)]
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    err = 0.0
    for label, kw in cases:
        out = dda.dense_decode_attention_cuda(q, k, v, lengths, 1, scale, **kw)
        ref = dda.dense_decode_attention_plain(q, k, v, lengths, 1, scale, **kw)
        torch.cuda.synchronize()
        err = max(err, max_err(out, ref, TOL["decode_attention"], f"K7 {name}{label}"))
        row_scaled_err(out, ref, TOL["decode_attention"], f"K7 {name}{label}")
    _, splits = dda.split_plan(B, Hkv, T, sm_count(dev.index or 0))
    key = dda.launch_key(B, Hq, Hkv, T, D, splits)
    ar = torch.arange(T, device=dev)
    mask = (ar[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    ms = device_ms(lambda i: dda.dense_decode_attention_cuda(q, k, v, lengths, i % L, scale,
                                                             **timed_kw), 100)
    plain_ms = device_ms(lambda i: dda.dense_decode_attention_plain(
        q, k, v, lengths, i % L, scale, **timed_kw), 5, warmup=1)
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        q4, k[i % L], v[i % L], attn_mask=mask, scale=scale, enable_gqa=True), 100)
    keys = int(lengths.sum())
    b_ms, b_by = bound(2 * keys * Hkv * D * 2 + 2 * B * Hq * D * 2 + B * 4,
                       4.0 * Hq * D * keys)
    print(f"  {key}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa over the cache view {lib_ms * 1e3:.1f} us")
    del k, v
    return dict(
        name=f"decode_attention[{key}]", route="cuda",
        source="quick_tpu_torch/csrc/decode_attention.cu",
        replaces="quick_tpu/ops/decode_attention.py:46",
        launches=(path, "decode_attention", key), max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    )


# ---------------------------------------------------------------------------
# Phase 4: the generate() path
# ---------------------------------------------------------------------------

def generate_launches(cfg, B=BATCH, prompt=PROMPT, new_tokens=NEW_TOKENS, T=MAX_SEQ,
                      group=128, calls=None) -> dict:
    """Launches per kernel and key of one generate() call: a prefill
    forward of [B, prompt] (K1 at M = B x prompt, K2) and new_tokens - 1
    decode forwards of [B, 1] (K1 at M = B with its prologues where M <= 8,
    K3); MoE layers add K8's two launches per forward; at ``group`` 32 or 64
    K9 takes K1's place. ``calls``, if given: (B, prompt, T, prefill
    forwards, decode forwards) of several calls over dense caches with
    B <= 8 (the fused decode step), instead of the one generate() call."""
    L = cfg.num_hidden_layers
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    want = {}

    def add(kernel, key, n):
        if n:
            want.setdefault(kernel, {})
            want[kernel][key] = want[kernel].get(key, 0) + n

    for B, S, T, n_pre, n_dec in calls or [(B, prompt, T, 1, new_tokens - 1)]:
        for rows, n in ((B * S, n_pre), (B, n_dec)):
            add_forward_launches(cfg, rows, L * n, add, group)
        # the final norm of each forward, over its last tokens (the bf16 head
        # takes no prologue)
        add("rms_norm", k13_key(B, cfg.hidden_size), n_pre + n_dec)
        add("flash_attention", f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D}", L * n_pre)
        add("fused_decode_step", f"B={B} Hq={Hq} Hkv={Hkv} S={T} D={D}", L * n_dec)
    return want


def run_generate(model, cfg, dev, label: str, want: dict):
    """generate() of B=4 x (128 + 64) tokens: a warm-up, one counted call
    whose launches must equal ``want``, then prefill and decode timed apart
    three times with the same greedy tokens, the eager decode loop once
    beside the graphed one (the same tokens and the same k/v cache bit for
    bit), and profiles of 32 graphed and 8 eager decode steps. Returns
    (launch counts by kernel and key, stats)."""
    from quick_tpu_torch.ops import all_kernels
    from quick_tpu_torch.runtime import SamplingParams, decode_loop, make_cache, prefill
    from quick_tpu_torch.runtime.generate import graphable

    gen = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    model.generate(prompts, 2, max_seq=MAX_SEQ)  # warm-up, not counted
    torch.cuda.synchronize()

    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(prompts, NEW_TOKENS, max_seq=MAX_SEQ)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = {k.name: dict(k.launches_by_key) for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    got = {k: v for k, v in counts.items() if v}
    print(f"  launches of the {label} generate() call:")
    for name, c in got.items():
        for key, v in sorted(c.items()):
            print(f"    {name} {key}: {v}")
    if got != want:
        fail(f"{label}: launch counts {got} differ from the path's {want}")
    if tuple(out.shape) != (BATCH, PROMPT + NEW_TOKENS):
        fail(f"generate returned {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT], prompts) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail("generate's tokens are out of range or lost the prompt")

    # the same run through generate's two stages, timed apart, three times
    # (host time varies from run to run: the spread is reported)
    t_prefill, t_decode = [], []
    for _ in range(3):
        cache = make_cache(cfg, BATCH, MAX_SEQ, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(model.params, cfg, prompts, cache)
        first = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        t_prefill.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rest, cache = decode_loop(model.params, cfg, first, cache, NEW_TOKENS - 1)
        torch.cuda.synchronize()
        t_decode.append(time.perf_counter() - t0)
        again = torch.cat([first[:, None], rest], dim=1)
        if not torch.equal(again, out[:, PROMPT:]):
            fail("a second greedy run gave other tokens (kernels not deterministic)")
    graphed_cache = cache
    # the eager loop beside the graph: the same tokens and cache, its own time
    cache = make_cache(cfg, BATCH, MAX_SEQ, device=dev)
    logits, cache = prefill(model.params, cfg, prompts, cache)
    first = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rest, cache = decode_loop(model.params, cfg, first, cache, NEW_TOKENS - 1, _graph=False)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    if not torch.equal(torch.cat([first[:, None], rest], dim=1), out[:, PROMPT:]):
        fail(f"{label}: the eager decode loop gave other greedy tokens than the graphed one")
    same_planes(f"{label}: the graphed and the eager decode loop's caches",
                dense_planes(graphed_cache), dense_planes(cache))
    del graphed_cache
    stats = dict(
        generate_s=t_gen,
        prefill_ms=[t * 1e3 for t in t_prefill],
        prefill_tok_s=[BATCH * PROMPT / t for t in t_prefill],
        decode_graphed=graphable(model.params, cfg, cache, SamplingParams()),
        decode_ms_per_step=[t * 1e3 / (NEW_TOKENS - 1) for t in t_decode],
        decode_tok_s=[BATCH * (NEW_TOKENS - 1) / t for t in t_decode],
        decode_ms_per_step_eager=t_eager * 1e3 / (NEW_TOKENS - 1),
        peak_mem_gib=peak / 2**30,
    )
    print("  " + json.dumps(stats) + "; eager and graphed greedy tokens and caches equal")
    del cache
    # the graphed loop's profile spans 32 steps, its capture included; the
    # eager one 8 (the profiler's own cost grows with the host's calls)
    stats["decode_profile"] = profile_decode(model, cfg, prompts, dev, steps=32)
    stats["decode_profile_eager"] = profile_decode(model, cfg, prompts, dev, graph=False)
    stats["aten_calls_per_layer"] = (stats["decode_profile"]["aten_calls_per_step"]
                                     / cfg.num_hidden_layers)
    stats["aten_calls_per_layer_eager"] = (stats["decode_profile_eager"]["aten_calls_per_step"]
                                           / cfg.num_hidden_layers)
    torch.cuda.empty_cache()
    return counts, stats


def phase4_main_path(cfg, dev):
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.model import init_quant_params

    print(f"[4] generate() path: {cfg.model_type} width, {cfg.num_hidden_layers} layers, "
          f"B={BATCH}, {PROMPT} + {NEW_TOKENS} tokens, max_seq {MAX_SEQ}")
    t0 = time.perf_counter()
    model = AutoQuickModel(init_quant_params(cfg, seed=0, device=dev), cfg)
    torch.cuda.synchronize()
    print(f"  random QTPU weights (seed 0) in {time.perf_counter() - t0:.1f} s")
    counts, stats = run_generate(model, cfg, dev, cfg.model_type, generate_launches(cfg))
    return counts, stats, model.params


#: [4b] the switch's graphed decode: phase 4's prompts in a 512-token
#: cache, where QUICK_TPU_FUSED_STEP=0 routes the step to K7 (the dense
#: gate's 8 MB of K+V a layer) rather than to the einsum, so both runs replay
#: a captured step
SWITCH_SEQ = 512


def phase4b_fused_step(params, cfg, dev):
    """[4b] generate() at K3's other timed shapes (FUSED_SHAPES: B=8 at
    max_seq 256, B=4 with 1,496-token prompts at max_seq 1,536), with
    exact launch counts; then the graphed B=4 decode with K3 beside the same
    decode under QUICK_TPU_FUSED_STEP=0 (K7), in turns."""
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.ops import all_kernels
    from quick_tpu_torch.runtime import decode_loop, make_cache, prefill

    model = AutoQuickModel(params, cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    calls = [(8, PROMPT, MAX_SEQ, NEW_TOKENS), (BATCH, 1496, 1536, 8)]
    print("[4b] generate() at K3's other shapes: " + ", ".join(
        f"B={B} prompt {P} max_seq {T} (+{n})" for B, P, T, n in calls))
    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    for B, P, T, n in calls:
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
        out = model.generate(prompts, n, max_seq=T)
        if tuple(out.shape) != (B, P + n) or not torch.equal(out[:, :P], prompts) \
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            fail(f"[4b] generate at B={B} max_seq {T}: shape {tuple(out.shape)} or tokens")
    torch.cuda.synchronize()
    counts = {k.name: dict(k.launches_by_key) for k in kernels}
    got = {k: v for k, v in counts.items() if v}
    want = generate_launches(cfg, calls=[(B, P, T, 1, n - 1) for B, P, T, n in calls])
    if got != want:
        fail(f"[4b] launch counts {got} differ from the calls' {want}")
    print(f"  launches as the calls imply; K3: {json.dumps(counts['fused_decode_step'])}")

    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    steps = NEW_TOKENS - 1

    def decode(off: bool):
        with switches(QUICK_TPU_FUSED_STEP="0" if off else "1"):
            cache = make_cache(cfg, BATCH, SWITCH_SEQ, device=dev)
            logits, cache = prefill(params, cfg, prompts, cache)
            first = torch.argmax(logits, dim=-1)
            for k in kernels:
                k.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rest, cache = decode_loop(params, cfg, first, cache, steps)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
        launched = {k.name: k.launches for k in kernels if k.launches}
        return ms, rest, launched

    runs = {False: [], True: []}
    tokens = {}
    for off in (False, True, True, False):
        ms, rest, launched = decode(off)
        runs[off].append(ms)
        if not torch.equal(tokens.setdefault(False, rest), rest):
            fail(f"[4b] QUICK_TPU_FUSED_STEP={'0' if off else '1'}: the graphed decode gave other "
                 "greedy tokens than the first run's (K3)")
        tokens[off] = rest
        route = "decode_attention" if off else "fused_decode_step"
        if launched.get(route, 0) != steps * cfg.num_hidden_layers:
            fail(f"[4b] QUICK_TPU_FUSED_STEP={'0' if off else '1'}: {launched} lacks "
                 f"{route} at every layer of every step")
        if off and "fused_decode_step" in launched:
            fail("[4b] QUICK_TPU_FUSED_STEP=0 still launched K3")
    stats = dict(max_seq=SWITCH_SEQ, steps=steps, decode_ms_per_step_k3=runs[False],
                 decode_ms_per_step_switch_off_k7=runs[True], same_greedy_tokens=True)
    print(f"  graphed B={BATCH} decode at max_seq {SWITCH_SEQ}, ms per step: K3 "
          f"{runs[False]}, QUICK_TPU_FUSED_STEP=0 (K7) {runs[True]}; same greedy tokens: "
          f"{stats['same_greedy_tokens']}")
    return counts, stats


def profile_decode(model, cfg, prompts, dev, steps: int = 8, graph=None) -> dict:
    """Device busy share of decode steps and where their time goes; the
    graphed loop (its capture included) unless ``graph`` is False."""
    from quick_tpu_torch.runtime import decode_loop, make_cache, prefill

    cache = make_cache(cfg, BATCH, MAX_SEQ, device=dev)
    logits, cache = prefill(model.params, cfg, prompts, cache)
    first = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    out = device_profile(lambda: decode_loop(model.params, cfg, first, cache, steps,
                                             _graph=graph), steps)
    print(f"  decode profile{' (eager)' if graph is False else ''}: " + json.dumps(out))
    return out


def device_profile(run, steps: int) -> dict:
    """Run ``run()`` (``steps`` steps of some kind) under torch.profiler
    (CPU + CUDA activities): the sum of device activity durations over the
    wall time, the largest device kernels, and the largest host-side aten
    ops by self CPU time, per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device, host = {}, {}
    n_kernels = n_calls = 0  # device activities; aten ops called from Python
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
        elif e.name.startswith("aten::"):
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
            parent = e.cpu_parent
            n_calls += parent is None or not parent.name.startswith("aten::")
    busy_us = sum(device.values())
    out = dict(
        steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
        device_busy_ms_per_step=busy_us / steps / 1e3,
        device_busy_share=busy_us / wall_us if busy_us else None,
        aten_self_cpu_ms_per_step=sum(host.values()) / steps / 1e3,
        aten_calls_per_step=n_calls / steps, device_activities_per_step=n_kernels / steps,
        top_device_us_per_step={k[:60]: v / steps for k, v in
                                sorted(device.items(), key=lambda kv: -kv[1])[:8]},
        top_aten_cpu_us_per_step={k: v / steps for k, v in
                                  sorted(host.items(), key=lambda kv: -kv[1])[:10]},
    )
    return out


# ---------------------------------------------------------------------------
# Phase 5: the serving path
# ---------------------------------------------------------------------------

def k1_projections(cfg):
    """(K, N, prologue at <= 8 decode rows) of each K1 launch of one layer's
    forward: qkv (RMSNorm prologue; none without pre-norms, olmo2) and o;
    the dense MLP's gate_up (RMSNorm, or none) and down (SiLU-GLU; none
    under gelu, whose gate runs as torch ops); an MoE layer's shared expert,
    if any, takes no prologue (its norm is never fused, its gate runs
    first)."""
    s = gemm_shapes(cfg)
    norm = "rmsnorm" if cfg.pre_norms else None
    out = [(*s["qkv"], norm), (*s["o"], None)]
    if not cfg.is_moe:
        return out + [(*s["gate_up"], norm), (*s["down"], "glu" if cfg.act_fn == "silu" else None)]
    D = cfg.hidden_size
    Fe = cfg.moe_intermediate_size or cfg.intermediate_size
    Fs = cfg.shared_intermediate_size or Fe * cfg.n_shared_experts
    return out + ([(D, 2 * Fs, None), (Fs, D, None)] if Fs else [])


def k8_launch_keys(cfg, T: int, group: int = 128):
    """K8's two launch keys (gate_up, down) of an MoE layer routing T tokens."""
    from quick_tpu_torch.ops.grouped_matmul import grouped_row_budget, launch_key, pick_grouped_bm

    E = cfg.num_local_experts
    tk = T * min(cfg.num_experts_per_tok, E)
    bm = pick_grouped_bm(tk, E)
    Mp = grouped_row_budget(tk, E, bm)
    D, Fe = cfg.hidden_size, cfg.moe_intermediate_size or cfg.intermediate_size
    return [launch_key(Mp, K, N, E, bm, group) for K, N in ((D, 2 * Fe), (Fe, D))]


def a8_switches():
    """(QUICK_TPU_A8, QUICK_TPU_A8_FUSED, QUICK_TPU_MOE_A8) as the port
    reads them at each call."""
    from quick_tpu_torch.modules.linear import a8_enabled, moe_a8_enabled
    from quick_tpu_torch.ops.quantized_matmul import a8_fused_quant

    return a8_enabled(), a8_fused_quant(), moe_a8_enabled()


def k13_key(rows: int, D: int) -> str:
    from quick_tpu_torch.ops.norms import launch_key

    return launch_key(rows, D)


def layer_tail_on() -> bool:
    """``QUICK_TPU_LAYER_TAIL`` as the port reads it at each call."""
    return os.environ.get("QUICK_TPU_LAYER_TAIL", "") == "1"


def add_forward_launches(cfg, rows: int, n: int, add, group: int = 128) -> None:
    """Add K1's (K9's at ``group`` 32 or 64; K11 / K11f's above 96 rows under
    QUICK_TPU_A8), K8's (K12's under QUICK_TPU_MOE_A8 at G = 128), K13's and
    K14's launches of ``n`` layer-forwards over ``rows`` tokens (every layer
    of these models is dense, or every one MoE). K13 runs each norm that no
    K1 prologue or K14 takes: the attention norm and a dense MLP's at rows >
    8, at G != 128 or under A8 (which unfuses the prologues); an MoE layer's
    MLP norm always; none without pre-norms (olmo2). Under
    QUICK_TPU_LAYER_TAIL a dense layer of <= 8 rows at G = 128 runs o, the
    MLP norm, gate_up and down in K14. The per-head qk-norm (qwen3, gemma3)
    adds two K13 launches a layer, over [rows x heads, head_dim] of q and of
    k; olmo2's full-width one two over [rows, heads x head_dim]; the
    post-norms (gemma2, gemma3, olmo2) two over [rows, D]."""
    from quick_tpu_torch.ops.fused_layer_tail import launch_key as tail_key
    from quick_tpu_torch.ops.quantized_matmul import (
        a8_launch_key,
        dequant_launch_key,
        launch_key as gemm_key,
    )

    if any(cfg.layer_is_moe(i) != cfg.is_moe for i in range(cfg.num_hidden_layers)):
        fail(f"{cfg.model_type}: mixed dense and MoE layers are not counted here")
    a8, fused, moe_a8 = a8_switches()
    prologues = group == 128 and rows <= 8 and not a8
    tail = layer_tail_on() and rows <= 8 and group == 128 and not cfg.is_moe
    projections = k1_projections(cfg)
    if tail:
        (K1, D), (I, _) = gemm_shapes(cfg)["o"], gemm_shapes(cfg)["down"]
        add("fused_layer_tail", tail_key(rows, K1, D, I), n)
        projections = projections[:1]  # qkv
    for K, N, pro in projections:
        if a8 and rows > 96:
            add("quantized_matmul_a8", a8_launch_key(rows, K, N, group, fused and group == 128), n)
        elif group == 128:
            add("quantized_matmul", gemm_key(pro if prologues else None, rows, K, N), n)
        else:  # the prologues run as torch ops before K9
            add("quantized_matmul_dequant", dequant_launch_key(rows, K, N, group), n)
    if cfg.is_moe:
        for key in k8_launch_keys(cfg, rows, group):
            if moe_a8 and group == 128:
                add("grouped_matmul_a8", key, n)  # K12 keys as K8's at G = 128
            else:
                add("grouped_matmul", key, n)
    if cfg.pre_norms:
        add("rms_norm", k13_key(rows, cfg.hidden_size),
            n * ((0 if prologues else 1)
                 + (0 if tail else 1 if cfg.is_moe or not prologues else 0)))
    if cfg.use_post_norms:
        add("rms_norm", k13_key(rows, cfg.hidden_size), 2 * n)
    if cfg.use_qk_norm:
        hd = cfg.head_dim
        for heads in (cfg.num_attention_heads, cfg.num_key_value_heads):
            add("rms_norm", k13_key(rows, heads * hd) if cfg.qk_norm_full
                else k13_key(rows * heads, hd), n)


def engine_launches(cfg, stats, engine=ENGINE) -> dict:
    """Launches per kernel and key that the Engine's recorded schedule
    implies: each forward runs L launches of K4 (K4q over INT8 pages), L of
    K5 / K5q (S = 1) or K6 / K6q (S > 1), K1's per layer at the forward's
    [rows, S] (4 L for a dense model, 2 L + the shared expert's for an MoE
    one), 2 L of K8 (MoE) and K13's (add_forward_launches, and the final
    norm over [rows, 1]). Decode windows and [B, 1] mixed steps run
    [max_slots, 1], prefill sub-batches [prefill_rows, chunk], [B, chunk]
    mixed steps [max_slots, chunk]."""
    from quick_tpu_torch.ops.paged_attention import launch_key as attn_key
    from quick_tpu_torch.ops.paged_write import launch_key as write_key

    g = paged_geometry(cfg, engine)
    L = cfg.num_hidden_layers
    kv = engine.get("dtype", torch.bfloat16)
    sfx = "_int8" if kv == torch.int8 else ""
    forwards = {
        (g["B"], 1): stats["window_forwards"] + stats["mixed_steps"] - stats["mixed_chunk_steps"],
        (g["Bp"], g["S"]): stats["prefill_substeps"],
        (g["B"], g["S"]): stats["mixed_chunk_steps"],
    }
    want = {}

    def add(kernel, key, n):
        if n:
            want.setdefault(kernel, {})
            want[kernel][key] = want[kernel].get(key, 0) + n

    for (rows, S), n in forwards.items():
        if not n:
            continue
        add_forward_launches(cfg, rows * S, L * n, add)
        add("rms_norm", k13_key(rows, cfg.hidden_size), n)  # the final norm
        add("paged_write" + sfx, write_key("decode" if S == 1 else "chunk", rows, S, g["Hkv"],
                                           g["page"], g["D"], kv), L * n)
        add("paged_attention" + sfx, attn_key(rows, None if S == 1 else S, g["Hq"], g["Hkv"],
                                              g["page"], g["D"], g["n_pt"]), L * n)
    return want


def submit_all(eng, trace) -> list:
    """Submit every request of ``trace``: (prompt, max_new_tokens) or
    (prompt, max_new_tokens, submit keywords: sampling, logit_bias)."""
    return [eng.submit(t[0], t[1], **(t[2] if len(t) > 2 else {})) for t in trace]


def sync_checked(eng, checked: dict) -> None:
    """Make ``eng``'s dispatch methods named in ``checked`` raise on any
    host sync (torch's sync debug mode) and count their calls there."""
    for name in checked:
        def wrapped(*a, _fn=getattr(eng, name), _name=name, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                checked[_name] += 1
        setattr(eng, name, wrapped)


def engine_timing(params, cfg, tag: str, engine=ENGINE, trace=None) -> dict:
    """One more run of the trace, untimed and uncounted, under
    QUICK_TPU_ENGINE_TIMING=1: the host seconds of each phase of the
    Engine's turns (``Engine.timing``: admission, window dispatch, blocked
    window fetches and those with nothing queued behind them, prefill
    dispatch, pending fetches, mixed steps) beside the run's wall time."""
    from quick_tpu_torch.runtime import Engine

    trace = trace or serving_trace(cfg.vocab_size)
    with switches(QUICK_TPU_ENGINE_TIMING="1"):
        eng = Engine(params, cfg, **engine)
    submit_all(eng, trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    split = dict(eng.timing, wall_s=time.perf_counter() - t0, steps=eng.stats["steps"])
    print(f"  [{tag}] Engine.timing under QUICK_TPU_ENGINE_TIMING=1 (one more run, untimed), "
          "host seconds: " + json.dumps(split))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return split


def phase_engine(params, cfg, tag: str, engine=ENGINE, trace=None, launches=None,
                 warmup: bool = True, keep_streams: bool = False):
    """The Engine over a request trace (default: the 32-request trace with
    a shared prefix): a warm-up run whose every decode-window and prefill
    sub-batch dispatch is sync-checked and in which one scheduler turn of
    steady decode is profiled, then a timed run with every request at its
    exact length, the warm-up's greedy streams and launch counts equal to
    those its recorded schedule implies (``launches(cfg, stats, engine)``,
    default engine_launches). ``warmup=False``: one run, sync-checked,
    profiled for one turn, counted and timed (its wall time includes the
    profiled turn). ``keep_streams``: the timed run's streams are returned
    too (under "streams")."""
    from quick_tpu_torch.ops import all_kernels
    from quick_tpu_torch.runtime import Engine

    if trace is None:
        trace = serving_trace(cfg.vocab_size)
    launches = launches or engine_launches
    n_prompt = sum(len(t[0]) for t in trace)
    n_out = sum(t[1] for t in trace)
    shared = len(os.path.commonprefix([t[0] for t in trace]))
    print(f"[{tag}] serving path: {cfg.model_type}, {cfg.num_hidden_layers} layers, "
          f"Engine({engine}), {len(trace)} requests, {n_prompt} prompt tokens "
          f"({shared}-token shared prefix) + {n_out} output tokens")
    kernels = all_kernels()
    lengths = [t[1] for t in trace]

    def run(checked):
        """One run of the trace; with ``checked``, no host sync is allowed
        while a decode window or a prefill sub-batch is dispatched (torch
        raises on any synchronizing call; the host waits only on the
        drains' events) and one scheduler turn of steady decode is
        profiled."""
        eng = Engine(params, cfg, **engine)
        pool = [t.numel() * t.element_size() for t in
                (eng.cache.k_pages, eng.cache.v_pages, eng.cache.kv_scales) if t is not None]
        if checked is not None:
            sync_checked(eng, checked)
        uids = submit_all(eng, trace)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profile = None
        if checked is not None:
            while eng.has_work and len(eng.ready_slots()) < engine["max_slots"] // 2:
                eng.step()
            before = dict(eng.stats)
            steps = 1  # the trace's post-processing is slow: one turn (one window) is enough
            profile = device_profile(lambda: [eng.step() for _ in range(steps)], steps)
            grew = {k: eng.stats[k] - before[k] for k in before}
            profile["decode_windows"] = grew["window_steps"]
            profile["forwards"] = (grew["window_forwards"] + grew["prefill_substeps"]
                                   + grew["mixed_steps"])
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        streams = [outs[u] for u in uids]
        if [len(st) for st in streams] != lengths:
            fail(f"{cfg.model_type} Engine: a request did not finish with exactly its "
                 "max_new_tokens")
        stats = dict(eng.stats, graph_replays=eng.graph_replays)
        if checked is not None:
            if not all(checked.values()):
                fail(f"the sync check saw no dispatch: {checked}")
            print(f"  no host sync inside {checked['_dispatch_window']} decode-window and "
                  f"{checked['_prefill_substep']} prefill sub-batch dispatches")
            print(f"  profile of 1 scheduler turn ({profile['decode_windows']} decode "
                  f"windows, {profile['forwards']} forwards): " + json.dumps(profile))
        del eng
        gc.collect()  # the sync-checked methods close a cycle around the engine and its pages
        return streams, wall, profile, stats, pool

    checked = {"_dispatch_window": 0, "_prefill_substep": 0}
    ref = wall0 = profile = None
    if warmup:
        ref, wall0, profile, _, _ = run(checked)
        print(f"  warm-up run {wall0:.2f} s (profiled)")
    for k in kernels:
        k.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    streams, wall, prof, stats, pool = run(None if warmup else checked)
    profile = profile or prof
    counts = {k.name: dict(k.launches_by_key) for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    if warmup and streams != ref:
        fail(f"{cfg.model_type} Engine: the timed run gave other greedy streams than the warm-up")
    want = launches(cfg, stats, engine)
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        fail(f"{cfg.model_type} Engine: launch counts {got} differ from the schedule's {want}")
    run_stats = dict(wall_s=wall, output_tok_s=n_out / wall, total_tok_s=(n_prompt + n_out) / wall,
                     peak_mem_gib=peak / 2**30, stats=stats, pool_bytes=pool,
                     includes_profiled_turn=not warmup)
    print(f"  timed run{'' if warmup else ' (one turn profiled)'}: {wall:.3f} s, "
          f"{n_out / wall:.1f} output tok/s, "
          f"{(n_prompt + n_out) / wall:.1f} total tok/s, peak {peak / 2**30:.2f} GiB; "
          f"page pool {sum(pool) / 1e9:.3f} GB ({' + '.join(f'{b / 1e9:.3f}' for b in pool)})")
    print(f"    stats {json.dumps(stats)}; launches equal to the schedule's:")
    for name, c in got.items():
        for key, v in sorted(c.items()):
            print(f"    {name} {key}: {v}")
    torch.cuda.empty_cache()
    return counts, dict(runs=[run_stats], warmup_s=wall0, sync_checked_dispatches=checked,
                        profile=profile, **({"streams": streams} if keep_streams else {}))


# ---------------------------------------------------------------------------
# Phase 6: kernel path against the plain path on a 2-layer full-width model
# ---------------------------------------------------------------------------

#: [18c] the logits of the 6-layer Gemma3-12B check, kernel route against
#: plain route: each row's relative RMS difference. Phase 6's 1e-2 x (1 +
#: |ref|) assumes the paths differ by single bf16 steps of the logits, which
#: holds at 2 layers. Through 6 post-normed layers (each sub-layer's output
#: normalized to unit scale before the residual add, so its rounding is not
#: damped) the final hidden states differ by about one bf16 step (2^-8) of
#: their RMS, and a logit inherits that times |embedding row| ~1.2: the
#: largest of 262,208 such differences reached 0.03 (H100 80GB HBM3, 700 W),
#: which 1e-2 x (1 + |ref|) refuses at small logits. The RMS over the row
#: holds the same relative error without the max over the vocabulary:
#: 2^-6 is four bf16 steps. [18e] holds a Gemma2-9B AWQ block's x_next so
#: too: its post-norms add each sub-layer's output at unit scale, and the
#: largest of its 58.7 M per-element differences (5.13e-2 x (1 + |ref|) on
#: the same card) exceeds the Mistral block's AWQ_XNEXT_TOL (5e-2),
#: set where the sub-layer outputs are small beside the residual
TOL_DEEP_RMS = 2.0 ** -6


def deep_logits_err(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """[18c] rows of logits: the largest ||out - ref|| / ||ref|| of a row
    within TOL_DEEP_RMS, and the same argmax in every row whose two best
    plain logits lie more than 4 x the largest |out - ref| apart."""
    o, r = out.float(), ref.float()
    d = o - r
    rel = float((d.norm(dim=-1) / r.norm(dim=-1)).max())
    top2 = r.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4 * float(d.abs().max())
    same = o.argmax(-1) == r.argmax(-1)
    print(f"  {what}: relative RMS {rel:.3e} (tol {TOL_DEEP_RMS:.3e}), max_abs_err "
          f"{float(d.abs().max()):.3e}, max|ref| {float(r.abs().max()):.3e}, argmax compared in "
          f"{int(clear.sum())} of {len(clear)} rows")
    if not rel <= TOL_DEEP_RMS or not bool(same[clear].all()):
        fail(f"{what}: kernel disagrees with its plain version")
    return rel


def phase6_paged_plain_vs_kernel(cfg, dev, tag="6", require=None, params=None,
                                 starts=(0, 21, 56, 100), max_seq=256, steps=PHASE6_DECODE,
                                 deep=False):
    """model_forward over a PagedKVCache: one 16-token chunk for a slot at
    each of ``starts`` (by default 4 slots, one crossing a page boundary)
    over random earlier context, then ``steps`` decode steps; the card's
    kernel path (K4-K6) against the plain path on the CPU. ``require``:
    {kernel: launches} the run must also make (phase 13c: K14 under the
    switch). ``params``: the model on the card and on the CPU (default:
    random g=128 QTPU weights, seed 2, 2 layers). ``deep``: as in
    ``phase6_dense_plain_vs_kernel``."""
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.models.model import init_quant_params, model_forward
    from quick_tpu_torch.modules.paged_cache import PagedKVCache
    from quick_tpu_torch.ops import all_kernels

    L = 2 if params is None else len(params[0].blocks)
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=L)
    B, S, page = len(starts), 16, 64
    n_pt = max_seq // page
    P = 1 + B * n_pt
    starts = list(starts)
    print(f"[{tag}] {L} layers at full width, paged cache (page {page}), chunk at starts "
          f"{starts} + {steps} decode steps: kernel path (card) vs plain path (CPU), "
          f"tol {TOL_MODEL} * (1 + |ref|)")
    if params is None:
        p_gpu = init_quant_params(cfg2, seed=2, device=dev)
        p_cpu = params_from_flat(params_to_flat(p_gpu), cfg2, device="cpu")
    else:
        p_gpu, p_cpu = params
    gen = torch.Generator(device=dev).manual_seed(2)
    bt = (torch.randperm(P - 1, generator=gen, device=dev) + 1).reshape(B, n_pt).to(torch.int32)
    shape = (L, P, cfg.num_key_value_heads, page, cfg.head_dim)
    context = [(0.5 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
               for _ in range(2)]
    caches = []
    for d in (dev, torch.device("cpu")):
        c = PagedKVCache.create(L, P, page, B, max_seq, cfg.num_key_value_heads,
                                cfg.head_dim, device=d)
        c.k_pages.copy_(context[0])
        c.v_pages.copy_(context[1])
        c.block_table.copy_(bt)
        caches.append(c.with_length(torch.tensor(starts, dtype=torch.int32, device=d)))
    cg, cc = caches
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    worst = 0.0
    with torch.inference_mode():
        for step in range(1 + steps):
            n = S if step == 0 else 1
            adv = [torch.full((B,), n, dtype=torch.int32, device=d) for d in (dev, "cpu")]
            lg, cg = model_forward(p_gpu, cfg2, toks, cg, advance=adv[0], last_valid=adv[0])
            lc, cc = model_forward(p_cpu, cfg2, toks.cpu(), cc, advance=adv[1], last_valid=adv[1])
            what = "chunk logits" if step == 0 else f"decode step {step}"
            worst = max(worst, deep_logits_err(lg[:, -1].cpu(), lc[:, -1], what) if deep
                        else max_err(lg[:, -1].cpu(), lc[:, -1], TOL_MODEL, what))
            toks = torch.argmax(lg[:, -1], dim=-1)[:, None]  # both paths take it
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels if k.launches}
    if launched.get("paged_write") != L * (1 + steps) or \
            launched.get("paged_attention") != L * (1 + steps):
        fail(f"the paged {L}-layer path did not run K4-K6 once per layer per step: {launched}")
    for name, n in (require or {}).items():
        if launched.get(name) != n:
            fail(f"the paged {L}-layer path did not run {name} {n} times: {launched}")
    if cg.length.tolist() != cc.length.tolist() or \
            cc.length.tolist() != [s + S + steps for s in starts]:
        fail(f"lengths {cg.length.tolist()} / {cc.length.tolist()}")
    print(f"  launches {launched}")
    return worst


def phase6_dense_plain_vs_kernel(cfg, dev, B=BATCH, max_seq=MAX_SEQ, prompt=PROMPT,
                                 decode_kernel="fused_decode_step", params=None, tag="6",
                                 tol=TOL_MODEL, prefill_kernel=None, require=None,
                                 steps=PHASE6_DECODE, decode_layers=None, counts=None,
                                 deep=False):
    """model_forward over a dense cache: a prefill and ``steps`` decode
    steps, the card's kernel path against the plain path on the CPU. At B=4 and
    max_seq 256 decode takes K3; at B=16 and max_seq 512 (32 MiB of K+V per
    layer) the dense decode kernel K7. ``params``: the model on the card and
    on the CPU (default: random g=128 QTPU weights, seed 1, 2 layers).
    ``decode_layers``: the layers whose decode runs ``decode_kernel`` (all
    by default; K7 takes no window, so a sliding layer whose window binds
    decodes on the einsum, as in the JAX package). ``prefill_kernel``: a
    GEMM kernel that must run the prefill's four projections (phase 12f:
    K11 under QUICK_TPU_A8). ``require``: {kernel: launches} the run must
    also make (phase 13c: K14 under the switch). ``counts``: a dict that
    receives the run's launches by kernel and key. ``deep``: the logits
    held by ``deep_logits_err`` instead of ``tol`` (a model deeper than 2
    layers with post-norms)."""
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.models.model import init_quant_params, model_forward
    from quick_tpu_torch.ops import all_kernels
    from quick_tpu_torch.runtime import make_cache

    L = 2 if params is None else len(params[0].blocks)
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=L)
    kv_mb = 2 * B * max_seq * cfg.num_key_value_heads * cfg.head_dim * 2 / 2**20
    print(f"[{tag}] {L} layers at full width, dense cache B={B} max_seq {max_seq} ({kv_mb:.0f} "
          f"MiB of K+V per layer), prompt {prompt}, {steps} decode steps: kernel path (card) vs "
          f"plain path (CPU), tol {tol} * (1 + |ref|)")
    if params is None:
        p_gpu = init_quant_params(cfg2, seed=1, device=dev)
        p_cpu = params_from_flat(params_to_flat(p_gpu), cfg2, device="cpu")
    else:
        p_gpu, p_cpu = params
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, prompt), generator=gen, device=dev)
    cg = make_cache(cfg2, B, max_seq, device=dev)
    cc = make_cache(cfg2, B, max_seq, device="cpu")
    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    worst = 0.0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for step in range(1 + steps):
            lg, cg = model_forward(p_gpu, cfg2, toks, cg, last_token_only=True)
            lc, cc = model_forward(p_cpu, cfg2, toks.cpu(), cc, last_token_only=True)
            what = "prefill logits" if step == 0 else f"decode step {step}"
            worst = max(worst, deep_logits_err(lg[:, -1].cpu(), lc[:, -1], what) if deep
                        else max_err(lg[:, -1].cpu(), lc[:, -1], tol, what))
            toks = torch.argmax(lg[:, -1], dim=-1)[:, None]  # both paths take it
    launched = {k.name: k.launches for k in kernels if k.launches}
    if launched.get(decode_kernel) != (L if decode_layers is None else decode_layers) * steps:
        fail(f"the dense {L}-layer path did not run {decode_kernel} once per layer per decode "
             f"step: {launched}")
    if prefill_kernel and launched.get(prefill_kernel) != L * 4:
        fail(f"the dense {L}-layer prefill did not run {prefill_kernel} for its four projections "
             f"per layer: {launched}")
    for name, n in (require or {}).items():
        if launched.get(name) != n:
            fail(f"the dense {L}-layer path did not run {name} {n} times: {launched}")
    if counts is not None:
        counts.update({k.name: dict(k.launches_by_key) for k in kernels if k.launches})
    print(f"  launches {launched}; {time.perf_counter() - t0:.1f} s")
    return worst


# ---------------------------------------------------------------------------
# Phase 7: the checkpoint path
# ---------------------------------------------------------------------------

def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def checkpoint_launches(cfg, rounds) -> dict:
    """Launches per kernel and key that the checkpoint phase's calls imply.
    Every forward runs 4 L launches of K1 (qkv, o, gate_up, down) at
    M = rows; a prefill forward runs L of K2, a decode forward L of K7 (the
    B=4 stream's decode rows take K1's RMSNorm / SiLU-GLU prologues).
    ``rounds``: (batch, prompt, cache length, prefill forwards, decode
    forwards) of each call."""
    from quick_tpu_torch.ops._cuda import sm_count
    from quick_tpu_torch.ops.decode_attention import launch_key as k7_key, split_plan
    from quick_tpu_torch.ops.quantized_matmul import launch_key as k1_key

    L = cfg.num_hidden_layers
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    s = gemm_shapes(cfg)
    want = {"quantized_matmul": {}, "flash_attention": {}, "decode_attention": {},
            "rms_norm": {}}

    def add(kernel, key, n):
        if n:
            want[kernel][key] = want[kernel].get(key, 0) + n

    for B, S, T, n_pre, n_dec in rounds:
        # K13: both norms of a layer at prefill and at decode rows > 8, and
        # the final norm of each forward over its B last tokens
        add("rms_norm", k13_key(B * S, cfg.hidden_size), 2 * L * n_pre)
        add("rms_norm", k13_key(B, cfg.hidden_size),
            (2 * L if B > 8 else 0) * n_dec + n_pre + n_dec)
        for K, N in s.values():
            add("quantized_matmul", k1_key(None, B * S, K, N), L * n_pre)
        pro = {"qkv": "rmsnorm", "o": None, "gate_up": "rmsnorm", "down": "glu"}
        for name, (K, N) in s.items():
            add("quantized_matmul", k1_key(pro[name] if B <= 8 else None, B, K, N), L * n_dec)
        add("flash_attention", f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D}", L * n_pre)
        splits = split_plan(B, Hkv, T, sm_count(0))[1]
        add("decode_attention", k7_key(B, Hq, Hkv, T, D, splits), L * n_dec)
    return want


def phase7_checkpoint(params, cfg, dev):
    """save_quantized -> from_quantized at Mistral-7B width, then the
    128/128 protocol and a long-context stream on the loaded model."""
    from quick_tpu_torch import QuantConfig
    from quick_tpu_torch.examples.benchmark import run_round
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.convert import params_to_flat
    from quick_tpu_torch.ops import all_kernels
    from quick_tpu_torch.runtime import decode_loop, make_cache, prefill
    from quick_tpu_torch.utils.checkpoint import save_quantized

    flat = params_to_flat(params, cpu=False)
    need = sum(t.numel() * t.element_size() for t in flat.values())
    per_layer = sum(t.numel() * t.element_size() for k, t in flat.items() if k.startswith("blocks.0."))
    CKPT_DIR.parent.mkdir(exist_ok=True)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free = shutil.disk_usage(CKPT_DIR.parent).free
    layers = cfg.num_hidden_layers
    if free < 1.5 * need + 2e9:  # cut depth, never width
        layers = max(2, int((free - 2e9 - (need - layers * per_layer)) / 1.5 / per_layer))
    cfg_ck = dataclasses.replace(cfg, num_hidden_layers=layers)
    params_ck = dataclasses.replace(params, blocks=params.blocks[:layers])
    print(f"[7] checkpoint path: {cfg.model_type} width, {layers} of {cfg.num_hidden_layers} "
          f"layers ({free / 1e9:.1f} GB free on the disk of build/)")
    del flat
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_quantized(params_ck, cfg_ck, QuantConfig(), str(CKPT_DIR))
        t_save = time.perf_counter() - t0
        files = sorted(p.name for p in CKPT_DIR.iterdir())
        on_disk = sum(p.stat().st_size for p in CKPT_DIR.iterdir())
        print(f"  save_quantized: {t_save:.2f} s, {on_disk / 1e9:.3f} GB on disk in {files}")
        t0 = time.perf_counter()
        model = AutoQuickModel.from_quantized(str(CKPT_DIR))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        got, ref = params_to_flat(model.params, cpu=False), params_to_flat(params_ck, cpu=False)
        if list(got) != list(ref) or not all(same_bytes(got[k], ref[k]) for k in ref):
            fail("the loaded checkpoint differs from the saved params")
        if model.cfg != cfg_ck or model.device.type != "cuda":
            fail(f"loaded config {model.cfg} / device {model.device}")
        print(f"  from_quantized: {t_load:.2f} s; {len(ref)} tensors equal to the saved ones "
              "byte for byte, on the card")
        del got, ref

        kernels = all_kernels()
        for k in kernels:
            k.reset_counts()
        rows, calls = [], []
        try:
            for B, trials in PROTOCOL_ROUNDS:
                row = run_round(model, B, PROTOCOL_CTX, PROTOCOL_GEN, trials)
                rows.append(row)
                calls.append((B, PROTOCOL_CTX, PROTOCOL_CTX + PROTOCOL_GEN,
                              row["forwards"]["prefill"], row["forwards"]["decode"]))
                print("  run_round " + json.dumps(row))
            gen = torch.Generator(device=dev).manual_seed(3)
            prompts = torch.randint(0, cfg.vocab_size, (LONG_B, LONG_PROMPT), generator=gen, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(prompts, LONG_NEW, max_seq=LONG_SEQ)
            torch.cuda.synchronize()
            t_long = time.perf_counter() - t0
            calls.append((LONG_B, LONG_PROMPT, LONG_SEQ, 1, LONG_NEW - 1))
        except NotImplementedError as e:
            fail(f"the checkpoint path raised NotImplementedError: {e}")
        counts = {k.name: dict(k.launches_by_key) for k in kernels}
        got = {k: v for k, v in counts.items() if v}
        want = checkpoint_launches(cfg_ck, calls)
        print(f"  launches: per call (B, prompt, T, prefill forwards, decode forwards) {calls}; "
              f"L = {layers}: K1 4 L per forward at M = B x prompt (prefill) or B (decode), "
              "K2 L per prefill, K7 L per decode step")
        for name, c in got.items():
            for key, v in sorted(c.items()):
                print(f"    {name} {key}: {v}")
        if got != want:
            fail(f"launch counts {got} differ from the calls' {want}")
        if tuple(out.shape) != (LONG_B, LONG_PROMPT + LONG_NEW) or not torch.equal(out[:, :LONG_PROMPT], prompts) \
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            fail("the long-context stream's tokens are out of range or lost the prompt")
        print(f"  long-context stream: B={LONG_B}, {LONG_PROMPT} + {LONG_NEW} tokens in a "
              f"{LONG_SEQ}-token cache, generate {t_long:.3f} s")

        # where the time of a B=32 decode step goes
        B = PROTOCOL_ROUNDS[0][0]
        toks = torch.randint(0, cfg.vocab_size, (B, PROTOCOL_CTX), generator=gen, device=dev)
        cache = make_cache(cfg_ck, B, PROTOCOL_CTX + PROTOCOL_GEN, device=dev)
        logits, cache = prefill(model.params, cfg_ck, toks, cache)
        first = torch.argmax(logits, dim=-1)
        steps = 8
        profile = device_profile(lambda: decode_loop(model.params, cfg_ck, first, cache, steps), steps)
        print(f"  B={B} decode profile: " + json.dumps(profile))
        del model, cache
        torch.cuda.empty_cache()
    finally:  # the 4.5 GB checkpoint never outlives the phase
        shutil.rmtree(CKPT_DIR, ignore_errors=True)

    stats = dict(layers=layers, save_s=t_save, load_s=t_load, bytes_on_disk=on_disk,
                 files=files, rounds=rows, long_stream_s=t_long, decode_profile_b32=profile)
    return counts, stats


# ---------------------------------------------------------------------------
# Phase 8: the MoE path (Mixtral-8x7B and Qwen1.5-MoE-A2.7B, full width)
# ---------------------------------------------------------------------------

#: (path, T) of the token counts routed through K8: Mixtral's decode at B=4
#: and prefill of 4 x 128 (generate), the Engine's [16, 1] decode and
#: [8, 16] prefill sub-batch; Qwen1.5-MoE's T=16 (sort branch, 60
#: experts, most of them without a token; checked only) and its generate
#: path's two. Each shape runs gate_up and down.
MOE_K8_CASES = {
    "mixtral-8x7b": [("moe_generate", BATCH), ("moe_engine", ENGINE["max_slots"]),
                     ("moe_engine", ENGINE["prefill_rows"] * ENGINE["chunk"]),
                     ("moe_generate", BATCH * PROMPT)],
    "qwen1.5-moe-a2.7b": [(None, 16), ("qwen_generate", BATCH),
                          ("qwen_generate", BATCH * PROMPT)],
}
#: phase 8's kernel-vs-plain rule: a token whose top-k expert set differs
#: between the two paths must have had its k-th and (k+1)-th router logits
#: within this of each other on one of them (bf16 noise in the hidden
#: state moves a logit by ~1e-3 here); its row's logits are not compared
#: from then on
ROUTE_GAP = 0.05
MOE_CKPT_DIR = ROOT / "build" / "chip_smoke_moe_checkpoint"


def dequant_experts(qw, s, zs, group=128) -> torch.Tensor:
    """[E, N, K] bf16 dequantized expert weights (the yardstick's operand,
    column-major per expert as torch._grouped_mm takes it)."""
    from quick_tpu_torch.quantize.packing import unpack_qtpu_tensor

    E, K8, N = qw.shape
    K = K8 * 8
    out = torch.empty((E, N, K), dtype=torch.bfloat16, device=qw.device)
    for e in range(E):
        codes = unpack_qtpu_tensor(qw[e], group).float().reshape(K // group, group, N)
        out[e] = (codes * s[e][:, None] - zs[e][:, None]).reshape(K, N).t().to(torch.bfloat16)
    return out


def grouped_mm_ms(x, sel, pos, wd, ref, n, experts):
    """Yardstick: torch._grouped_mm of the routed rows, sorted by expert,
    against the dequantized bf16 weights (copies rotated until the
    ``experts`` touched exceed 2 x L2); None (with the reason printed)
    where this torch cannot run it. Prints its distance from K8's plain
    version on those rows."""
    flat = sel.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rows = pos.reshape(-1)[order].long()
    xr = x[rows].contiguous()
    offs = torch.cumsum(torch.bincount(flat, minlength=wd.shape[0]), 0).to(torch.int32)
    b = wd.transpose(-2, -1)
    try:
        y = torch._grouped_mm(xr, b, offs=offs)
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError, TypeError) as e:
        print(f"    torch._grouped_mm yardstick not run: {type(e).__name__}: {str(e)[:160]}")
        return None
    r = ref[rows].float()
    print(f"    torch._grouped_mm vs the plain version: max |d| / (1 + |ref|) "
          f"{float(((y.float() - r).abs() / (1 + r.abs())).max()):.3e}")
    E, N, K = wd.shape
    copies = max(1, min(8, math.ceil(2 * L2_BYTES / (experts * K * N * 2))))
    bs = [b] + [wd.clone().transpose(-2, -1) for _ in range(copies - 1)]
    ms = device_ms(lambda i: torch._grouped_mm(xr, bs[i % copies], offs=offs), n)
    del bs
    return ms


def grouped_rows(name, cfg, gen, dev, group=128, cases=None, tag="8", a8=False):
    """[8a, 8b] K8 against its plain version at ``name``'s routed shapes
    (random routing, full output: padding rows and dead tiles included),
    then timed with the expert weights rotated past L2: its bound from the
    bytes of the distinct experts this routing touches and of the routed
    rows, or from its routed FLOPs; the plain version; torch._grouped_mm.
    ``cases`` (path, T) default to MOE_K8_CASES[name]; ``group`` is the
    experts' quant group. ``a8`` (phase 12a-b): K12 on the rows' int8 codes
    in K8's place, its bound from int8 rows and int8 operations, and K8 at
    the same shape timed beside it."""
    from quick_tpu_torch.ops import grouped_matmul as gm
    from quick_tpu_torch.ops.quantized_matmul import quantize_activations

    E, kk = cfg.num_local_experts, cfg.num_experts_per_tok
    D, Fe = cfg.hidden_size, cfg.moe_intermediate_size or cfg.intermediate_size
    kname, label = ("grouped_matmul_a8", "K12") if a8 else ("grouped_matmul", "K8")
    print(f"[{tag}] {label} (grouped MoE GEMM{', W4A8' if a8 else ''}) against its plain "
          f"version, {name}: E={E}, top-{kk}, G={group}")
    out_rows = []
    for proj, (K, N) in (("gate_up", (D, 2 * Fe)), ("down", (Fe, D))):
        per_expert = K * N // 2 + 2 * (K // group) * N * 4
        ws = rand_qlinear(gen, dev, K, N, copies=E, group=group)
        qw, s, zs = (torch.stack([w[j] for w in ws]) for j in range(3))
        del ws
        wd = dequant_experts(qw, s, zs, group)
        if not a8:  # the decode branch, tokens 0 / 1 and 2 / 3 on the same kk experts
            sel = torch.tensor([[(t // 2 * kk + j) % E for j in range(kk)] for t in range(BATCH)],
                               device=dev)
            bm = gm.pick_grouped_bm(BATCH * kk, E)
            _, _, te, live, _ = gm.build_routing(sel, E, bm)
            if int(torch.bincount(te, minlength=E).max()) < 2:
                fail(f"{label} duplicate-expert case: no expert holds two tiles")
            # its own generator: the timed cases draw as before
            g1 = torch.Generator(device=dev).manual_seed(1)
            x = torch.randn((te.shape[0] * bm, K), generator=g1, device=dev).to(torch.bfloat16)
            max_err(gm.quantized_matmul_grouped_cuda(x, qw, s, zs, te, live, bm, group),
                    gm.quantized_matmul_grouped_plain(x, qw, s, zs, te, live, bm, group),
                    TOL[kname], f"{label} {proj} T={BATCH} decode, two tokens on each expert "
                    f"{gm.launch_key(te.shape[0] * bm, K, N, E, bm, group)}")
            del x
        for path, T in cases or MOE_K8_CASES[name]:
            sel = torch.argsort(torch.rand((T, E), generator=gen, device=dev), dim=1)[:, :kk]
            bm = gm.pick_grouped_bm(T * kk, E)
            _, pos, te, live, _ = gm.build_routing(sel, E, bm)
            Mp = te.shape[0] * bm
            x = torch.randn((Mp, K), generator=gen, device=dev).to(torch.bfloat16)
            key = gm.launch_key(Mp, K, N, E, bm, group)
            if a8:
                xq, sx = quantize_activations(x)
                out = gm.launch_grouped_a8(xq, sx, qw, s, zs, te, live, bm)
                ref = gm.quantized_matmul_grouped_a8_plain(x, qw, s, zs, te, live, bm)
            else:
                out = gm.quantized_matmul_grouped_cuda(x, qw, s, zs, te, live, bm, group)
                ref = gm.quantized_matmul_grouped_plain(x, qw, s, zs, te, live, bm, group)
            torch.cuda.synchronize()
            experts = int(torch.unique(te[live.bool()]).numel())
            err = max_err(out, ref, TOL[kname],
                          f"{label} {proj} T={T} {key}, {experts} experts, "
                          f"{int(live.sum())}/{te.shape[0]} live tiles")
            if path is None:
                continue
            n = 20 if T <= 16 else 5
            # copies of the stacked experts (other addresses, same values)
            # until the experts this routing touches exceed 2 x L2
            copies = max(1, min(8, math.ceil(2 * L2_BYTES / (experts * per_expert))))
            stacks = [(qw, s, zs)] + [(qw.clone(), s.clone(), zs.clone())
                                      for _ in range(copies - 1)]

            def kern(i):
                gm.quantized_matmul_grouped_cuda(x, *stacks[i % copies], te, live, bm, group)

            def kern_a8(i):
                gm.launch_grouped_a8(xq, sx, *stacks[i % copies], te, live, bm)

            ms = device_ms(kern_a8 if a8 else kern, n)
            extra = {}
            if a8:
                extra["w4a16_ms"] = device_ms(kern, n)  # K8 at the same shape
            del stacks
            plain = gm.quantized_matmul_grouped_a8_plain if a8 else (
                lambda *a: gm.quantized_matmul_grouped_plain(*a, group))
            plain_ms = device_ms(lambda i: plain(x, qw, s, zs, te, live, bm), 2, warmup=1)
            lib_ms = grouped_mm_ms(x, sel, pos, wd, ref, n, experts)
            # the distinct experts' weights, x (int8 codes and row scales
            # under a8) and out of the T * topk routed rows (not the padding
            # rows or dead tiles), the tile layout
            xbytes = K + 4 if a8 else 2 * K
            nbytes = experts * per_expert + T * kk * (xbytes + 2 * N) + 2 * te.shape[0] * 4
            b_ms, b_by = bound(nbytes, 2.0 * T * kk * K * N, INT8_OPS if a8 else BF16_FLOPS)
            lib = "n/a" if lib_ms is None else f"{lib_ms * 1e3:.1f} us"
            k8 = f", K8 {extra['w4a16_ms'] * 1e3:.1f} us" if a8 else ""
            print(f"  {key}: {ms * 1e3:.1f} us ({copies} weight copies; bound "
                  f"{b_ms * 1e3:.1f} us by {b_by}), plain "
                  f"{plain_ms * 1e3:.1f} us, torch._grouped_mm on bf16 weights {lib}{k8}")
            out_rows.append(dict(
                name=f"{kname}[{key}]", route="cuda",
                source=f"quick_tpu_torch/csrc/{kname}.cu",
                replaces="quick_tpu/ops/grouped_matmul.py:" + ("93" if a8 else "48"),
                launches=(path, kname, key), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                **extra,
            ))
            del x, out, ref
        if a8:  # bm = 96 (QUICK_TPU_MOE_BM): the skeleton's 32-row sub-tiles, held and
            # timed as above (no path of the script runs it)
            for T in (BATCH, BATCH * PROMPT):
                sel = torch.argsort(torch.rand((T, E), generator=gen, device=dev), dim=1)[:, :kk]
                _, pos, te, live, _ = gm.build_routing(sel, E, 96)
                x = torch.randn((te.shape[0] * 96, K), generator=gen, device=dev).to(torch.bfloat16)
                xq, sx = quantize_activations(x)
                out = gm.launch_grouped_a8(xq, sx, qw, s, zs, te, live, 96)
                ref = gm.quantized_matmul_grouped_a8_plain(x, qw, s, zs, te, live, 96)
                key = gm.launch_key(te.shape[0] * 96, K, N, E, 96)
                max_err(out, ref, TOL[kname],
                        f"{label} {proj} T={T} {key}, {int(live.sum())}/{te.shape[0]} live tiles")
                if bool((out[(live == 0).repeat_interleave(96)] != 0).any()):
                    fail(f"{label} bm=96: a dead tile is not all zeros")
                experts = int(torch.unique(te[live.bool()]).numel())
                copies = max(1, min(8, math.ceil(2 * L2_BYTES / (experts * per_expert))))
                stacks = [(qw, s, zs)] + [(qw.clone(), s.clone(), zs.clone())
                                          for _ in range(copies - 1)]
                n = 20 if T <= 16 else 5
                ms = device_ms(lambda i: gm.launch_grouped_a8(
                    xq, sx, *stacks[i % copies], te, live, 96), n)
                del stacks
                lib_ms = grouped_mm_ms(x, sel, pos, wd, ref, n, experts)
                nbytes = experts * per_expert + T * kk * (K + 4 + 2 * N) + 2 * te.shape[0] * 4
                b_ms, b_by = bound(nbytes, 2.0 * T * kk * K * N, INT8_OPS)
                lib = "n/a" if lib_ms is None else f"{lib_ms * 1e3:.1f} us"
                print(f"  {key}: {ms * 1e3:.1f} us ({copies} weight copies; bound "
                      f"{b_ms * 1e3:.1f} us by {b_by}), torch._grouped_mm on bf16 weights {lib}")
                del x, xq, out, ref
        del qw, s, zs, wd
        torch.cuda.empty_cache()
    return out_rows


def phase8_checkpoint(params, cfg, dev, group=128, tag="8"):
    """[8f] A 2-layer full-width slice of the MoE model (quant ``group``)
    saved with save_quantized, loaded with from_quantized, compared byte for
    byte."""
    from quick_tpu_torch import QuantConfig
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.convert import params_to_flat
    from quick_tpu_torch.utils.checkpoint import save_quantized

    layers = 2
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=layers)
    p2 = dataclasses.replace(params, blocks=params.blocks[:layers])
    shutil.rmtree(MOE_CKPT_DIR, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_quantized(p2, cfg2, QuantConfig(q_group_size=group), str(MOE_CKPT_DIR))
        t_save = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in MOE_CKPT_DIR.iterdir())
        t0 = time.perf_counter()
        model = AutoQuickModel.from_quantized(str(MOE_CKPT_DIR))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        got, ref = params_to_flat(model.params, cpu=False), params_to_flat(p2, cpu=False)
        if list(got) != list(ref) or not all(same_bytes(got[k], ref[k]) for k in ref):
            fail("the loaded MoE checkpoint differs from the saved params")
        if model.cfg != cfg2 or model.device.type != "cuda" or model.qcfg.q_group_size != group:
            fail(f"loaded MoE config {model.cfg} / device {model.device} / {model.qcfg}")
        n = len(ref)
        del got, ref, model
    finally:
        shutil.rmtree(MOE_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[{tag}] MoE checkpoint: {layers} layers of {cfg.model_type} at full width, "
          f"{on_disk / 1e9:.3f} GB: save {t_save:.2f} s, load {t_load:.2f} s, {n} tensors equal "
          "byte for byte")
    return dict(layers=layers, bytes_on_disk=on_disk, save_s=t_save, load_s=t_load, tensors=n)


@contextlib.contextmanager
def recorded_routes(k: int):
    """Record, per device, each moe_forward call's top-``k`` expert set and
    the gap between its k-th and (k+1)-th router logits."""
    from quick_tpu_torch.modules import blocks

    routes = {"cuda": [], "cpu": []}
    orig = blocks.moe_forward

    def recorded(p, c, x, token_mask=None):
        v, i = blocks.top_k(p.router(x.to(torch.float32)), k + 1)
        routes[x.device.type].append((torch.sort(i[..., :k], dim=-1).values.cpu(),
                                      (v[..., k - 1] - v[..., k]).cpu()))
        return orig(p, c, x, token_mask)

    blocks.moe_forward = recorded
    try:
        yield routes
    finally:
        blocks.moe_forward = orig


def fold_routes(routes, flipped_rows, name: str, step: int) -> int:
    """One step's recorded routes of both paths: mark the rows [B] with a
    token routed differently in ``flipped_rows``, fail where such a token's
    router gap reaches ROUTE_GAP on both paths; clear the record. Returns
    the tokens routed differently."""
    flips = 0
    for (sg, gg), (sc, gc) in zip(routes["cuda"], routes["cpu"]):
        differ = (sg != sc).any(-1)  # [B, S]
        if differ.any():
            gap = torch.minimum(gg, gc)[differ]
            flips += int(differ.sum())
            print(f"  step {step}: {int(differ.sum())} tokens routed differently, "
                  f"router gaps {[round(float(g), 5) for g in gap]}")
            if float(gap.max()) >= ROUTE_GAP:
                fail(f"{name}: a token's experts differ between the paths at a "
                     f"router gap of {float(gap.max())}")
        flipped_rows |= differ.any(-1)
    routes["cuda"].clear()
    routes["cpu"].clear()
    return flips


def phase8_plain_vs_kernel(name, cfg, dev, B=BATCH, prompt=32, steps=2, max_seq=64, group=128,
                           tag="8", tol=TOL_MODEL, expert_kernel="grouped_matmul", params=None,
                           require=None):
    """[8e] A 2-layer full-width MoE model over a dense cache: a prefill of
    B x prompt tokens and ``steps`` decode steps, the card's kernel path
    against the plain path on the CPU, logits within ``tol``, with the
    routing rule of ROUTE_GAP. ``group``: the quant group of every linear;
    ``expert_kernel``: the grouped kernel that runs the experts (K8, or K12
    under QUICK_TPU_MOE_A8); ``params``: the 2-layer model on the card and
    on the CPU (default: random QTPU weights, seed 1); ``require``: {kernel:
    launches} the run must also make (phase 17e: K13's, qk-norm included)."""
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.models.model import init_quant_params, model_forward
    from quick_tpu_torch.ops import all_kernels
    from quick_tpu_torch.runtime import make_cache

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    k = cfg.num_experts_per_tok
    print(f"[{tag}] 2 layers of {name} at full width, G={group}, dense cache B={B} max_seq "
          f"{max_seq}, prompt {prompt} + {steps} decode steps: kernel path (card) vs plain path "
          f"(CPU), tol "
          f"{tol} * (1 + |ref|) on rows whose routing agrees; a differing top-{k} set "
          f"needs a router gap < {ROUTE_GAP}")
    if params is None:
        p_gpu = init_quant_params(cfg2, seed=1, group_size=group, device=dev)
        p_cpu = params_from_flat(params_to_flat(p_gpu), cfg2, device="cpu", group_size=group)
    else:
        p_gpu, p_cpu = params
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, prompt), generator=gen, device=dev)
    cg = make_cache(cfg2, B, max_seq, device=dev)
    cc = make_cache(cfg2, B, max_seq, device="cpu")
    kernels = all_kernels()
    for kern in kernels:
        kern.reset_counts()
    flipped_rows = torch.zeros(B, dtype=torch.bool)
    flips, worst, compared, t0 = 0, 0.0, 0, time.perf_counter()
    with recorded_routes(k) as routes, torch.inference_mode():
        for step in range(1 + steps):
            lg, cg = model_forward(p_gpu, cfg2, toks, cg, last_token_only=True)
            lc, cc = model_forward(p_cpu, cfg2, toks.cpu(), cc, last_token_only=True)
            flips += fold_routes(routes, flipped_rows, name, step)
            keep = ~flipped_rows
            if keep.any():
                compared += int(keep.sum())
                what = "prefill logits" if step == 0 else f"decode step {step}"
                worst = max(worst, max_err(lg[keep.to(dev), -1].cpu(), lc[keep, -1], tol,
                                           f"{what} ({int(keep.sum())} of {B} rows)"))
            toks = torch.argmax(lg[:, -1], dim=-1)[:, None]  # both paths take it
    torch.cuda.synchronize()
    launched = {kern.name: kern.launches for kern in kernels if kern.launches}
    by_key = {kern.name: dict(kern.launches_by_key) for kern in kernels if kern.launches}
    n_moe = sum(cfg2.layer_is_moe(i) for i in range(2))
    if launched.get(expert_kernel) != 2 * n_moe * (1 + steps) or compared == 0:
        fail(f"{name}: the 2-layer MoE path did not run {expert_kernel} twice per MoE layer per "
             f"forward, or no row was compared: {launched}, {compared} rows")
    for kname, n in (require or {}).items():
        if launched.get(kname) != n:
            fail(f"{name}: the 2-layer MoE path did not run {kname} {n} times: {launched}")
    print(f"  launches {launched}; {flips} tokens routed differently; "
          f"{time.perf_counter() - t0:.1f} s")
    del p_gpu, p_cpu, cg, cc
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, flipped_tokens=flips, rows_compared=compared,
                launches=launched, launches_by_key=by_key)


def phase8_moe(dev):
    """Phase 8: K8 at the MoE paths' shapes, then Mixtral-8x7B at full width
    and depth through generate() and the Engine, a 2-layer checkpoint round
    trip, the 2-layer kernel-vs-plain agreement of Mixtral and Qwen1.5-MoE,
    and Qwen1.5-MoE's generate() at full depth."""
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.model import init_quant_params

    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for name in MOE_K8_CASES:
        rows += grouped_rows(name, PRESETS[name], gen, dev)
    rows += grouped_rows("mixtral-8x7b", PRESETS["mixtral-8x7b"], gen, dev, cases=A8_K12_CASES,
                         tag="12a", a8=True)
    counts, report = {}, {}
    for name, path in (("mixtral-8x7b", "moe_generate"), ("qwen1.5-moe-a2.7b", "qwen_generate")):
        cfg = PRESETS[name]
        print(f"[8] MoE generate() path: {name} ({cfg.model_type}), {cfg.num_hidden_layers} "
              f"layers, {cfg.num_local_experts} experts top-{cfg.num_experts_per_tok}, B={BATCH}, "
              f"{PROMPT} + {NEW_TOKENS} tokens, max_seq {MAX_SEQ}")
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = AutoQuickModel(init_quant_params(cfg, seed=0, device=dev), cfg)
        torch.cuda.synchronize()
        weights = torch.cuda.memory_allocated() - before
        print(f"  random QTPU weights (seed 0) in {time.perf_counter() - t0:.1f} s: "
              f"{weights / 1e9:.2f} GB on the card")
        counts[path], report[name] = run_generate(model, cfg, dev, name, generate_launches(cfg))
        report[name]["weights_gb"] = weights / 1e9
        if name == "mixtral-8x7b":
            counts["moe_engine"], report["mixtral_engine"] = phase_engine(
                dataclasses.replace(model.params, blocks=model.params.blocks[:MOE_ENGINE_LAYERS]),
                dataclasses.replace(cfg, num_hidden_layers=MOE_ENGINE_LAYERS), "8")
            report["mixtral_engine_graph_ab"] = engine_graph_ab(model.params, cfg, "13d")
            report["mixtral_checkpoint"] = phase8_checkpoint(model.params, cfg, dev)
            print(f"[12d] Mixtral-8x7B generate() under QUICK_TPU_A8=1 QUICK_TPU_MOE_A8=1")
            with switches(QUICK_TPU_A8="1", QUICK_TPU_MOE_A8="1"):
                counts[A8_MOE_GEN], report["a8_mixtral"] = run_generate(
                    model, cfg, dev, A8_MOE_GEN, generate_launches(cfg))
        del model
        torch.cuda.empty_cache()
        if name == "mixtral-8x7b":  # the 2-layer comparisons between the two models
            report["plain_vs_kernel"] = {
                n: phase8_plain_vs_kernel(n, PRESETS[n], dev) for n in MOE_K8_CASES}
            with switches(QUICK_TPU_A8="1", QUICK_TPU_MOE_A8="1"):  # [12f]
                report["plain_vs_kernel_a8"] = phase8_plain_vs_kernel(
                    name, cfg, dev, tag="12f", tol=TOL_A8_MODEL, expert_kernel="grouped_matmul_a8")
    return counts, report, rows


# ---------------------------------------------------------------------------
# Phase 9: INT8 KV pages (K4q, K5q, K6q; the Engine over INT8 pages)
# ---------------------------------------------------------------------------

def serve_bench_trace(vocab: int, n: int = INT8_REQUESTS, max_seq: int = 1024, seed: int = 0):
    """(prompt, max_new_tokens) of tools/serve_bench.py's requests: lengths
    from its lognormal fit of ShareGPT (:26-30), prompts clipped to
    max_seq // 2 and outputs to max_seq // 3 (:116-118), then each prompt's
    random token ids from the same generator (:124-126), no shared prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    plen = np.clip(rng.lognormal(5.0, 0.9, n).astype(int), 4, max_seq // 2)
    olen = np.clip(rng.lognormal(4.9, 0.8, n).astype(int), 4, max_seq // 3)
    return [([int(t) for t in rng.integers(0, vocab, int(p))], int(o))
            for p, o in zip(plen, olen)]


def int8_pool(gen, dev, g, layers, std=1.0):
    """INT8 k / v pages [layers, P, Hkv, page, D] and their scale tiles,
    quantized (quantize_kv) from random bf16 rows one layer at a time."""
    from quick_tpu_torch.ops.paged_write import quantize_kv

    shape = (layers, g["P"], g["Hkv"], g["page"], g["D"])
    codes = [torch.empty(shape, dtype=torch.int8, device=dev) for _ in range(2)]
    tiles = torch.zeros((layers, g["P"], 8, g["Hkv"] * g["page"]), device=dev)
    for layer in range(layers):
        for j in range(2):
            x = (std * torch.randn(shape[1:], generator=gen, device=dev)).to(torch.bfloat16)
            c, sc = quantize_kv(x)
            codes[j][layer] = c
            tiles[layer, :, j] = sc.reshape(g["P"], -1)
    return codes[0], codes[1], tiles


def off16(t: torch.Tensor) -> torch.Tensor:
    """The same values at a data pointer 16 bytes and one element off (the
    page writes' scalar path)."""
    k = 16 // t.element_size() + 1
    view = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:].view(t.shape)
    view.copy_(t)
    return view


def crossing_starts(g, pos):
    """Chunk starts 2 + i tokens before a page boundary near each of the
    first prefill_rows positions: every chunk crosses into its next page."""
    page, n_pt = g["page"], g["n_pt"]
    return [(p // page) % (n_pt - 1) * page + page - 2 - i for i, p in enumerate(pos[: g["Bp"]])]


def k4q_kinds_check(gen, dev, Hkv, Dk, Dv, tag, scalar=False):
    """[9a / 11a] K4q at every input kind (bf16 and f32 rows, quantized in
    the kernel; int8 codes with their scales, copied), both entries, on a
    9-page pool of 64-token pages: a page-crossing, an inside and a
    trash-page slot, a masked chunk tail, a row of zeros (scale 1e-8) and
    rows whose values divide to exact halves (round half to even); codes
    and scale tiles byte-equal to the plain version outside the trash page.
    ``scalar``: the rows handed over 16 bytes off, so the kernel's scalar
    path runs."""
    from quick_tpu_torch.ops import paged_write as pw

    L, P, page, S, B = 2, 9, 64, 16, 3
    pgs = torch.tensor([[3, 4], [5, 0], [0, 0]], dtype=torch.int32, device=dev)
    offs = torch.tensor([60, 2, 9], dtype=torch.int32, device=dev)  # crossing, inside, trash
    valid = torch.tensor([S, 5, S], dtype=torch.int32, device=dev)
    halves = torch.tensor([127.0, 0.5, -0.5, 1.5, 2.5, -2.5, 126.5, -125.5], device=dev)

    def rows(n, D):
        x = 3 * torch.randn((B, n, Hkv, D), generator=gen, device=dev)
        x[1, 0, 0] = 0.0
        x[0, 0, -1, :8] = halves
        return x

    for kind in (torch.bfloat16, torch.float32, torch.int8):
        for entry in ("decode", "chunk"):
            n = 1 if entry == "decode" else S
            pages = [torch.randint(-127, 128, (L, P, Hkv, page, D), generator=gen, device=dev,
                                   dtype=torch.int8) for D in (Dk, Dv)]
            pages.append(torch.rand((L, P, 8, Hkv * page), generator=gen, device=dev))
            kf, vf = rows(n, Dk), rows(n, Dv)
            extra = {}
            if kind == torch.int8:
                (kn, ks), (vn, vs) = pw.quantize_kv(kf), pw.quantize_kv(vf)
                extra = dict(ks_new=ks, vs_new=vs)
            else:
                kn, vn = kf.to(kind), vf.to(kind)
            got = [t.clone() for t in pages]
            ref = [t.clone() for t in pages]
            kg, vg = (off16(kn), off16(vn)) if scalar else (kn, vn)
            if kind == torch.int8:
                kc, ksc, vc, vsc = kn, ks, vn, vs
            else:
                (kc, ksc), (vc, vsc) = pw.quantize_kv(kn), pw.quantize_kv(vn)
            before = pw.KERNEL_INT8.launches
            if entry == "decode":
                pw.paged_write_decode(*got[:2], kg[:, 0], vg[:, 0], pgs[:, 0], offs, 1,
                                      kv_scales=got[2], **{k: v[:, 0] for k, v in extra.items()})
                pw.paged_write_plain(*ref[:2], kc, vc, pgs[:, :1].expand(B, 2), offs, None, 1,
                                     ref[2], ksc, vsc)
            else:
                pw.paged_write_chunk(*got[:2], kg, vg, pgs, offs, valid, 1, kv_scales=got[2],
                                     **extra)
                pw.paged_write_plain(*ref[:2], kc, vc, pgs, offs, valid, 1, ref[2], ksc, vsc)
            torch.cuda.synchronize()
            key = f"{entry} {kind} Hkv={Hkv} Dk={Dk} Dv={Dv}{' scalar path' if scalar else ''}"
            if pw.KERNEL_INT8.launches != before + 1:
                fail(f"K4q {key}: not launched once")
            if not all(same_bytes(a[:, 1:], b[:, 1:]) for a, b in zip(got, ref)) or \
                    same_bytes(got[2][:, 1:], pages[2][:, 1:]):
                fail(f"K4q {key}: codes or scale tiles differ from the plain version, "
                     "or nothing written")
    print(f"  [{tag}] K4q at every input kind, both entries, zero and half-way rows, "
          f"Hkv={Hkv} Dk={Dk} Dv={Dv}{', scalar path' if scalar else ''}: byte-equal to the "
          "plain version")


def int8_write_rows(cfg, gen, dev, trace):
    """9a / 9b for K4q: its decode and chunk entries against the plain
    version (quantize_kv + scatter) at the INT8 Engine's shapes, codes and
    scale tiles byte-equal outside the trash page; then timed over a
    32-layer pool."""
    from quick_tpu_torch.ops import paged_write as pw

    g = paged_geometry(cfg, ENGINE_INT8)
    B, Bp, S, page, Hkv, D = (g[k] for k in ("B", "Bp", "S", "page", "Hkv", "D"))
    L = cfg.num_hidden_layers
    dec, chunk = trace_positions(trace, g)
    print(f"[9a] K4q (INT8 paged write, quantizes bf16 rows) against quantize_kv + scatter: "
          f"codes and scale tiles byte-equal outside the trash page 0")
    bt = block_table(gen, dev, g, B).long()
    # the serving path's decode (64 slots, 3 idle ones aimed at the trash
    # page) and prefill sub-batch writes, then 8 chunks that cross page
    # boundaries, with masked tails
    cases = [("decode", 1, dec, None), ("chunk", S, chunk, [S] * Bp),
             ("chunk", S, crossing_starts(g, dec), [S - i % 5 for i in range(Bp)])]
    small = int8_pool(gen, dev, g, 2)

    def rows_of(rows, n):
        return [torch.randn((rows, n, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2)]

    def plain(pages, kn, vn, pids, offs, vt, layer):
        (kc, ks), (vc, vs) = pw.quantize_kv(kn), pw.quantize_kv(vn)
        pw.paged_write_plain(pages[0], pages[1], kc, vc, pids, offs, vt, layer, pages[2], ks, vs)

    for entry, n, pos, valid in cases:
        rows = len(pos)
        pids, offs = span_addresses(bt, g, pos, n)
        if entry == "decode":
            pids[-3:] = 0
        vt = torch.tensor(valid or [1] * rows, dtype=torch.int32, device=dev)
        kn, vn = rows_of(rows, n)
        got = [t.clone() for t in small]
        ref = [t.clone() for t in small]
        if entry == "decode":
            pw.paged_write_decode(*got[:2], kn[:, 0], vn[:, 0], pids[:, 0], offs, 1,
                                  kv_scales=got[2])
            plain(ref, kn, vn, pids[:, :1].expand(rows, 2), offs, vt, 1)
        else:
            pw.paged_write_chunk(*got[:2], kn, vn, pids, offs, vt, 1, kv_scales=got[2])
            plain(ref, kn, vn, pids, offs, vt, 1)
        torch.cuda.synchronize()
        key = pw.launch_key(entry, rows, n, Hkv, page, D, torch.int8)
        same = all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(got, ref))
        if not same or torch.equal(got[2][:, 1:], small[2][:, 1:]):
            fail(f"K4q {key}: codes or scale tiles differ from the plain version, or nothing written")
        print(f"  K4q {key}, {'crossing' if pids[:, 1].any() else 'aligned'}: codes and scale "
              f"tiles 1.. byte-equal to the plain version")
    k4q_kinds_check(gen, dev, Hkv, D, D, "9a")
    k4q_kinds_check(gen, dev, Hkv, D, D, "9a", scalar=True)
    k4q_kinds_check(gen, dev, 2, 20, 36, "9a")  # widths of no whole 16-byte unit: scalar

    print("[9b] K4q timing at the INT8 Engine's shapes (INT8 pool of all 32 layers)")
    big = int8_pool(gen, dev, g, L)
    out = []
    for entry, n, pos, _ in cases[:2]:
        rows = len(pos)
        pids, offs = span_addresses(bt, g, pos, n)
        vt = torch.full((rows,), n, dtype=torch.int32, device=dev)
        kn, vn = rows_of(rows, n)
        (kq, ks), (vq, vs) = pw.quantize_kv(kn), pw.quantize_kv(vn)
        r = offs.long()[:, None] + torch.arange(n, device=dev)
        pg = torch.where(r >= page, pids[:, 1:2], pids[:, 0:1]).long()
        row = torch.where(r >= page, r - page, r)
        col = torch.arange(Hkv, device=dev) * page + row[:, :, None]
        if entry == "decode":
            pid0 = pids[:, 0].contiguous()  # the kernel alone: no copy of a strided column

            def kern(i):
                pw.paged_write_decode(*big[:2], kn[:, 0], vn[:, 0], pid0, offs, i % L,
                                      kv_scales=big[2])
        else:
            def kern(i):
                pw.paged_write_chunk(*big[:2], kn, vn, pids, offs, vt, i % L, kv_scales=big[2])

        def lib(i):  # yardstick: index_put_ of the k and v codes and of their scales
            big[0][i % L, pg, :, row] = kq
            big[1][i % L, pg, :, row] = vq
            big[2][i % L, pg[:, :, None], 0, col] = ks
            big[2][i % L, pg[:, :, None], 1, col] = vs

        ms = device_ms(kern, 200)
        plain_ms = device_ms(lambda i: plain(big, kn, vn, pids, offs, vt, i % L), 20)
        lib_ms = device_ms(lib, 200)
        tok = rows * n * Hkv
        b_ms, b_by = bound(2 * tok * D * 2 + 2 * tok * D + 2 * tok * 4 + 3 * rows * 4, 0.0)
        key = pw.launch_key(entry, rows, n, Hkv, page, D, torch.int8)
        print(f"  {key}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us by {b_by}), plain "
              f"{plain_ms * 1e3:.1f} us, index_put_ of codes and scales {lib_ms * 1e3:.1f} us")
        out.append(dict(
            name=f"paged_write_int8[{key}]", route="cuda",
            source="quick_tpu_torch/csrc/paged_write_int8.cu",
            replaces=f"quick_tpu/ops/paged_write.py:{40 if entry == 'decode' else 262}",
            launches=("int8_engine", "paged_write_int8", key), max_abs_err=0.0,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        ))
    del big, small
    return out


def int8_decode_edges(g, gen, dev, qd, lens, scale, cases) -> float:
    """[9a] K5q beyond the Engine's pages: pages of 16 and 256 keys over the
    same 1,024-key table (``cases``: plain, window, softcap, ALiBi); a
    skewed batch, one slot at the whole table and the rest short, so that
    that slot's splits merge; and a launch captured in a CUDA graph,
    replayed after the lengths moved in place, equal to eager launches at
    those lengths bit for bit. Each within TOL of the plain version, and
    row-scaled. Returns the largest error."""
    from quick_tpu_torch.ops import paged_attention as pa

    tol, B, T = TOL["paged_attention"], g["B"], g["n_pt"] * g["page"]
    err = 0.0
    for page in (16, 256):
        gp = dict(g, page=page, n_pt=T // page, P=B * (T // page) + 1)
        pool, bt = int8_pool(gen, dev, gp, 2), block_table(gen, dev, gp, B)
        for name, kw in cases:
            what = f"K5q B={B} page={page}{name}"
            got = pa.paged_decode_attention_int8_cuda(qd, *pool, bt, lens, 1, scale, **kw)
            ref = pa.paged_decode_attention_int8_plain(qd, *pool, bt, lens, 1, scale, **kw)
            err = max(err, max_err(got, ref, tol, what))
            row_scaled_err(got, ref, tol, what)
        del pool
    pool, bt = int8_pool(gen, dev, g, 2), block_table(gen, dev, g, B)
    skew = torch.randint(1, 65, (B,), generator=gen, device=dev).to(torch.int32)
    skew[0] = T
    chunk, splits = pa.int8_split_plan(B, g["Hkv"], g["Hq"] // g["Hkv"], g["page"], T,
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
    for name, kw in cases:
        what = f"K5q B={B} skewed (slot 0 over {-(-T // chunk)} of {splits} splits){name}"
        got = pa.paged_decode_attention_int8_cuda(qd, *pool, bt, skew, 1, scale, **kw)
        ref = pa.paged_decode_attention_int8_plain(qd, *pool, bt, skew, 1, scale, **kw)
        err = max(err, max_err(got, ref, tol, what))
        row_scaled_err(got, ref, tol, what)
    ln = lens.clone()
    out = pa.paged_decode_attention_int8_cuda(qd, *pool, bt, ln, 1, scale)  # eager: the counters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_decode_attention_int8_cuda(qd, *pool, bt, ln, 1, scale)
    for moved in (skew, torch.clamp(lens + 37, max=T), lens):
        ln.copy_(moved)
        graph.replay()
        want = pa.paged_decode_attention_int8_cuda(qd, *pool, bt, moved.clone(), 1, scale)
        ref = pa.paged_decode_attention_int8_plain(qd, *pool, bt, moved, 1, scale)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            fail("K5q: a replayed graph differs from eager launches at the moved lengths")
        what = f"K5q B={B} graph replayed at lengths {moved[:4].tolist()}..."
        err = max(err, max_err(out, ref, tol, what))
        row_scaled_err(out, ref, tol, what)
    del graph, pool
    return err


def int8_attention_rows(cfg, gen, dev, trace):
    """9a / 9b for K5q and K6q: against their plain versions (the Pallas
    INT8 arithmetic) at the INT8 Engine's shapes, K5q also row-scaled;
    then timed over a 32-layer INT8 pool, with SDPA over the gathered,
    dequantized bf16 K/V (gather and dequant not timed) as the yardstick."""
    import torch.nn.functional as F

    from quick_tpu_torch.modules.paged_cache import PagedKVCache
    from quick_tpu_torch.ops import paged_attention as pa

    g = paged_geometry(cfg, ENGINE_INT8)
    B, Bp, S, page, n_pt = (g[k] for k in ("B", "Bp", "S", "page", "n_pt"))
    Hq, Hkv, D = g["Hq"], g["Hkv"], g["D"]
    L = cfg.num_hidden_layers
    scale = D ** -0.5
    dec, chunk = trace_positions(trace, g)
    tol = TOL["paged_attention"]
    print(f"[9a] K5q / K6q (INT8 paged attention) against the plain INT8 arithmetic, "
          f"decode lengths {dec}, chunk starts {chunk}")
    bt = block_table(gen, dev, g, B)
    lens = torch.tensor(dec, dtype=torch.int32, device=dev)
    starts = torch.tensor(chunk, dtype=torch.int32, device=dev)
    cross = torch.tensor(crossing_starts(g, dec), dtype=torch.int32, device=dev)
    qd = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    qc = torch.randn((Bp, S, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    small = int8_pool(gen, dev, g, 2)
    err = {"decode": 0.0, "chunk": 0.0}
    slopes = 2.0 ** (-8.0 * torch.arange(1, Hq + 1, device=dev, dtype=torch.float32) / Hq)
    cases = (("", {}), (", window 100", dict(window=100)), (", softcap 30", dict(logit_softcap=30.0)),
             (", ALiBi", dict(alibi_slopes=slopes)))
    for name, kw in cases:
        got = pa.paged_decode_attention_int8_cuda(qd, *small, bt, lens, 1, scale, **kw)
        ref = pa.paged_decode_attention_int8_plain(qd, *small, bt, lens, 1, scale, **kw)
        err["decode"] = max(err["decode"], max_err(got, ref, tol, f"K5q B={B}{name}"))
        row_scaled_err(got, ref, tol, f"K5q B={B}{name}")
        if "alibi_slopes" in kw:
            continue  # the Engine's model has no ALiBi: K6q's ALiBi is in the card tests
        for st, what in ((starts, ""), (cross, " crossing pages")):
            err["chunk"] = max(err["chunk"], max_err(
                pa.paged_chunk_attention_int8_cuda(qc, *small, bt[:Bp], st, 1, scale, **kw),
                pa.paged_chunk_attention_int8_plain(qc, *small, bt[:Bp], st, 1, scale, **kw),
                tol, f"K6q B={Bp} S={S}{what}{name}"))
    err["decode"] = max(err["decode"], int8_decode_edges(g, gen, dev, qd, lens, scale, cases))
    del small

    print("[9b] K5q / K6q timing at the INT8 Engine's shapes (INT8 pool of all 32 layers)")
    big = int8_pool(gen, dev, g, L)
    ar = torch.arange(n_pt * page, device=dev)
    copies = min(4, L)  # pre-gathered dequantized K/V for the yardstick, > 2x L2 in all

    def dense(rows, T):  # PagedKVCache.layer: the gather, dequantized in bf16
        c = PagedKVCache(big[0], big[1], bt[:rows], lens[:rows], big[2])
        return [[t[:, :, :T].contiguous() for t in c.layer(layer)] for layer in range(copies)]

    def tile_bytes(pages):  # rows 0-1 of each read page's tile, all kv heads
        return pages * 2 * Hkv * page * 4

    rows = []
    # K5q: one query per slot at lengths - 1
    T = max(dec)
    kv = dense(B, T)
    mask = (ar[None, :T] < lens[:, None])[:, None, None, :]
    q4 = qd[:, :, None, :]
    ms = device_ms(lambda i: pa.paged_decode_attention_int8_cuda(
        qd, *big, bt, lens, i % L, scale), 50)
    plain_ms = device_ms(lambda i: pa.paged_decode_attention_int8_plain(
        qd, *big, bt, lens, i % L, scale), 3, warmup=1)
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        q4, *kv[i % copies], attn_mask=mask, scale=scale, enable_gqa=True), 50)
    keys = sum(dec)
    pages = sum(-(-n // page) for n in dec)
    b_ms, b_by = bound(2 * keys * Hkv * D + tile_bytes(pages) + 2 * B * Hq * D * 2
                       + B * (n_pt + 1) * 4, 4.0 * Hq * D * keys, INT8_OPS)
    key5 = pa.launch_key(B, None, Hq, Hkv, page, D, n_pt)
    print(f"  {key5}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa on gathered dequantized K/V {lib_ms * 1e3:.1f} us")
    rows.append(dict(
        name=f"paged_attention_int8[{key5}]", route="cuda",
        source="quick_tpu_torch/csrc/paged_attention_int8.cu",
        replaces="quick_tpu/ops/paged_attention.py:96",
        launches=("int8_engine", "paged_attention_int8", key5), max_abs_err=err["decode"],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    ))
    del kv

    # K6q: a prefill sub-batch's chunk, query i at starts + i
    T = max(chunk) + S
    kv = dense(Bp, T)
    qpos = starts[:, None] + torch.arange(S, device=dev)
    mask = (ar[None, None, :T] <= qpos[:, :, None])[:, None]
    q4 = qc.transpose(1, 2)
    ms = device_ms(lambda i: pa.paged_chunk_attention_int8_cuda(
        qc, *big, bt[:Bp], starts, i % L, scale), 50)
    plain_ms = device_ms(lambda i: pa.paged_chunk_attention_int8_plain(
        qc, *big, bt[:Bp], starts, i % L, scale), 3, warmup=1)
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        q4, *kv[i % copies], attn_mask=mask, scale=scale, enable_gqa=True), 50)
    keys = sum(c + S for c in chunk)
    pages = sum(-(-(c + S) // page) for c in chunk)
    pairs = sum(c * S + S * (S + 1) // 2 for c in chunk)
    b_ms, b_by = bound(2 * keys * Hkv * D + tile_bytes(pages) + 2 * Bp * S * Hq * D * 2
                       + Bp * (n_pt + 1) * 4, 4.0 * Hq * D * pairs)
    key6 = pa.launch_key(Bp, S, Hq, Hkv, page, D, n_pt)
    print(f"  {key6}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa on gathered dequantized K/V {lib_ms * 1e3:.1f} us")
    rows.append(dict(
        name=f"paged_attention_int8[{key6}]", route="cuda",
        source="quick_tpu_torch/csrc/paged_attention_int8.cu",
        replaces="quick_tpu/ops/paged_attention.py:225",
        launches=("int8_engine", "paged_attention_int8", key6), max_abs_err=err["chunk"],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    ))
    del kv, big
    return rows


def phase9_int8_plain_vs_kernel(cfg, dev):
    """9d: model_forward over INT8 pages for a 2-layer full-width model, as
    phase 6's paged check: one 16-token chunk for 4 slots at different
    starts (one crossing a page boundary) over random INT8 context, then
    PHASE6_DECODE decode steps; the card's kernel path (K4q, K5q, K6q)
    against the plain path on the CPU (quantize + scatter, then attention
    over bf16-dequantized pages). After the chunk, the card's codes and
    scale tiles must equal the CPU scatter's for the k / v rows the card
    wrote."""
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.models.model import init_quant_params, model_forward
    from quick_tpu_torch.modules.paged_cache import PagedKVCache
    from quick_tpu_torch.ops import all_kernels

    written = []

    class RecordingCache(PagedKVCache):
        """The card's cache, keeping the k / v rows each update writes."""

        def update(self, layer, k_new, v_new, start):
            written.append((layer, k_new.clone(), v_new.clone(), start.clone()))
            return super().update(layer, k_new, v_new, start)

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    B, S, page, max_seq = 4, 16, 64, 256
    n_pt = max_seq // page
    g = dict(P=1 + B * n_pt, Hkv=cfg.num_key_value_heads, page=page, D=cfg.head_dim)
    starts = [0, 21, 56, 100]  # 56 + 16 crosses the page boundary at 64
    print(f"[9d] 2 layers at full width, INT8 paged cache (page {page}), chunk at starts "
          f"{starts} + {PHASE6_DECODE} decode steps: kernel path (card) vs plain path (CPU), "
          f"tol {TOL_INT8_MODEL} * (1 + |ref|)")
    p_gpu = init_quant_params(cfg2, seed=9, device=dev)
    p_cpu = params_from_flat(params_to_flat(p_gpu), cfg2, device="cpu")
    gen = torch.Generator(device=dev).manual_seed(9)
    bt = (torch.randperm(g["P"] - 1, generator=gen, device=dev) + 1).reshape(B, n_pt).to(torch.int32)
    context = int8_pool(gen, dev, g, 2, std=0.5)

    def make(cls, d):
        c = cls.create(2, g["P"], page, B, max_seq, g["Hkv"], g["D"], torch.int8, device=d)
        for t, src in zip((c.k_pages, c.v_pages, c.kv_scales), context):
            t.copy_(src)
        c.block_table.copy_(bt)
        return c.with_length(torch.tensor(starts, dtype=torch.int32, device=d))

    cg, cc = make(RecordingCache, dev), make(PagedKVCache, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    worst = 0.0
    with torch.inference_mode():
        for step in range(1 + PHASE6_DECODE):
            n = S if step == 0 else 1
            adv = [torch.full((B,), n, dtype=torch.int32, device=d) for d in (dev, "cpu")]
            lg, cg = model_forward(p_gpu, cfg2, toks, cg, advance=adv[0], last_valid=adv[0])
            lc, cc = model_forward(p_cpu, cfg2, toks.cpu(), cc, advance=adv[1], last_valid=adv[1])
            worst = max(worst, max_err(lg[:, -1].cpu(), lc[:, -1], TOL_INT8_MODEL,
                                       "chunk logits" if step == 0 else f"decode step {step}"))
            if step == 0:  # the chunk's rows, rewritten by the CPU scatter
                replay = make(PagedKVCache, "cpu")
                for layer, k_new, v_new, start in written:
                    replay.update(layer, k_new.cpu(), v_new.cpu(), start.cpu())
                for name in ("k_pages", "v_pages", "kv_scales"):
                    if not torch.equal(getattr(cg, name)[:, 1:].cpu(), getattr(replay, name)[:, 1:]):
                        fail(f"INT8 chunk write: the card's {name} differ from the CPU scatter's")
                print("  after the chunk: codes and scale tiles 1.. byte-equal to the CPU "
                      "scatter of the same k / v rows")
            toks = torch.argmax(lg[:, -1], dim=-1)[:, None]  # both paths take it
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels if k.launches}
    want = 2 * (1 + PHASE6_DECODE)
    if launched.get("paged_write_int8") != want or launched.get("paged_attention_int8") != want \
            or launched.get("paged_write") or launched.get("paged_attention"):
        fail(f"the INT8 2-layer path did not run K4q-K6q once per layer per step: {launched}")
    if cg.length.tolist() != cc.length.tolist():
        fail(f"lengths {cg.length.tolist()} / {cc.length.tolist()}")
    print(f"  launches {launched}")
    return worst


# ---------------------------------------------------------------------------
# Phase 10: small-group W4A16 (K9; K8 at G = 64): a GGUF Q4_K file at
# Mistral-7B width (g=32) and Qwen1.5-MoE-A2.7B at g=64
# ---------------------------------------------------------------------------

GGUF_PATH = ROOT / "build" / "chip_smoke_mistral_q4_k.gguf"
#: the GGUF linears' spread, x 1 / sqrt(in): init_quant_params' (0.02). At
#: 1 (unit-variance outputs) a random 2-layer model is chaotic: rounding
#: alone moves its logits by more than TOL_MODEL
GGUF_SPREAD = 0.02
#: K9's (path, M) at the g=32 model's four projections: generate() at B=4
#: (prefill 4 x 128, decode 4) and the 128/128 protocol at B=1 (prefill
#: 128, decode 1); the other decode row counts (M = 2, 3, 5-8, one 8-token
#: tile) and M=16 (the Engine's decode rows, not run at g=32) are checked
#: only
GGUF_K9_CASES = (("gguf_generate", BATCH * PROMPT), ("gguf_generate", BATCH),
                 ("gguf_protocol", PROTOCOL_CTX), ("gguf_protocol", 1),
                 *((None, M) for M in (2, 3, 5, 6, 7, 8)), (None, 16))
#: Qwen1.5-MoE at g=64: K9 runs attention and the shared expert, K8 the
#: routed experts, at generate()'s decode (B=4) and prefill (4 x 128) rows;
#: K8 at T=16 (60 experts, most without a token) is checked only
QWEN_G = 64
QWEN_G_PATH = "qwen_g64_generate"
QWEN_K9_CASES = ((QWEN_G_PATH, BATCH * PROMPT), (QWEN_G_PATH, BATCH))
QWEN_K8_CASES = [(None, 16), (QWEN_G_PATH, BATCH), (QWEN_G_PATH, BATCH * PROMPT)]


def dequant_rows(name, shapes, cases, G, gen, dev, tag="10"):
    """[10a] K9 against its plain version at ``shapes`` ({projection: (K,
    N)}) and ``cases`` ((path, M); path None: checked only), then timed
    with the weights rotated past L2: its bound from the codes, the f32
    scales and zeros, x and out (bytes) or its multiply-adds; its plain
    version; torch.matmul on the same weight dequantized to bf16
    beforehand."""
    from quick_tpu_torch.ops import quantized_matmul as qm

    print(f"[{tag}] K9 (small-group W4A16 GEMM) against its plain version, {name}, G={G}")
    rows = []
    for proj, (K, N) in shapes.items():
        wbytes = K * N // 2 + 2 * (K // G) * N * 4
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / wbytes)))
        ws = rand_qlinear(gen, dev, K, N, copies, group=G)
        wd = []  # the yardstick's bf16 weights, also rotated past L2
        for qw, s, zs in ws[: max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))]:
            codes = qm.unpack_qtpu_tensor(qw, G).float().reshape(K // G, G, N)
            wd.append((codes * s[:, None] - zs[:, None]).reshape(K, N).to(torch.bfloat16))
        for path, M in cases:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            key = qm.dequant_launch_key(M, K, N, G)
            out = qm.quantized_matmul_dequant_cuda(x, *ws[0], G)
            ref = qm.quantized_matmul_dequant_plain(x, *ws[0], G)
            torch.cuda.synchronize()
            err = max_err(out, ref, TOL["quantized_matmul_dequant"], f"K9 {proj} {key}")
            if path is None:
                continue
            n = 10 if M > 8 else 100
            ms = device_ms(lambda i: qm.quantized_matmul_dequant_cuda(x, *ws[i % copies], G), n)
            plain_ms = device_ms(
                lambda i: qm.quantized_matmul_dequant_plain(x, *ws[i % copies], G), 3, warmup=1)
            lib_ms = device_ms(lambda i: torch.matmul(x, wd[i % len(wd)]), n)
            b_ms, b_by = bound(wbytes + M * K * 2 + M * N * 2, 2.0 * M * K * N)
            rows.append(dict(
                name=f"quantized_matmul_dequant[{key}]", route="cuda",
                source="quick_tpu_torch/csrc/quantized_matmul_dequant.cu",
                replaces="quick_tpu/ops/quantized_matmul.py:522",
                launches=(path, "quantized_matmul_dequant", key), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            ))
            print(f"  {key}: {ms * 1e3:.1f} us ({copies} weight copies; bound {b_ms * 1e3:.1f} us "
                  f"by {b_by}), plain {plain_ms * 1e3:.1f} us, torch.matmul bf16 "
                  f"{lib_ms * 1e3:.1f} us")
        del ws, wd
    torch.cuda.empty_cache()
    return rows


def gguf_spec(layers: int) -> dict:
    """The GGUF writer's model: Mistral-7B's widths at ``layers`` layers."""
    return dict(MISTRAL_7B, num_hidden_layers=layers)


def check_gguf_model(model, path: Path, layers: int) -> None:
    """The loaded model has the file's widths, g=32 linears on the card, and
    the embedding, the head and layer 0's and the last layer's linears equal
    byte for byte to the CPU decode of the same file."""
    from quick_tpu_torch.utils import gguf as ug

    cfg, p = model.cfg, model.params
    want = gguf_spec(layers)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads"):
        if getattr(cfg, f) != want[f]:
            fail(f"GGUF config {f} = {getattr(cfg, f)}, the file has {want[f]}")
    if model.device.type != "cuda" or p.blocks[0].attn.qkv_proj.group_size != ug.GROUP:
        fail(f"GGUF model on {model.device}, G={p.blocks[0].attn.qkv_proj.group_size}")
    gg = ug.read_gguf(str(path))
    _, tensors, start, mm = gg
    checks = {
        "embed": (p.embed, ug.load_tensor_float(tensors["token_embd.weight"], mm, start)
                  .to(torch.bfloat16)),
        "lm_head": (p.lm_head.weight, ug.load_tensor_float(tensors["output.weight"], mm, start)
                    .t().to(torch.bfloat16)),
    }
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    for i in (0, layers - 1):
        b, blk = f"blk.{i}", p.blocks[i]
        parts = [ug.load_linear(gg, [f"{b}.attn_q.weight"], hq), ug.load_linear(gg, [f"{b}.attn_k.weight"], hkv),
                 ug.load_linear(gg, [f"{b}.attn_v.weight"])]
        lins = {"qkv": (blk.attn.qkv_proj, {k: torch.cat([q[k] for q in parts], 1) for k in parts[0]}),
                "o": (blk.attn.o_proj, ug.load_linear(gg, [f"{b}.attn_output.weight"])),
                "gate_up": (blk.mlp.gate_up_proj,
                            ug.load_linear(gg, [f"{b}.ffn_gate.weight", f"{b}.ffn_up.weight"])),
                "down": (blk.mlp.down_proj, ug.load_linear(gg, [f"{b}.ffn_down.weight"]))}
        for name, (lin, ref) in lins.items():
            for f, t in ref.items():
                checks[f"blocks.{i}.{name}.{f}"] = (getattr(lin, f), t)
    bad = [k for k, (got, ref) in checks.items() if not same_bytes(got.cpu(), ref)]
    if bad:
        fail(f"GGUF tensors loaded on the card differ from the CPU decode: {bad}")
    print(f"  {len(checks)} tensors equal byte for byte to the CPU decode of the same file")


def phase10_gguf(dev):
    """[10b] A GGUF file at Mistral-7B width (Q4_K block linears, F16
    embedding and output, GGUF_LAYERS layers; random valid blocks from seed 0),
    written under build/ by the test writer, loaded onto the card with
    AutoQuickModel.from_gguf, then generate() at B=4 (as phase 4) and the
    128/128 protocol at B=1, with exact launch counts; the file is deleted
    afterwards."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_port import write_llama_gguf
    from quick_tpu_torch.examples.benchmark import run_round
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.ops import all_kernels

    layers = GGUF_LAYERS
    print(f"[10] GGUF path: Q4_K at Mistral-7B width, {layers} layers, g=32 through K9")
    GGUF_PATH.parent.mkdir(exist_ok=True)
    counts = {}
    try:
        t0 = time.perf_counter()
        nbytes = write_llama_gguf(str(GGUF_PATH), gguf_spec(layers), seed=0, spread=GGUF_SPREAD)
        t_write = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = AutoQuickModel.from_gguf(str(GGUF_PATH))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        weights = torch.cuda.memory_allocated() - before
        print(f"  {nbytes / 1e9:.3f} GB file written in {t_write:.1f} s; from_gguf onto the card "
              f"in {t_load:.2f} s, {weights / 1e9:.2f} GB on the card")
        check_gguf_model(model, GGUF_PATH, layers)
        cfg = model.cfg
        counts["gguf_generate"], stats = run_generate(
            model, cfg, dev, "GGUF g=32", generate_launches(cfg, group=32))
        kernels = all_kernels()
        for k in kernels:
            k.reset_counts()
        row = run_round(model, 1, PROTOCOL_CTX, PROTOCOL_GEN, 1)
        counts["gguf_protocol"] = {k.name: dict(k.launches_by_key) for k in kernels}
        got = {k: v for k, v in counts["gguf_protocol"].items() if v}
        want = generate_launches(cfg, group=32, calls=[(
            1, PROTOCOL_CTX, PROTOCOL_CTX + PROTOCOL_GEN, row["forwards"]["prefill"],
            row["forwards"]["decode"])])
        if got != want:
            fail(f"GGUF 128/128 at B=1: launch counts {got} differ from the calls' {want}")
        print("  run_round B=1 " + json.dumps(row))
        del model
        torch.cuda.empty_cache()
    finally:  # the 4.5 GB file never outlives the phase
        GGUF_PATH.unlink(missing_ok=True)
    stats.update(file_bytes=nbytes, write_s=t_write, load_s=t_load, weights_gb=weights / 1e9,
                 protocol_b1=row)
    return counts, stats


def phase10_qwen(dev):
    """[10c] Qwen1.5-MoE-A2.7B at full width and depth with g=64 random
    QTPU weights (seed 0) through generate() (as phase 4): K8 at G=64 for
    the routed experts, K9 for attention and the shared expert."""
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.model import init_quant_params

    name = "qwen1.5-moe-a2.7b"
    cfg = PRESETS[name]
    print(f"[10] Qwen1.5-MoE generate() at G={QWEN_G}: {cfg.num_hidden_layers} layers, "
          f"{cfg.num_local_experts} experts top-{cfg.num_experts_per_tok}, B={BATCH}, "
          f"{PROMPT} + {NEW_TOKENS} tokens")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = AutoQuickModel(init_quant_params(cfg, seed=0, group_size=QWEN_G, device=dev), cfg)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    counts, stats = run_generate(model, cfg, dev, f"{name} g={QWEN_G}",
                                 generate_launches(cfg, group=QWEN_G))
    stats["weights_gb"] = weights / 1e9
    del model
    torch.cuda.empty_cache()
    return counts, stats


@contextlib.contextmanager
def k9_plain_on_cpu():
    """The CPU path with K9's plain version (weights dequantized to bf16,
    ``_make_kernel_dequant``'s numerics) where the port's CPU dispatch takes
    the output-side form at G = 32 / 64 (the JAX package's CPU default), so
    that a model check holds every kernel against its own plain version.
    K8's plain version keeps its output-side form, which K8 computes."""
    from quick_tpu_torch.ops import quantized_matmul as qm

    orig = qm.quantized_matmul_plain

    def plain(x, qweight, scales, zeros_x_scales, group_size=128, out_dtype=torch.bfloat16):
        if group_size in qm.DEQUANT_GROUPS:
            return qm.quantized_matmul_dequant_plain(x, qweight, scales, zeros_x_scales,
                                                     group_size, out_dtype)
        return orig(x, qweight, scales, zeros_x_scales, group_size, out_dtype)

    qm.quantized_matmul_plain = plain
    try:
        yield
    finally:
        qm.quantized_matmul_plain = orig


def phase10_plain_vs_kernel(dev):
    """[10d] 2 layers at full width, the card's kernel path against the plain
    path on the CPU (K9's plain version in place of the CPU's output-side
    form, k9_plain_on_cpu): a 2-layer Q4_K GGUF at Mistral-7B width, loaded
    on both (params equal byte for byte), through phase 6's dense check
    (K9, K2, K3); Qwen1.5-MoE at g=64 through phase 8's (K9, K8 at G=64, the
    router gap rule). Also printed, not held to a tolerance: how far the
    CPU's two forms of the g=32 model's prefill logits lie apart."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_port import write_llama_gguf
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.convert import params_to_flat
    from quick_tpu_torch.models.model import model_forward
    from quick_tpu_torch.ops.quantized_matmul import KERNEL_DEQUANT

    path = GGUF_PATH.with_name("chip_smoke_mistral_q4_k_2l.gguf")
    try:
        write_llama_gguf(str(path), gguf_spec(2), seed=1, spread=GGUF_SPREAD)
        mg = AutoQuickModel.from_gguf(str(path))
        mc = AutoQuickModel.from_gguf(str(path), device="cpu")
    finally:
        path.unlink(missing_ok=True)
    got, ref = params_to_flat(mg.params), params_to_flat(mc.params)
    if list(got) != list(ref) or not all(same_bytes(got[k], ref[k]) for k in ref):
        fail("the 2-layer GGUF loaded on the card differs from its CPU load")
    del got, ref
    toks = torch.randint(0, mc.cfg.vocab_size, (1, 32), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        out_side = model_forward(mc.params, mc.cfg, toks, last_token_only=True)[0]
        with k9_plain_on_cpu():
            deq = model_forward(mc.params, mc.cfg, toks, last_token_only=True)[0]
    forms = float(((out_side - deq).abs() / (1 + deq.abs())).max())
    print(f"[10] the g=32 model's CPU prefill logits, output-side form (the JAX package's CPU "
          f"route) against dequantized bf16 weights (K9's plain version): max |d| / (1 + |ref|) "
          f"{forms:.3e}")
    with k9_plain_on_cpu():
        err = {"gguf_mistral_g32": phase6_dense_plain_vs_kernel(
            mg.cfg, dev, params=(mg.params, mc.params), tag="10")}
        if KERNEL_DEQUANT.launches != 4 * 2 * (1 + PHASE6_DECODE):
            fail(f"the 2-layer GGUF path ran K9 {KERNEL_DEQUANT.launches} times")
        del mg, mc
        name, steps = "qwen1.5-moe-a2.7b", 2
        err[f"qwen_moe_g{QWEN_G}"] = phase8_plain_vs_kernel(
            name, PRESETS[name], dev, steps=steps, group=QWEN_G, tag="10")
        if KERNEL_DEQUANT.launches != len(k1_projections(PRESETS[name])) * 2 * (1 + steps):
            fail(f"the 2-layer g={QWEN_G} MoE path ran K9 {KERNEL_DEQUANT.launches} times")
    torch.cuda.empty_cache()
    return err, forms


# ---------------------------------------------------------------------------
# Phase 11: DeepSeek-V2-Lite, MLA attention with DeepSeekMoE at g=64
# ---------------------------------------------------------------------------

#: deepseek-ai/DeepSeek-V2-Lite config.json (the fields the port reads); the
#: published vocab and yarn scaling kept
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
    intermediate_size=10944, moe_intermediate_size=1408, num_hidden_layers=27,
    num_attention_heads=16, num_key_value_heads=16, n_shared_experts=2,
    n_routed_experts=64, num_experts_per_tok=6, routed_scaling_factor=1.0,
    kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, topk_method="greedy", n_group=1, topk_group=1,
    scoring_func="softmax", norm_topk_prob=False, first_k_dense_replace=1,
    moe_layer_freq=1, max_position_embeddings=163840, rope_theta=10000.0,
    rope_scaling=dict(type="yarn", factor=40, original_max_position_embeddings=4096,
                      beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707),
    rms_norm_eps=1e-6, tie_word_embeddings=False,
)
#: its quant group: 10944 = 85.5 x 128 allows no larger one
DS_G = 64
#: [11d] the DeepSeek-V2-Lite Engines run their first DS_ENGINE_LAYERS
#: layers (the dense one and three MoE layers) of the 27, for phase 18's
#: room in the time limit (at 27 layers the two timed runs took 30.2 and
#: ~28 s on an H100 80GB HBM3 at 700 W; ``--depth-costs`` runs them at 27)
DS_ENGINE_LAYERS = 4
DS_GEN, DS_ENGINE, DS_ENGINE_INT8 = "deepseek_generate", "deepseek_engine", "deepseek_int8_engine"
#: the INT8 latent pool over the bf16 one: 576 code bytes plus an 8 x 64 f32
#: scale tile per 64-token page (8 B a token), against 1152 bytes a token
DS_INT8_POOL = 608 / 1152
#: K9's (path, M): generate()'s prefill (4 x 128) and decode (4), the
#: Engine's decode windows (16) and prefill sub-batches (8 x 16); K8's
#: (path, T routed tokens) likewise
DS_K9_CASES = ((DS_GEN, BATCH * PROMPT), (DS_GEN, BATCH), (DS_ENGINE, ENGINE["max_slots"]),
               (DS_ENGINE, ENGINE["prefill_rows"] * ENGINE["chunk"]))
DS_K8_CASES = [(DS_GEN, BATCH), (DS_GEN, BATCH * PROMPT), (DS_ENGINE, ENGINE["max_slots"]),
               (DS_ENGINE, ENGINE["prefill_rows"] * ENGINE["chunk"])]


def ds_widths(cfg):
    return (cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim,
            cfg.qk_nope_head_dim, cfg.v_head_dim)


def ds_k9_shapes(cfg):
    """{projection: (K, N)} of the K9 launches: MLA's q, kv_a (N = 576,
    4.5 of K9's 128-wide tiles) and o; the dense first layer's gate_up and
    down; the MoE layers' two ungated shared experts (fused, 2 x 1408)."""
    hq, R, dr, dn, dv = ds_widths(cfg)
    D, F = cfg.hidden_size, cfg.intermediate_size
    Fs = cfg.moe_intermediate_size * cfg.n_shared_experts
    return {"q": (D, hq * (dn + dr)), "kv_a": (D, R + dr), "o": (hq * dv, D),
            "dense_gate_up": (D, 2 * F), "dense_down": (F, D),
            "shared_gate_up": (D, 2 * Fs), "shared_down": (Fs, D)}


def ds_forward_launches(cfg, rows: int, n: int, add) -> None:
    """K9's and K8's launches of ``n`` forwards over ``rows`` tokens: q,
    kv_a and o in every layer; the dense MLP in the first; the shared
    expert and K8 twice in the MoE layers."""
    from quick_tpu_torch.ops.quantized_matmul import dequant_launch_key

    s = ds_k9_shapes(cfg)
    # K13: the attention norm, kv_a's latent norm (on the strided slice
    # ckv[..., :512]), q-LoRA's norm where there is one, the MLP norm
    norms = [cfg.hidden_size, cfg.kv_lora_rank, cfg.hidden_size] + (
        [cfg.q_lora_rank] if cfg.q_lora_rank else [])
    for D in norms:
        add("rms_norm", k13_key(rows, D), n * cfg.num_hidden_layers)
    for i in range(cfg.num_hidden_layers):
        moe = cfg.layer_is_moe(i)
        for proj in ("q", "kv_a", "o") + (("shared_gate_up", "shared_down") if moe
                                          else ("dense_gate_up", "dense_down")):
            add("quantized_matmul_dequant", dequant_launch_key(rows, *s[proj], DS_G), n)
        if moe:
            for key in k8_launch_keys(cfg, rows, DS_G):
                add("grouped_matmul", key, n)


def ds_counter():
    want = {}

    def add(kernel, key, n):
        if n:
            want.setdefault(kernel, {})
            want[kernel][key] = want[kernel].get(key, 0) + n
    return want, add


def ds_generate_launches(cfg) -> dict:
    """generate() at B=4, 128 + 64 tokens: the prefill's expanded MLA runs
    K2 at q / k 192, v 128 in every layer; decode runs the absorbed einsums
    over the dense latent cache (no attention kernel)."""
    from quick_tpu_torch.ops.flash_attention import launch_key

    hq, R, dr, dn, dv = ds_widths(cfg)
    want, add = ds_counter()
    ds_forward_launches(cfg, BATCH * PROMPT, 1, add)
    ds_forward_launches(cfg, BATCH, NEW_TOKENS - 1, add)
    add("rms_norm", k13_key(BATCH, cfg.hidden_size), NEW_TOKENS)  # the final norms
    add("flash_attention", launch_key(BATCH, PROMPT, MAX_SEQ, hq, hq, dn + dr, dv),
        cfg.num_hidden_layers)
    return want


def ds_engine_launches(cfg, stats, engine) -> dict:
    """What the Engine's schedule implies over the latent pages: per
    forward and layer one K4 / K4q write (Hkv 1, k_pe 64, latent 512), and
    at [B, 1] one K10 / K10q; chunks gather the pages and run the absorbed
    einsums (no attention kernel); K9 and K8 as ds_forward_launches."""
    from quick_tpu_torch.ops.mla_paged_attention import launch_key as mla_key
    from quick_tpu_torch.ops.paged_write import launch_key as write_key

    hq, R, dr, dn, dv = ds_widths(cfg)
    L = cfg.num_hidden_layers
    kv = engine.get("dtype", torch.bfloat16)
    int8 = kv == torch.int8
    page = engine["page_size"]
    n_pt = engine["max_seq"] // page
    B, Bp, S = engine["max_slots"], engine["prefill_rows"], engine["chunk"]
    forwards = {
        (B, 1): stats["window_forwards"] + stats["mixed_steps"] - stats["mixed_chunk_steps"],
        (Bp, S): stats["prefill_substeps"],
        (B, S): stats["mixed_chunk_steps"],
    }
    want, add = ds_counter()
    for (rows, s), n in forwards.items():
        if not n:
            continue
        ds_forward_launches(cfg, rows * s, n, add)
        add("rms_norm", k13_key(rows, cfg.hidden_size), n)  # the final norm
        add("paged_write" + ("_int8" if int8 else ""),
            write_key("decode" if s == 1 else "chunk", rows, s, 1, page, dr, kv, Dv=R), L * n)
        if s == 1:
            add("mla_paged_attention", mla_key(rows, hq, R, dr, page, n_pt, int8), L * n)
    return want


def mla_pool(gen, dev, layers, P, page, widths, int8: bool, std=1.0):
    """[k_pe pages, latent pages, scale tiles or None]: [layers, P, 1, page,
    w] for w in ``widths``, bf16, or INT8 codes (quantize_kv, one layer at
    a time) with their [layers, P, 8, page] tiles."""
    from quick_tpu_torch.ops.paged_write import quantize_kv

    shapes = [(P, 1, page, w) for w in widths]
    if not int8:
        return [(std * torch.randn((layers,) + sh, generator=gen, device=dev)).to(torch.bfloat16)
                for sh in shapes] + [None]
    codes = [torch.empty((layers,) + sh, dtype=torch.int8, device=dev) for sh in shapes]
    tiles = torch.zeros((layers, P, 8, page), device=dev)
    for layer in range(layers):
        for j, sh in enumerate(shapes):
            c, sc = quantize_kv((std * torch.randn(sh, generator=gen, device=dev)).to(torch.bfloat16))
            codes[j][layer] = c
            tiles[layer, :, j] = sc.reshape(P, -1)
    return codes + [tiles]


def mla_attention_rows(cfg, gen, dev, trace):
    """[11a / 11b] K10 and K10q against their plain version at the Engine's
    decode (16 slots, lengths from the trace), within TOL and row-scaled,
    and with an empty and a full slot, at 16, 128 and 20 heads, K10 also
    over pages of 48 tokens; then timed over a 27-layer pool: the
    bound from each valid token's latent row read once (bf16 1152 B, INT8
    576 B + two f32 scales) or from the dots; the plain version; SDPA on
    the gathered (dequantized) latent with q = [q_c | q_pe], k = [c | k_pe],
    v = c."""
    import torch.nn.functional as F

    from quick_tpu_torch.modules.mla import mla_softmax_scale
    from quick_tpu_torch.ops import mla_paged_attention as ml
    from quick_tpu_torch.ops.paged_attention import gather_pages

    g = paged_geometry(cfg)
    B, page, n_pt, P = g["B"], g["page"], g["n_pt"], g["P"]
    hq, R, dr, _, _ = ds_widths(cfg)
    L = cfg.num_hidden_layers
    dec, _ = trace_positions(trace, g)
    lens = torch.tensor(dec, dtype=torch.int32, device=dev)
    edge = lens.clone()
    edge[0], edge[1] = 0, n_pt * page  # an empty slot, a full table
    bt = block_table(gen, dev, g, B)
    scale = mla_softmax_scale(cfg)
    q_c = torch.randn((B, hq, R), generator=gen, device=dev).to(torch.bfloat16)
    q_pe = torch.randn((B, hq, dr), generator=gen, device=dev).to(torch.bfloat16)
    tol = TOL["mla_paged_attention"]
    rows = []
    for int8 in (False, True):
        name = "K10q" if int8 else "K10"
        print(f"[11a] {name} (paged MLA decode) against its plain version, "
              f"{'INT8' if int8 else 'bf16'} latent pages, B={B} Hq={hq} R={R} dr={dr}, "
              f"lengths {dec}")
        small = mla_pool(gen, dev, 2, P, page, (dr, R), int8)
        err = 0.0
        for what, ln in (("trace lengths", lens), ("empty and full slots", edge)):
            out = ml.mla_paged_decode_attention_cuda(q_c, q_pe, small[0], small[1], bt, ln, 1,
                                                     scale, small[2])
            ref = ml.mla_paged_decode_attention_plain(q_c, q_pe, small[0], small[1], bt, ln, 1,
                                                      scale, small[2])
            torch.cuda.synchronize()
            err = max(err, max_err(out, ref, tol, f"{name} {what}"))
            if what == "trace lengths":
                row_scaled_err(out, ref, tol, f"{name} {what}")
            elif out[0].any():
                fail(f"{name}: an empty slot gave a non-zero context")
        # DeepSeek-V3's 128 heads (8 head groups a slot) and 20 (a partial group)
        for heads in (128, 20):
            qh = [torch.randn((B, heads, w), generator=gen, device=dev).to(torch.bfloat16)
                  for w in (R, dr)]
            for what, ln in (("trace lengths", lens), ("empty and full slots", edge)):
                out = ml.mla_paged_decode_attention_cuda(*qh, small[0], small[1], bt, ln, 1,
                                                         scale, small[2])
                ref = ml.mla_paged_decode_attention_plain(*qh, small[0], small[1], bt, ln, 1,
                                                          scale, small[2])
                torch.cuda.synchronize()
                err = max(err, max_err(out, ref, tol, f"{name} Hq={heads} {what}"))
                row_scaled_err(out, ref, tol, f"{name} Hq={heads} {what}")
        del small
        if not int8:  # K10 takes any page: 48 keys, no power of two
            g48 = dict(g, page=48, n_pt=-(-n_pt * page // 48))
            g48["P"] = B * g48["n_pt"] + 1
            bt48 = block_table(gen, dev, g48, B)
            pool48 = mla_pool(gen, dev, 2, g48["P"], 48, (dr, R), False)
            for what, ln in (("trace lengths", lens), ("empty and full slots", edge)):
                ln = torch.clamp(ln, max=g48["n_pt"] * 48)
                out = ml.mla_paged_decode_attention_cuda(q_c, q_pe, pool48[0], pool48[1], bt48, ln,
                                                         1, scale)
                ref = ml.mla_paged_decode_attention_plain(q_c, q_pe, pool48[0], pool48[1], bt48,
                                                          ln, 1, scale)
                torch.cuda.synchronize()
                err = max(err, max_err(out, ref, tol, f"{name} page=48 {what}"))
                row_scaled_err(out, ref, tol, f"{name} page=48 {what}")
            del pool48
        big = mla_pool(gen, dev, L, P, page, (dr, R), int8)
        T = max(dec)
        ms = device_ms(lambda i: ml.mla_paged_decode_attention_cuda(
            q_c, q_pe, big[0], big[1], bt, lens, i % L, scale, big[2]), 50)
        plain_ms = device_ms(lambda i: ml.mla_paged_decode_attention_plain(
            q_c, q_pe, big[0], big[1], bt, lens, i % L, scale, big[2]), 5, warmup=1)
        copies = 4  # the yardstick's gathered latent, > 2 x L2 in all
        dense = []
        for layer in range(copies):
            kpe, c = (gather_pages(big[j], bt, layer)[:, :, :T] for j in (0, 1))
            if int8:
                sc = big[2][layer][bt.long()]  # [B, n_pt, 8, page]
                kpe = kpe.to(torch.bfloat16) * sc[:, :, 0].reshape(B, 1, -1, 1)[:, :, :T].to(torch.bfloat16)
                c = c.to(torch.bfloat16) * sc[:, :, 1].reshape(B, 1, -1, 1)[:, :, :T].to(torch.bfloat16)
            dense.append((torch.cat([c, kpe], -1).contiguous(), c.contiguous()))
        q4 = torch.cat([q_c, q_pe], -1)[:, :, None, :]
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        try:
            lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
                q4, *dense[i % copies], attn_mask=mask, scale=scale, enable_gqa=True), 50)
        except RuntimeError as e:
            print(f"  SDPA yardstick not run: {str(e)[:160]}")
            lib_ms = None
        del dense
        tokens = sum(dec)
        per_token = (R + dr) + 8 if int8 else (R + dr) * 2
        nbytes = tokens * per_token + B * hq * (R + dr) * 2 + B * hq * R * 2 + B * (n_pt + 1) * 4
        b_ms, b_by = bound(nbytes, 2.0 * hq * tokens * (R + dr + R))
        key = ml.launch_key(B, hq, R, dr, page, n_pt, int8)
        lib = "n/a" if lib_ms is None else f"{lib_ms * 1e3:.1f} us"
        print(f"[11b] {key}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain "
              f"{plain_ms * 1e3:.1f} us, sdpa on the gathered latent {lib}")
        rows.append(dict(
            name=f"mla_paged_attention[{key}]", route="cuda",
            source="quick_tpu_torch/csrc/mla_paged_attention.cu",
            replaces="quick_tpu/ops/mla_paged_attention.py:" + ("96" if int8 else "41"),
            launches=(DS_ENGINE_INT8 if int8 else DS_ENGINE, "mla_paged_attention", key),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
        ))
        del big
        torch.cuda.empty_cache()
    return rows


def mla_write_rows(cfg, gen, dev, trace):
    """[11a / 11b] K4 and K4q on the latent planes (Hkv 1, k_pe 64, latent
    512) at the Engine's decode and prefill sub-batch writes, plus chunks
    that cross page boundaries: pages (codes) and scale tiles byte-equal to
    the plain scatter (quantize_kv first for INT8) outside the trash page;
    then timed over a 27-layer pool, with index_put_ as the yardstick."""
    from quick_tpu_torch.ops import paged_write as pw

    g = paged_geometry(cfg)
    B, Bp, S, page, P = (g[k] for k in ("B", "Bp", "S", "page", "P"))
    _, R, dr, _, _ = ds_widths(cfg)
    L = cfg.num_hidden_layers
    dec, chunk = trace_positions(trace, g)
    bt = block_table(gen, dev, g, B).long()
    cases = [("decode", 1, dec, None), ("chunk", S, chunk, [S] * Bp),
             ("chunk", S, crossing_starts(g, dec), [S - i % 5 for i in range(Bp)])]

    def rows_of(rows, n):
        return [torch.randn((rows, n, 1, w), generator=gen, device=dev).to(torch.bfloat16)
                for w in (dr, R)]

    def plain(pages, kn, vn, pids, offs, vt, layer):
        if pages[2] is None:
            pw.paged_write_plain(pages[0], pages[1], kn, vn, pids, offs, vt, layer)
            return
        (kc, ks), (vc, vs) = pw.quantize_kv(kn), pw.quantize_kv(vn)
        pw.paged_write_plain(pages[0], pages[1], kc, vc, pids, offs, vt, layer, pages[2], ks, vs)

    out = []
    for int8 in (False, True):
        kv = torch.int8 if int8 else torch.bfloat16
        name = "K4q" if int8 else "K4"
        print(f"[11a] {name} on the MLA latent planes against the plain scatter: pages"
              f"{' and scale tiles' if int8 else ''} byte-equal outside the trash page 0")
        small = mla_pool(gen, dev, 2, P, page, (dr, R), int8)
        for entry, n, pos, valid in cases:
            rows = len(pos)
            pids, offs = span_addresses(bt, g, pos, n)
            if entry == "decode":
                pids[-3:] = 0  # idle slots: colliding writes to the trash page
            vt = torch.tensor(valid or [1] * rows, dtype=torch.int32, device=dev)
            kn, vn = rows_of(rows, n)
            got = [None if t is None else t.clone() for t in small]
            ref = [None if t is None else t.clone() for t in small]
            if entry == "decode":
                pw.paged_write_decode(got[0], got[1], kn[:, 0], vn[:, 0], pids[:, 0], offs, 1,
                                      kv_scales=got[2])
                plain(ref, kn, vn, pids[:, :1].expand(rows, 2), offs, vt, 1)
            else:
                pw.paged_write_chunk(got[0], got[1], kn, vn, pids, offs, vt, 1, kv_scales=got[2])
                plain(ref, kn, vn, pids, offs, vt, 1)
            torch.cuda.synchronize()
            key = pw.launch_key(entry, rows, n, 1, page, dr, kv, Dv=R)
            pairs = [(a, b) for a, b in zip(got, ref) if a is not None]
            if not all(same_bytes(a[:, 1:], b[:, 1:]) for a, b in pairs) or \
                    torch.equal(got[1][:, 1:], small[1][:, 1:]):
                fail(f"{name} {key}: pages differ from the plain scatter, or nothing written")
            print(f"  {name} {key}, {'crossing' if pids[:, 1].any() else 'aligned'}: "
                  f"byte-equal to the plain scatter")
        del small
        if int8:
            k4q_kinds_check(gen, dev, 1, dr, R, "11a")
        big = mla_pool(gen, dev, L, P, page, (dr, R), int8)
        for entry, n, pos, _ in cases[:2]:
            rows = len(pos)
            pids, offs = span_addresses(bt, g, pos, n)
            vt = torch.full((rows,), n, dtype=torch.int32, device=dev)
            kn, vn = rows_of(rows, n)
            r = offs.long()[:, None] + torch.arange(n, device=dev)
            pg = torch.where(r >= page, pids[:, 1:2], pids[:, 0:1]).long()
            row = torch.where(r >= page, r - page, r)
            (kq, ks), (vq, vs) = pw.quantize_kv(kn), pw.quantize_kv(vn)
            if entry == "decode":
                pid0 = pids[:, 0].contiguous()  # the kernel alone: no copy of a strided column

                def kern(i):
                    pw.paged_write_decode(big[0], big[1], kn[:, 0], vn[:, 0], pid0, offs,
                                          i % L, kv_scales=big[2])
            else:
                def kern(i):
                    pw.paged_write_chunk(big[0], big[1], kn, vn, pids, offs, vt, i % L,
                                         kv_scales=big[2])

            def lib(i):  # yardstick: index_put_ of both planes' rows (and scales)
                if not int8:
                    big[0][i % L, pg, :, row] = kn
                    big[1][i % L, pg, :, row] = vn
                    return
                big[0][i % L, pg, :, row] = kq
                big[1][i % L, pg, :, row] = vq
                big[2][i % L, pg, 0, row] = ks[..., 0]
                big[2][i % L, pg, 1, row] = vs[..., 0]

            ms = device_ms(kern, 200)
            plain_ms = device_ms(lambda i: plain(big, kn, vn, pids, offs, vt, i % L), 20)
            lib_ms = device_ms(lib, 200)
            tok = rows * n
            nbytes = (tok * (R + dr) * 2 + tok * ((R + dr) + 8 if int8 else (R + dr) * 2)
                      + 3 * rows * 4)
            b_ms, b_by = bound(nbytes, 0.0)
            key = pw.launch_key(entry, rows, n, 1, page, dr, kv, Dv=R)
            print(f"[11b] {name} {key}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us by {b_by}), "
                  f"plain {plain_ms * 1e3:.1f} us, index_put_ {lib_ms * 1e3:.1f} us")
            sfx = "_int8" if int8 else ""
            line = {(False, "decode"): 76, (False, "chunk"): 211,
                    (True, "decode"): 40, (True, "chunk"): 262}[(int8, entry)]
            out.append(dict(
                name=f"paged_write{sfx}[{key}]", route="cuda",
                source=f"quick_tpu_torch/csrc/paged_write{sfx}.cu",
                replaces=f"quick_tpu/ops/paged_write.py:{line}",
                launches=(DS_ENGINE_INT8 if int8 else DS_ENGINE, "paged_write" + sfx, key),
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms,
            ))
        del big
        torch.cuda.empty_cache()
    return out


def phase11_generate(cfg, dev):
    """[11c] DeepSeek-V2-Lite at full width and depth, random g=64 QTPU
    weights (seed 0) and an untied bf16 lm_head (seed 11), through
    generate() as phase 4: the expanded prefill on K2, decode over the dense
    latent cache."""
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.modules.linear import Linear

    print(f"[11c] generate() path: DeepSeek-V2-Lite, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_local_experts} experts top-{cfg.num_experts_per_tok}, G={DS_G}, B={BATCH}, "
          f"{PROMPT} + {NEW_TOKENS} tokens, max_seq {MAX_SEQ}")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_quant_params(cfg, seed=0, group_size=DS_G, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    D = cfg.hidden_size
    params.lm_head = Linear((torch.randn((D, cfg.vocab_size), generator=gen, device=dev)
                             / math.sqrt(D)).to(torch.bfloat16))
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    print(f"  random weights in {time.perf_counter() - t0:.1f} s: {weights / 1e9:.2f} GB on "
          "the card")
    model = AutoQuickModel(params, cfg)
    counts, stats = run_generate(model, cfg, dev, f"DeepSeek-V2-Lite g={DS_G}",
                                 ds_generate_launches(cfg))
    stats["weights_gb"] = weights / 1e9
    stats["k13_host_ab"] = decode_host_ab(model, cfg, dev, "12b")
    return counts, stats, params


def phase11_paged_plain_vs_kernel(cfg, dev, int8: bool):
    """[11e] 2 layers of DeepSeek-V2-Lite (a dense and an MoE layer) over
    the paged latent cache, bf16 or INT8: one 16-token chunk for 4 slots at
    different starts (one crossing a page boundary) over random context,
    then PHASE6_DECODE decode steps; the card's kernel path (K4 / K4q, K10 /
    K10q, K9, K8) against the plain path on the CPU, with the routing rule
    of ROUTE_GAP."""
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.models.model import init_quant_params, model_forward
    from quick_tpu_torch.modules.paged_cache import PagedKVCache
    from quick_tpu_torch.ops import all_kernels

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    _, R, dr, _, _ = ds_widths(cfg)
    B, S, page, max_seq = 4, 16, 64, 256
    n_pt = max_seq // page
    P = 1 + B * n_pt
    starts = [0, 21, 56, 100]  # 56 + 16 crosses the page boundary at 64
    tol = TOL_INT8_MODEL if int8 else TOL_MODEL
    kv = torch.int8 if int8 else torch.bfloat16
    print(f"[11e] 2 layers of DeepSeek-V2-Lite, {'INT8' if int8 else 'bf16'} latent pages "
          f"(page {page}), chunk at starts {starts} + {PHASE6_DECODE} decode steps: kernel path "
          f"(card) vs plain path (CPU), tol {tol} * (1 + |ref|) on rows whose routing agrees")
    p_gpu = init_quant_params(cfg2, seed=12, group_size=DS_G, device=dev)
    p_cpu = params_from_flat(params_to_flat(p_gpu), cfg2, device="cpu", group_size=DS_G)
    gen = torch.Generator(device=dev).manual_seed(12)
    bt = (torch.randperm(P - 1, generator=gen, device=dev) + 1).reshape(B, n_pt).to(torch.int32)
    context = mla_pool(gen, dev, 2, P, page, (dr, R), int8, std=0.5)
    caches = []
    for d in (dev, torch.device("cpu")):
        c = PagedKVCache.create(2, P, page, B, max_seq, 1, dr, kv, device=d, v_head_dim=R)
        for t, src in zip((c.k_pages, c.v_pages, c.kv_scales), context):
            if src is not None:
                t.copy_(src)
        c.block_table.copy_(bt)
        caches.append(c.with_length(torch.tensor(starts, dtype=torch.int32, device=d)))
    cg, cc = caches
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    flipped_rows = torch.zeros(B, dtype=torch.bool)
    flips, worst, compared = 0, 0.0, 0
    with recorded_routes(cfg.num_experts_per_tok) as routes, torch.inference_mode():
        for step in range(1 + PHASE6_DECODE):
            n = S if step == 0 else 1
            adv = [torch.full((B,), n, dtype=torch.int32, device=d) for d in (dev, "cpu")]
            lg, cg = model_forward(p_gpu, cfg2, toks, cg, advance=adv[0], last_valid=adv[0])
            lc, cc = model_forward(p_cpu, cfg2, toks.cpu(), cc, advance=adv[1], last_valid=adv[1])
            flips += fold_routes(routes, flipped_rows, "DeepSeek-V2-Lite paged", step)
            keep = ~flipped_rows
            if keep.any():
                compared += int(keep.sum())
                what = "chunk logits" if step == 0 else f"decode step {step}"
                worst = max(worst, max_err(lg[keep.to(dev), -1].cpu(), lc[keep, -1], tol,
                                           f"{what} ({int(keep.sum())} of {B} rows)"))
            toks = torch.argmax(lg[:, -1], dim=-1)[:, None]  # both paths take it
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels if k.launches}
    write = "paged_write_int8" if int8 else "paged_write"
    if launched.get(write) != 2 * (1 + PHASE6_DECODE) or \
            launched.get("mla_paged_attention") != 2 * PHASE6_DECODE or compared == 0:
        fail(f"the 2-layer latent paged path did not run {write} per layer per step and K10 "
             f"per layer per decode step, or no row was compared: {launched}")
    if cg.length.tolist() != cc.length.tolist():
        fail(f"lengths {cg.length.tolist()} / {cc.length.tolist()}")
    print(f"  launches {launched}; {flips} tokens routed differently")
    del p_gpu, p_cpu, cg, cc
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, flipped_tokens=flips, rows_compared=compared)


def phase11_deepseek(dev):
    """Phase 11: DeepSeek-V2-Lite. (a, b) K10 / K10q, K4 / K4q on the latent
    planes, K2 at q / k 192, v 128, K9 and K8 at its shapes, each against
    its plain version, then timed; (c) generate() at full width and depth;
    (d) the Engine over bf16, then INT8 latent pages at DS_ENGINE_LAYERS of
    its 27 layers (one counted, timed run each, one turn profiled); (e) a
    2-layer checkpoint round trip and the 2-layer kernel path against the
    plain path for generate() and the
    paged path over bf16 and INT8 pages (K9's plain version on the CPU)."""
    from quick_tpu_torch import ModelConfig

    cfg = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE)
    gen = torch.Generator(device=dev).manual_seed(11)
    trace = serving_trace(cfg.vocab_size)
    hq, R, dr, dn, dv = ds_widths(cfg)
    rows = mla_attention_rows(cfg, gen, dev, trace)
    rows += mla_write_rows(cfg, gen, dev, trace)
    rows.append(flash_row(cfg, gen, dev, path=DS_GEN, heads=(hq, hq, dn + dr, dv), tag="11a"))
    rows += dequant_rows("DeepSeek-V2-Lite", ds_k9_shapes(cfg), DS_K9_CASES, DS_G, gen, dev,
                         tag="11a")
    rows += grouped_rows("deepseek-v2-lite", cfg, gen, dev, group=DS_G, cases=DS_K8_CASES,
                         tag="11a")
    counts, report = {}, {}
    counts[DS_GEN], report["generate"], params = phase11_generate(cfg, dev)
    cut = (dataclasses.replace(params, blocks=params.blocks[:DS_ENGINE_LAYERS]),
           dataclasses.replace(cfg, num_hidden_layers=DS_ENGINE_LAYERS))
    for path, engine in ((DS_ENGINE, ENGINE), (DS_ENGINE_INT8, dict(ENGINE, dtype=torch.int8))):
        counts[path], report[path] = phase_engine(*cut, "11d", engine, trace,
                                                  ds_engine_launches, warmup=False)
    del cut
    report["engine_graph_ab"] = {
        path: engine_graph_ab(params, cfg, "13d", engine, trace)
        for path, engine in ((DS_ENGINE, ENGINE), (DS_ENGINE_INT8, dict(ENGINE, dtype=torch.int8)))}
    # measurement only, at phase 5's depth: the host's calls a layer do not
    # depend on it, and a full-depth Engine's set-up costs the script ~20 s
    report["engine_k13_host_ab"] = engine_host_ab(
        dataclasses.replace(params, blocks=params.blocks[:ENGINE_LAYERS]),
        dataclasses.replace(cfg, num_hidden_layers=ENGINE_LAYERS), "12b")
    pools = [sum(report[p]["runs"][0]["pool_bytes"]) for p in (DS_ENGINE, DS_ENGINE_INT8)]
    report["int8_pool_ratio"] = pools[1] / pools[0]
    print(f"[11d] INT8 latent pool / bf16 latent pool: {pools[1] / pools[0]:.4f} "
          f"(predicted {DS_INT8_POOL:.4f})")
    if abs(pools[1] / pools[0] / DS_INT8_POOL - 1) > 0.01:
        fail(f"the INT8 latent pool is {pools[1] / pools[0]:.4f} of the bf16 one")
    report["checkpoint"] = phase8_checkpoint(params, cfg, dev, group=DS_G, tag="11e")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with k9_plain_on_cpu():
        report["plain_vs_kernel"] = dict(
            generate=phase8_plain_vs_kernel("deepseek-v2-lite", cfg, dev, prompt=PROMPT, steps=2,
                                            max_seq=MAX_SEQ, group=DS_G, tag="11e"),
            paged_bf16=phase11_paged_plain_vs_kernel(cfg, dev, False),
            paged_int8=phase11_paged_plain_vs_kernel(cfg, dev, True))
    if report["plain_vs_kernel"]["generate"]["launches"].get("flash_attention") != 2:
        fail("the 2-layer DeepSeek generate() path did not run K2 once per layer at prefill")
    return counts, report, rows


# ---------------------------------------------------------------------------
# Phase 12: W4A8 (K11, K11f, K12) and the standalone RMSNorm (K13)
# ---------------------------------------------------------------------------

#: phase 12's paths: generate() at Mistral-7B width under QUICK_TPU_A8, then
#: with QUICK_TPU_A8_FUSED added; Mixtral-8x7B's generate() under A8 and
#: QUICK_TPU_MOE_A8; the INT8 Engine of phase 9c under A8
A8_GEN, A8_FUSED_GEN = "a8_generate", "a8_fused_generate"
A8_MOE_GEN, A8_INT8_ENGINE = "a8_moe_generate", "a8_int8_engine"
#: (path of K11's launches, path of K11f's, M): generate()'s prefill, the
#: INT8 Engine's [8, 16] chunks, one ragged M (checked only)
A8_CASES = ((A8_GEN, A8_FUSED_GEN, BATCH * PROMPT),
            (A8_INT8_ENGINE, None, ENGINE_INT8["prefill_rows"] * ENGINE_INT8["chunk"]),
            (None, None, 200))
#: K12 at Mixtral-8x7B's routed shapes: decode (T = 4: Mp 256, bm 32) and
#: prefill (T = 512: Mp 2048, bm 128)
A8_K12_CASES = [(A8_MOE_GEN, BATCH), (A8_MOE_GEN, BATCH * PROMPT)]
#: K13 (path, M, D, row stride or None): generate()'s final norms at decode
#: and its prefill norms, the Engine's [16, 1] decode, the INT8 Engine's
#: [64, 1] decode, DeepSeek-V2-Lite's latent norm on ckv[..., :512] at the
#: Engine's decode
K13_CASES = (("generate", BATCH, 4096, None), ("generate", BATCH * PROMPT, 4096, None),
             ("engine", ENGINE["max_slots"], 4096, None),
             ("int8_engine", ENGINE_INT8["max_slots"], 4096, None),
             (DS_ENGINE, ENGINE["max_slots"], 512, 576))
#: phase 12f logits, 2 layers under A8: an activation code may flip by one
#: where the two paths' upstream bf16 rounding differs
TOL_A8_MODEL = 2e-2
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)


@contextlib.contextmanager
def switches(**env):
    """The JAX package's environment switches (QUICK_TPU_A8, ...), which the
    port reads at each call, set for a block and restored after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def a8_rows(name, shapes, cases, G, gen, dev, tag="12a"):
    """[12a, 12b] K11 (and K11f at G = 128) against their plain versions at
    ``shapes`` {projection: (K, N)} and the rows M of ``cases``, K11f also
    equal to K11 bit for bit; then timed where a case names a path, weights
    rotated past L2: the bound from the packed weights, the int8 codes and row scales
    (bf16 x for K11f) and the bf16 output, or from the int8 operations; the
    plain version; one torch.matmul on dequantized bf16 weights (the
    yardstick), torch._int_mm on int8 operands of the same size (the int8
    tensor cores with no groups) and the W4A16 kernel (K1; K9 at G != 128)
    at the same shape."""
    from quick_tpu_torch.ops import quantized_matmul as qm

    print(f"[{tag}] K11{' / K11f' if G == 128 else ''} (W4A8 GEMM) against the plain version, "
          f"{name}, G={G}, tol {TOL['quantized_matmul_a8']} * (1 + |ref|)")
    rows = []
    for proj, (K, N) in shapes.items():
        wbytes = K * N // 2 + 2 * (K // G) * N * 4
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / wbytes)))
        ws = rand_qlinear(gen, dev, K, N, copies, group=G)
        wd = b8 = None
        for p11, p11f, M in cases:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            xq, sx = qm.quantize_activations(x)
            ref = qm.quantized_matmul_a8_plain(x, *ws[0], G)
            out = qm.launch_a8(xq, sx, *ws[0], G)
            torch.cuda.synchronize()
            errs = {False: max_err(out, ref, TOL["quantized_matmul_a8"],
                                   f"K11 {proj} {qm.a8_launch_key(M, K, N, G, False)}")}
            if G == 128:
                fused = qm.launch_a8(x, None, *ws[0], G)
                torch.cuda.synchronize()
                errs[True] = max_err(fused, ref, TOL["quantized_matmul_a8"],
                                     f"K11f {proj} {qm.a8_launch_key(M, K, N, G, True)}")
                same = torch.equal(fused, out)
                print(f"    K11f against K11: {'bit-equal' if same else 'NOT bit-equal'}")
                if not same:  # one body, one plan, the same codes: the same bits
                    fail(f"K11f {proj} M={M} differs from K11")
            for is_fused, path in ((False, p11), (True, p11f)):
                if path is None:
                    continue
                if wd is None:  # the yardsticks' operands, once per projection
                    wd = []
                    for qw, s, zs in ws[: max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))]:
                        codes = qm.unpack_qtpu_tensor(qw, G).float().reshape(K // G, G, N)
                        wd.append((codes * s[:, None] - zs[:, None]).reshape(K, N).to(torch.bfloat16))
                    b8 = [torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                                        dtype=torch.int8).t()
                          for _ in range(max(1, min(4, math.ceil(2 * L2_BYTES / (K * N)))))]
                key = qm.a8_launch_key(M, K, N, G, is_fused)
                arg = (x, None) if is_fused else (xq, sx)
                n = 10
                ms = device_ms(lambda i: qm.launch_a8(*arg, *ws[i % copies], G), n)
                plain_ms = device_ms(lambda i: qm.quantized_matmul_a8_plain(
                    x, *ws[i % copies], G), 2, warmup=1)
                lib_ms = device_ms(lambda i: torch.matmul(x, wd[i % len(wd)]), n)
                try:
                    int_mm_ms = device_ms(lambda i: torch._int_mm(xq, b8[i % len(b8)]), n)
                except (AttributeError, RuntimeError) as e:
                    print(f"    torch._int_mm yardstick not run: {type(e).__name__}: {str(e)[:160]}")
                    int_mm_ms = None
                if G == 128:
                    w16_ms = device_ms(lambda i: qm.quantized_matmul_cuda(x, *ws[i % copies]), n)
                else:
                    w16_ms = device_ms(lambda i: qm.quantized_matmul_dequant_cuda(
                        x, *ws[i % copies], G), n)
                nbytes = wbytes + M * N * 2 + (M * K * 2 if is_fused else M * (K + 4))
                b_ms, b_by = bound(nbytes, 2.0 * M * K * N, INT8_OPS)
                imm = "n/a" if int_mm_ms is None else f"{int_mm_ms * 1e3:.1f} us"
                print(f"  {'K11f' if is_fused else 'K11'} {proj} {key}: {ms * 1e3:.1f} us (bound "
                      f"{b_ms * 1e3:.1f} us by {b_by}), plain {plain_ms * 1e3:.1f} us, "
                      f"torch.matmul bf16 {lib_ms * 1e3:.1f} us, torch._int_mm {imm}, "
                      f"W4A16 {w16_ms * 1e3:.1f} us")
                rows.append(dict(
                    name=f"quantized_matmul_a8[{key}]", route="cuda",
                    source="quick_tpu_torch/csrc/quantized_matmul_a8.cu",
                    replaces="quick_tpu/ops/quantized_matmul.py:" + ("324" if is_fused else "284"),
                    launches=(path, "quantized_matmul_a8", key), max_abs_err=errs[is_fused],
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    int_mm_ms=int_mm_ms, w4a16_ms=w16_ms,
                ))
        del ws, wd, b8
        torch.cuda.empty_cache()
    return rows


def rms_norm_rows(gen, dev, cases=K13_CASES, tag="12a"):
    """[12a, 12b] K13 against rms_norm_plain at ``cases`` (a strided
    last-dim slice where the case gives a row stride): within one bf16 step
    of the plain value; then timed (the rows stay in L2, as the path's
    freshly written activations do): the bound from x read, the weight read
    and y written; the plain version; torch.nn.functional.rms_norm."""
    from quick_tpu_torch.ops import norms

    print(f"[{tag}] K13 (RMSNorm) against rms_norm_plain, within one bf16 step")
    rows = []
    for path, M, D, ld in cases:
        base = (3 * torch.randn((M, ld or D), generator=gen, device=dev)).to(torch.bfloat16)
        x = base[:, :D]
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
        out = norms.rms_norm_cuda(x, w, 1e-5)
        ref = norms.rms_norm_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        steps = float((d / (2.0 ** -7 * ref.float().abs()).clamp_min(1e-30)).max())
        key = norms.launch_key(M, D)
        what = f"K13 {key}{f' (row stride {ld})' if ld else ''}"
        print(f"  {what}: max_abs_err {float(d.max()):.3e}, max |err| / bf16 step {steps:.3f}")
        if steps > 1 or out.shape != ref.shape:
            fail(f"{what} disagrees with its plain version by more than one bf16 step")
        ms = device_ms(lambda i: norms.rms_norm_cuda(x, w, 1e-5), 200)
        plain_ms = device_ms(lambda i: norms.rms_norm_plain(x, w, 1e-5), 50)
        try:
            lib_ms = device_ms(lambda i: torch.nn.functional.rms_norm(x, (D,), w, 1e-5), 200)
        except (AttributeError, RuntimeError) as e:
            print(f"    torch.nn.functional.rms_norm not run: {type(e).__name__}: {str(e)[:160]}")
            lib_ms = None
        b_ms, b_by = bound(2 * M * D * 2 + D * 2, 4.0 * M * D, F32_FLOPS)
        print(f"  {key}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us by {b_by}), plain "
              f"{plain_ms * 1e3:.2f} us, F.rms_norm "
              f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}")
        rows.append(dict(
            name=f"rms_norm[{key}{f' ld={ld}' if ld else ''}]", route="cuda",
            source="quick_tpu_torch/csrc/rms_norm.cu", replaces="quick_tpu/ops/norms.py:38",
            launches=(path, "rms_norm", key), max_abs_err=float(d.max()),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        ))
    return rows


def k13_graph_pdl(gen, dev, layers: int = 32) -> dict:
    """[12b] K13 in a captured graph of ``layers`` x (K13, then K1's qkv
    projection) at the Engine's decode rows (M = 16, D = 4096), replayed
    with K13's programmatic dependent launch and with a plain one, in turns
    (on, off, off, on): ms a replay of each and their ratio."""
    from quick_tpu_torch.ops import norms
    from quick_tpu_torch.ops import quantized_matmul as qm

    M, D = ENGINE["max_slots"], 4096
    x = torch.randn((M, D), generator=gen, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    wq = rand_qlinear(gen, dev, D, 6144)[0]

    def step():
        for _ in range(layers):
            qm.quantized_matmul_cuda(norms.rms_norm_cuda(x, w, 1e-5), *wq)

    graphs = {}
    for pdl in (True, False):
        norms.NORM_PDL = pdl
        try:
            step()  # eager: makes any counters
            graphs[pdl] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[pdl]):
                step()
        finally:
            norms.NORM_PDL = True
    ms = {True: [], False: []}
    for pdl in (True, False, False, True):
        ms[pdl].append(device_ms(lambda i, g=graphs[pdl]: g.replay(), 20))
    out = dict(layers=layers, rows=M, pdl_ms=sum(ms[True]) / 2,
               plain_launch_ms=sum(ms[False]) / 2)
    out["plain_over_pdl"] = out["plain_launch_ms"] / out["pdl_ms"]
    print(f"[12b] a graph of {layers} x (K13, K1 qkv) at M = {M}: " + json.dumps(out))
    del graphs
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_norms():
    """Measurement only: every standalone rms_norm of the port runs as the
    plain torch ops (``rms_norm_plain``), as it did before K13, for a block;
    the K13 side of phase 12b's host comparison is the path as it runs."""
    from quick_tpu_torch.models import model
    from quick_tpu_torch.modules import blocks, mla
    from quick_tpu_torch.ops import norms, quantized_matmul as qm
    from quick_tpu_torch.quantize import awq

    mods = (norms, blocks, mla, model, qm, awq)
    orig = [m.rms_norm for m in mods]
    for m in mods:
        m.rms_norm = norms.rms_norm_plain
    try:
        yield
    finally:
        for m, f in zip(mods, orig):
            m.rms_norm = f


def decode_host_ab(model, cfg, dev, tag: str, steps: int = 8) -> dict:
    """[12b] ``steps`` decode steps of generate() at B=4 after a 128-token
    prefill, profiled with K13 and with plain norms (host_ab)."""
    from quick_tpu_torch.runtime import decode_loop, make_cache, prefill

    print(f"[{tag}] the decode step's host cost of the norms: {cfg.model_type}, B={BATCH}")
    gen = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    cache = make_cache(cfg, BATCH, MAX_SEQ, device=dev)
    logits, cache = prefill(model.params, cfg, prompts, cache)
    first = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    out = host_ab(lambda: decode_loop(model.params, cfg, first, cache, steps, _graph=False),
                  steps, steps * cfg.num_hidden_layers)
    del cache
    torch.cuda.empty_cache()
    return out


def host_ab(run, steps: int, per: int) -> dict:
    """[12b] ``run()`` (``steps`` steps) profiled twice, with K13 and then
    with plain_norms: aten calls per ``per`` (layer-steps), the device busy
    share and the wall time per step of each."""
    out = {}
    for mode in ("k13", "plain_norms"):
        with plain_norms() if mode == "plain_norms" else contextlib.nullcontext():
            prof = device_profile(run, steps)
        out[mode] = dict(aten_calls_per_layer=prof["aten_calls_per_step"] * steps / per,
                         device_busy_share=prof["device_busy_share"],
                         wall_ms_per_step=prof["wall_ms_per_step"],
                         device_busy_ms_per_step=prof["device_busy_ms_per_step"])
    print("  K13 against plain norms: " + json.dumps(out))
    return out


def engine_host_ab(params, cfg, tag: str, engine=ENGINE) -> dict:
    """[12b] One Engine with every slot given a 32-token prompt and 48 new
    tokens, stepped until all its slots decode, then one scheduler turn (a
    decode window of [max_slots, 1] forwards) profiled with K13 and the next
    with plain norms (host_ab). The host's cost of a [B, 1] forward does not
    depend on the lengths in the pages, so a short trace reaches it fast."""
    from quick_tpu_torch.runtime import Engine

    print(f"[{tag}] the Engine's host cost of the norms: {cfg.model_type}, "
          f"{cfg.num_hidden_layers} layers, one decode turn with K13, the next with plain norms "
          "(eager windows: a graph replays its capture's norms)")
    eng = Engine(params, cfg, **engine, _graphs=False)
    for i in range(engine["max_slots"]):
        eng.submit([(i * 32 + j) % cfg.vocab_size for j in range(32)], 48)
    while eng.has_work and len(eng.ready_slots()) < engine["max_slots"]:
        eng.step()
    out = {}
    for mode in ("k13", "plain_norms"):
        before = eng.stats["window_forwards"] + eng.stats["prefill_substeps"] + eng.stats["mixed_steps"]
        with plain_norms() if mode == "plain_norms" else contextlib.nullcontext():
            prof = device_profile(lambda: eng.step(), 1)
        fw = eng.stats["window_forwards"] + eng.stats["prefill_substeps"] + eng.stats["mixed_steps"] - before
        out[mode] = dict(forwards=fw, aten_calls_per_layer=prof["aten_calls_per_step"] / max(fw, 1)
                         / cfg.num_hidden_layers, device_busy_share=prof["device_busy_share"],
                         wall_ms=prof["wall_ms_per_step"],
                         device_busy_ms=prof["device_busy_ms_per_step"])
    print("  K13 against plain norms: " + json.dumps(out))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase12_generate(params, cfg, dev):
    """[12c] generate() at Mistral-7B width and full depth, as phase 4, on
    phase 4's weights: under QUICK_TPU_A8 (K11 at the prefill's 512 rows, K1
    without prologues at the decode's 4, K13 at every norm), then with
    QUICK_TPU_A8_FUSED added (K11f); exact launch counts, the same greedy
    tokens in every run of a mode."""
    from quick_tpu_torch.models.auto import AutoQuickModel

    model = AutoQuickModel(params, cfg)
    counts, stats = {}, {}
    for path, env in ((A8_GEN, dict(QUICK_TPU_A8="1")),
                      (A8_FUSED_GEN, dict(QUICK_TPU_A8="1", QUICK_TPU_A8_FUSED="1"))):
        print(f"[12c] generate() path under {' '.join(f'{k}={v}' for k, v in env.items())}: "
              f"{cfg.num_hidden_layers} layers, B={BATCH}, {PROMPT} + {NEW_TOKENS} tokens")
        with switches(**env):
            counts[path], stats[path] = run_generate(model, cfg, dev, path, generate_launches(cfg))
    return counts, stats

# ---------------------------------------------------------------------------
# Phase 13: the decode layer tail (K14); the decode step as one CUDA graph
# ---------------------------------------------------------------------------

#: phase 13b's path: phase 4's generate() under QUICK_TPU_LAYER_TAIL=1
TAIL_GEN = "generate_layer_tail"
TAIL_ROWS = tuple(range(1, 9))  # K14 checked and timed at every M = 1-8 (4: the path's)
#: K14 against its plain version, of max|ref|: tests/test_layer_tail.py's
#: bound between two orders of the f32 group sums (about two bf16 steps)
TOL_TAIL = 8e-3
#: phase 13e: penalised greedy generate() at 2 layers, PENALTY_TOKENS tokens.
#: A random model's greedy stream repeats one token with a lead of more
#: than 16 logits (on an H100 80GB HBM3 at 700 W, 3.0 / 2.0 / 2.0 moved no
#: token, logits up to 27), so the frequency penalty forbids a repeat and
#: every later token moves
PENALTIES = dict(repetition_penalty=1.3, frequency_penalty=100.0, presence_penalty=0.5)
PENALTY_TOKENS = 8
#: phase 13d: the Engines' graphed and eager streams, at this depth
ENGINE_AB_LAYERS = 2


def tail_rows(cfg, gen, dev):
    """[13a] K14 at Mistral-7B width (o 4096x4096, gate_up 4096x28672, down
    14336x4096) and M = 1-8 against its plain version, twice (the same
    bits: split sums in a fixed order), then timed beside its plain version,
    the unfused K1 chain the path runs without the switch (o; residual;
    gate_up with the RMSNorm prologue; down with the SiLU-GLU prologue;
    residual) and, as a yardstick, the three torch.matmul on bf16 weights;
    two weight copies rotated (217 MB: past L2). No one PyTorch call
    computes the tail (library_ms null). Returns (the M = 4 row, the
    numbers of every M)."""
    from quick_tpu_torch.ops import fused_layer_tail as ft
    from quick_tpu_torch.ops import quantized_matmul as qm

    sh = gemm_shapes(cfg)
    (K1, D), (_, N2), (I, _) = sh["o"], sh["gate_up"], sh["down"]
    eps = cfg.rms_norm_eps
    print(f"[13a] K14 (the decode layer tail) against its plain version, K1={K1} D={D} I={I}, "
          f"tol {TOL_TAIL} * max|ref|")
    projections = (sh["o"], sh["gate_up"], sh["down"])
    ws = [rand_qlinear(gen, dev, K, N, copies=2) for K, N in projections]
    wd = []
    for (K, N), ((qw, sc, zs), _) in zip(projections, ws):
        codes = qm.unpack_qtpu_tensor(qw).float().reshape(K // 128, 128, N)
        wd.append((codes * sc[:, None] - zs[:, None]).reshape(K, N).to(torch.bfloat16))
        del codes
    nw = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    wbytes = sum(K * N // 2 + 2 * (K // 128) * N * 4 for K, N in projections)
    row, every = None, {}
    for M in TAIL_ROWS:
        ao, xr, xn = (torch.randn((M, n), generator=gen, device=dev).to(torch.bfloat16)
                      for n in (K1, D, D))
        x2 = torch.randn((M, I), generator=gen, device=dev).to(torch.bfloat16)

        def args(c):
            return (ao, xr, nw, *ws[0][c], *ws[1][c], *ws[2][c])

        out = ft.fused_layer_tail_cuda(*args(0), eps=eps)
        again = ft.fused_layer_tail_cuda(*args(0), eps=eps)
        ref = ft.fused_layer_tail_plain(*args(0), eps=eps)
        torch.cuda.synchronize()
        key = ft.launch_key(M, K1, D, I)
        d = (out.float() - ref.float()).abs()
        err, rmax = float(d.max()), float(ref.float().abs().max())
        print(f"  K14 {key}: max_abs_err {err:.3e}, max|ref| {rmax:.3e}, "
              f"err / max|ref| {err / rmax:.3e} (tol {TOL_TAIL})")
        if not torch.isfinite(out.float()).all() or err > TOL_TAIL * rmax:
            fail(f"K14 {key} disagrees with its plain version")
        if not torch.equal(out, again):
            fail(f"K14 {key} gave other bits on a second launch")

        def chain(i):
            c = i % 2
            h = xr + qm.quantized_matmul_cuda(ao, *ws[0][c])
            gu = qm.quantized_matmul_cuda(h, *ws[1][c], norm_weight=nw, norm_eps=eps)
            return h + qm.quantized_matmul_cuda(gu, *ws[2][c], glu=True)

        def matmuls(i):
            torch.matmul(ao, wd[0])
            torch.matmul(xn, wd[1])
            torch.matmul(x2, wd[2])

        ms = device_ms(lambda i: ft.fused_layer_tail_cuda(*args(i % 2), eps=eps), 50)
        chain_ms = device_ms(chain, 50)
        mm_ms = device_ms(matmuls, 50)
        plain_ms = device_ms(lambda i: ft.fused_layer_tail_plain(*args(i % 2), eps=eps), 3,
                             warmup=1)
        b_ms, b_by = bound(wbytes + (M * K1 + 2 * M * D + D) * 2,
                           2.0 * M * (K1 * D + D * N2 + I * D))
        every[key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                          k1_chain_ms=chain_ms, matmul_sum_ms=mm_ms, max_abs_err=err)
        print(f"  {key}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by {b_by}), plain "
              f"{plain_ms * 1e3:.1f} us, the unfused K1 chain {chain_ms * 1e3:.1f} us, three "
              f"torch.matmul on bf16 weights {mm_ms * 1e3:.1f} us")
        if M == BATCH:
            row = dict(
                name=f"fused_layer_tail[{key}]", route="cuda",
                source="quick_tpu_torch/csrc/fused_layer_tail.cu",
                replaces="quick_tpu/ops/fused_layer_tail.py:70",
                launches=(TAIL_GEN, "fused_layer_tail", key), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                k1_chain_ms=chain_ms, matmul_sum_ms=mm_ms,
            )
    del ws, wd
    torch.cuda.empty_cache()
    return row, every


def phase13_generate(params, cfg, dev):
    """[13b] generate() at Mistral-7B width and full depth on phase 4's
    weights under QUICK_TPU_LAYER_TAIL=1 (B=4, 128 + 64 tokens): K14 at
    every decode layer, K1 at M = 4 for qkv only; exact launch counts, the
    eager loop's tokens equal to the graphed one's, ms per step and busy
    share of both (phase 4 has them without the switch)."""
    from quick_tpu_torch.models.auto import AutoQuickModel

    print(f"[13b] generate() path under QUICK_TPU_LAYER_TAIL=1: {cfg.num_hidden_layers} "
          f"layers, B={BATCH}, {PROMPT} + {NEW_TOKENS} tokens")
    with switches(QUICK_TPU_LAYER_TAIL="1"):
        return run_generate(AutoQuickModel(params, cfg), cfg, dev, TAIL_GEN,
                            generate_launches(cfg))


def counted(fn):
    """fn()'s result and the launches it counted, by kernel and key."""
    from quick_tpu_torch.ops import all_kernels

    for k in all_kernels():
        k.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: dict(k.launches_by_key) for k in all_kernels() if k.launches}


def same_planes(what: str, a: dict, b: dict) -> None:
    """Fail unless the cache tensors ``a`` and ``b`` (by name) are bit-equal:
    a graphed and an eager run launch the same kernels in the same order,
    and the greedy tokens of a random model repeat one token, so equal
    tokens alone would not show a graph that reads or writes the wrong
    rows."""
    for name, x in a.items():
        y = b[name]
        if not torch.equal(x, y):
            fail(f"{what} differ in {name}: max |diff| {float((x.float() - y.float()).abs().max())}")


def dense_planes(cache) -> dict:
    return dict(k=cache.k, v=cache.v)


def page_planes(cache) -> dict:
    """The paged cache's pages and scale tiles without the trash page, which
    the rows of idle slots write in no fixed order."""
    from quick_tpu_torch.modules.paged_cache import TRASH_PAGE

    assert TRASH_PAGE == 0
    return {name: t[:, 1:] for name, t in (("k_pages", cache.k_pages), ("v_pages", cache.v_pages),
                                           ("kv_scales", cache.kv_scales)) if t is not None}


def graph_vs_eager_k7(params, cfg, dev, B=32, new_tokens=16):
    """[13d] generate() at B=32 (decode on K7) with the decode step graphed
    and eager: the same greedy tokens, k/v cache (bit for bit) and launch
    counts, and each one's decode time."""
    from quick_tpu_torch.modules.blocks import dense_decode_route
    from quick_tpu_torch.runtime import SamplingParams, decode_loop, make_cache, prefill
    from quick_tpu_torch.runtime.generate import graphable

    print(f"[13d] generate() at B={B} (decode on K7), graphed against eager")
    gen = torch.Generator(device=dev).manual_seed(13)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device=dev)
    out = {}
    for graph in (False, True):
        cache = make_cache(cfg, B, MAX_SEQ, device=dev)
        if dense_decode_route(cfg, cache, B, params.rope_cos, 0, dev) != "dense_kernel" or \
                not graphable(params, cfg, cache, SamplingParams()):
            fail(f"B={B} decode does not take K7 in a graph")
        logits, cache = prefill(params, cfg, prompts, cache)
        first = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (toks, cache), n = counted(lambda: decode_loop(params, cfg, first, cache,
                                                       new_tokens - 1, _graph=graph))
        out[graph] = (toks, n, (time.perf_counter() - t0) * 1e3 / (new_tokens - 1), cache)
        del cache
    if not torch.equal(out[False][0], out[True][0]) or out[False][1] != out[True][1]:
        fail(f"B={B}: graphed and eager decode differ in tokens or launches")
    same_planes(f"B={B}: the graphed and the eager decode loop's caches",
                dense_planes(out[True][3]), dense_planes(out[False][3]))
    res = dict(decode_ms_per_step_eager=out[False][2], decode_ms_per_step_graphed=out[True][2])
    print("  equal tokens, caches and launches; " + json.dumps(res))
    del out
    torch.cuda.empty_cache()
    return res


def engine_graph_ab(params, cfg, tag, engine=ENGINE, trace=None, layers=ENGINE_AB_LAYERS):
    """[13d] The Engine over ``trace`` at ``layers`` layers with its greedy
    windows replayed from a captured step and with eager windows: the same
    streams, stats, pages (bit for bit) and launch counts; each run's wall
    time."""
    from quick_tpu_torch.runtime import Engine

    p = dataclasses.replace(params, blocks=params.blocks[:layers])
    c = dataclasses.replace(cfg, num_hidden_layers=layers)
    trace = trace or serving_trace(cfg.vocab_size)
    print(f"[{tag}] {cfg.model_type} Engine at {layers} layers "
          f"({engine.get('dtype', torch.bfloat16)} pages), graphed against eager windows")
    runs = {}
    for graphs in (True, False):
        def run():
            eng = Engine(p, c, **engine, _graphs=graphs)
            uids = submit_all(eng, trace)
            outs = eng.run()
            return [outs[u] for u in uids], dict(eng.stats), eng.cache

        t0 = time.perf_counter()
        (streams, stats, pages), n = counted(run)
        runs[graphs] = (streams, stats, n, time.perf_counter() - t0, pages)
    if runs[True][:3] != runs[False][:3]:
        fail(f"{cfg.model_type} Engine: graphed and eager windows differ in streams, stats or "
             "launches")
    same_planes(f"{cfg.model_type} Engine: the graphed and the eager windows' pages",
                page_planes(runs[True][4]), page_planes(runs[False][4]))
    res = dict(layers=layers, graphed_s=runs[True][3], eager_s=runs[False][3])
    print("  equal streams, stats, pages and launches; " + json.dumps(res))
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase13_penalties(cfg, dev):
    """[13e] Penalised greedy generate() (repetition, frequency and presence
    penalties) at 2 layers of full width: the graphed and the eager decode
    loop give the same tokens; along them, the card's penalised logits at
    every step against the plain path's on the CPU (both fed the card's
    tokens, counts and prompt marks), within phase 6's tolerance, and the
    card's argmax is its token."""
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.models.model import init_quant_params, model_forward
    from quick_tpu_torch.runtime import SamplingParams, generate, make_cache
    from quick_tpu_torch.runtime.generate import apply_penalties

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    sp = SamplingParams(**PENALTIES)
    print(f"[13e] penalised greedy generate() {PENALTIES}, 2 layers at full width, B={BATCH}, "
          f"{PROMPT} + {PENALTY_TOKENS} tokens: graphed vs eager, then the kernel path (card) "
          f"vs the plain path (CPU), tol {TOL_MODEL} * (1 + |ref|)")
    p_gpu = init_quant_params(cfg2, seed=5, device=dev)
    p_cpu = params_from_flat(params_to_flat(p_gpu), cfg2, device="cpu")
    gen = torch.Generator(device=dev).manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    graphed = generate(p_gpu, cfg2, prompts, PENALTY_TOKENS, sampling=sp, max_seq=MAX_SEQ)
    eager = generate(p_gpu, cfg2, prompts, PENALTY_TOKENS, sampling=sp, max_seq=MAX_SEQ,
                     _graph=False)
    if not torch.equal(graphed, eager):
        fail("penalised generate(): graphed and eager decode differ")
    plain = generate(p_gpu, cfg2, prompts, PENALTY_TOKENS, max_seq=MAX_SEQ)
    toks = graphed[:, PROMPT:].cpu()
    V = cfg.vocab_size
    seen = torch.zeros((BATCH, V), dtype=torch.bool).scatter_(1, prompts.cpu(), True)
    counts = torch.zeros((BATCH, V), dtype=torch.int32)
    worst = 0.0
    caches = [make_cache(cfg2, BATCH, MAX_SEQ, device=d) for d in (dev, "cpu")]
    feed = prompts.cpu()
    with torch.inference_mode():
        for t in range(PENALTY_TOKENS):
            rows = []
            for i, (pp, d) in enumerate(((p_gpu, dev), (p_cpu, "cpu"))):
                lg, caches[i] = model_forward(pp, cfg2, feed.to(d), caches[i], last_token_only=True)
                rows.append(apply_penalties(lg[:, -1], counts.to(d), seen.to(d), *(
                    PENALTIES[k] for k in ("repetition_penalty", "frequency_penalty",
                                           "presence_penalty"))).cpu())
            worst = max(worst, max_err(rows[0], rows[1], TOL_MODEL, f"penalised step {t}"))
            if not torch.equal(torch.argmax(rows[0], dim=-1), toks[:, t]):
                fail(f"penalised step {t}: the card's argmax is not generate()'s token")
            counts[torch.arange(BATCH), toks[:, t]] += 1
            feed = toks[:, t:t + 1]
    moved = int((plain[:, PROMPT:] != graphed[:, PROMPT:]).sum())
    print(f"  graphed and eager tokens equal; {moved} of {BATCH * PENALTY_TOKENS} tokens differ "
          "from the unpenalised stream")
    if not moved:
        fail("the penalties moved no token: the check cannot see them act")
    del p_gpu, p_cpu, caches
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, tokens_moved_by_penalties=moved)


# ---------------------------------------------------------------------------
# Phase 14: beam search; phase 15: the Engine's history penalties and logit_bias
# ---------------------------------------------------------------------------

#: phase 14: beam_generate at Mistral-7B width and depth on phase 4's
#: weights, (B, num_beams) of each run: B x num_beams = 8 rows decode on K3,
#: 16 on K7; BEAM_PROMPT + BEAM_NEW tokens, an EOS token set
BEAM_RUNS = ((2, 4), (4, 4))
BEAM_PROMPT, BEAM_NEW = 128, 32
#: a step's time: (t(BEAM_NEW) - t(BEAM_SHORT)) / (BEAM_NEW - BEAM_SHORT)
#: over whole calls, so that the prefill and the capture drop out
BEAM_SHORT = 8
#: phase 14's 2-layer kernel-vs-plain check: prompt, new tokens, cache, and
#: the least gap between the nb-th and (nb + 1)-th candidate score (on the
#: plain path) at a step where the two paths' beams may part
BEAM_CHECK_PROMPT, BEAM_CHECK_NEW, BEAM_CHECK_SEQ, BEAM_TIE = 32, 8, MAX_SEQ, 1e-3
#: phase 14b scales the 2-layer model's final norm weight by this: random
#: full-width weights give logits of up to ~100 (phase 6), where one token
#: takes all the mass and every beam scores 0.0 in f32; at ~5 beams compete
BEAM_CHECK_NORM = 0.05
#: phase 15: the penalised requests' SamplingParams fields, and the bias
PEN_ENGINE = dict(repetition_penalty=1.2, frequency_penalty=0.5, presence_penalty=0.5)
PEN_BIAS = 5.0


def beam_launches(cfg, B: int, nb: int, prompt: int, new: int, T: int) -> dict:
    """Launches per kernel and key of one beam_generate() call: the prefill
    of B x nb rows of ``prompt`` tokens (K1 at M = rows x prompt, K2, K13)
    and ``new`` one-token forwards of the B x nb rows (K1's decode rows with
    their prologues at <= 8 rows, K3 there, K7 above; K13), each with the
    final norm over its last tokens."""
    from quick_tpu_torch.ops._cuda import sm_count
    from quick_tpu_torch.ops.decode_attention import launch_key as k7_key, split_plan

    L, R = cfg.num_hidden_layers, B * nb
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    want = {}

    def add(kernel, key, n):
        if n:
            want.setdefault(kernel, {})
            want[kernel][key] = want[kernel].get(key, 0) + n

    add_forward_launches(cfg, R * prompt, L, add)
    add_forward_launches(cfg, R, L * new, add)
    add("rms_norm", k13_key(R, cfg.hidden_size), 1 + new)
    add("flash_attention", f"B={R} S={prompt} T={T} Hq={Hq} Hkv={Hkv} D={D}", L)
    if R <= 8:
        add("fused_decode_step", f"B={R} Hq={Hq} Hkv={Hkv} S={T} D={D}", L * new)
    else:
        add("decode_attention", k7_key(R, Hq, Hkv, T, D, split_plan(R, Hkv, T, sm_count(0))[1]),
            L * new)
    return want


def phase14_beam(params, cfg, dev) -> tuple:
    """[14a] beam_generate() at Mistral-7B width and depth (phase 4's random
    g=128 weights), 128-token prompts, 32 new tokens, at B=2 x 4 beams (8
    rows: K3) and B=4 x 4 beams (16 rows: K7): a warm-up picks an EOS token
    the search emits; then one counted call with that EOS whose launches must
    equal the path's, graphed and eager searches with the same tokens and
    scores, ms a step of each (BEAM_SHORT's differential timing, in turns),
    and the beam reorder's share of the graphed step (``KVCache.take_rows``
    over the whole cache, timed alone). Returns (launch counts by path,
    stats)."""
    from quick_tpu_torch.modules.blocks import dense_decode_route
    from quick_tpu_torch.runtime import beam_generate, make_cache

    gen = torch.Generator(device=dev).manual_seed(14)
    counts, stats = {}, {}
    T = BEAM_PROMPT + BEAM_NEW
    for B, nb in BEAM_RUNS:
        R = B * nb
        route = dense_decode_route(cfg, make_cache(cfg, R, T, device=dev), R, params.rope_cos, 0,
                                   dev)
        want_route = "fused" if R <= 8 else "dense_kernel"
        print(f"[14a] beam_generate(): {cfg.num_hidden_layers} layers, B={B} x {nb} beams "
              f"({R} rows, decode on {'K3' if R <= 8 else 'K7'}), {BEAM_PROMPT} + {BEAM_NEW} "
              "tokens")
        if route != want_route:
            fail(f"beam search at {R} rows takes the {route} route, not {want_route}")
        prompts = torch.randint(0, cfg.vocab_size, (B, BEAM_PROMPT), generator=gen, device=dev)
        free, _ = beam_generate(params, cfg, prompts, BEAM_NEW, nb)  # warm-up
        eos = int(free[0, BEAM_PROMPT + 2])
        (toks, scores), n = counted(lambda: beam_generate(params, cfg, prompts, BEAM_NEW, nb,
                                                          eos_token_id=eos))
        want = beam_launches(cfg, B, nb, BEAM_PROMPT, BEAM_NEW, T)
        if n != want:
            fail(f"beam search B={B} x {nb}: launch counts {n} differ from the path's {want}")
        if tuple(toks.shape) != (B, T) or not torch.equal(toks[:, :BEAM_PROMPT], prompts) or \
                not torch.isfinite(scores).all() or int(toks.max()) >= cfg.vocab_size:
            fail(f"beam search B={B} x {nb}: malformed tokens or scores")
        wall = {}
        for graph in (None, False, False, None):
            for n_new in (BEAM_SHORT, BEAM_NEW):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = beam_generate(params, cfg, prompts, n_new, nb, eos_token_id=eos,
                                      max_seq=T, _graph=graph)
                torch.cuda.synchronize()
                wall.setdefault((graph, n_new), []).append(time.perf_counter() - t0)
            if not torch.equal(again[0], toks) or not torch.equal(again[1], scores):
                fail(f"beam search B={B} x {nb}: the {'eager' if graph is False else 'graphed'} "
                     "search gave other beams or scores")
        cache = make_cache(cfg, R, T, device=dev)
        src = torch.randint(0, R, (R,), generator=gen, device=dev)
        gather_ms = device_ms(lambda i: cache.take_rows(src), 10)
        del cache
        step_ms = {("graphed" if g is None else "eager"):
                   (min(wall[(g, BEAM_NEW)]) - min(wall[(g, BEAM_SHORT)])) * 1e3
                   / (BEAM_NEW - BEAM_SHORT) for g in (None, False)}
        res = dict(rows=R, eos_token_id=eos, best_scores=scores.tolist(),
                   ms_per_step_graphed=step_ms["graphed"], ms_per_step_eager=step_ms["eager"],
                   call_s=dict(graphed=min(wall[(None, BEAM_NEW)]),
                               eager=min(wall[(False, BEAM_NEW)])), gather_ms=gather_ms,
                   gather_bytes_each_way=2 * cfg.num_hidden_layers * R * cfg.num_key_value_heads
                   * T * cfg.head_dim * 2,
                   gather_share_of_graphed_step=gather_ms / step_ms["graphed"],
                   launches=sum(sum(v.values()) for v in n.values()))
        print(f"  launches equal to the path's; graphed and eager beams equal: " + json.dumps(res))
        key = f"beam_b{B}_nb{nb}"
        counts[key], stats[key] = n, res
    torch.cuda.empty_cache()
    return counts, stats


def phase14_plain_vs_kernel(cfg, dev) -> dict:
    """[14b] beam_generate() on a 2-layer full-width model (random g=128
    weights, seed 1, the final norm's weight scaled by BEAM_CHECK_NORM), the
    kernel path on the card against the plain path on the CPU, at B=2 x 4
    beams (K3) and B=4 x 4 (K7): the same beams, scores within 2e-3 x (1 +
    |s|); a batch row's beams may part only where the plain search's nb-th
    and (nb + 1)-th candidate scores were within BEAM_TIE at some step
    (counted and printed)."""
    import importlib

    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.runtime import beam_generate

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    p_gpu = init_quant_params(cfg2, seed=1, device=dev)
    p_gpu.final_norm.mul_(BEAM_CHECK_NORM)
    p_cpu = params_from_flat(params_to_flat(p_gpu), cfg2, device="cpu")
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}
    tgen = importlib.import_module("quick_tpu_torch.runtime.generate")
    orig = tgen.top_k
    for B, nb in BEAM_RUNS:
        print(f"[14b] beam_generate() at 2 layers of full width, B={B} x {nb} beams, "
              f"{BEAM_CHECK_PROMPT} + {BEAM_CHECK_NEW} tokens: kernel path (card) vs plain path "
              "(CPU)")
        prompts = torch.randint(0, cfg.vocab_size, (B, BEAM_CHECK_PROMPT), generator=gen,
                                device=dev)
        gaps = []

        def recording(cand, k):  # the plain search's candidate gaps, per batch row
            v, i = orig(cand, k + 1)
            gaps.append((v[:, k - 1] - v[:, k]).cpu())
            return v[:, :k], i[:, :k]

        (tk, sk), n = counted(lambda: beam_generate(p_gpu, cfg2, prompts, BEAM_CHECK_NEW, nb,
                                                    max_seq=BEAM_CHECK_SEQ))
        kern = "fused_decode_step" if B * nb <= 8 else "decode_attention"
        if sum(n.get(kern, {}).values()) != 2 * BEAM_CHECK_NEW:
            fail(f"the 2-layer beam search did not run {kern} once per layer per step: {n}")
        tgen.top_k = recording
        try:
            tc, sc = beam_generate(p_cpu, cfg2, prompts.cpu(), BEAM_CHECK_NEW, nb,
                                   max_seq=BEAM_CHECK_SEQ)
        finally:
            tgen.top_k = orig
        least = torch.stack(gaps).min(dim=0).values  # [B]
        tk, sk = tk.cpu(), sk.cpu()
        parted = [b for b in range(B) if not torch.equal(tk[b], tc[b])]
        for b in parted:
            if float(least[b]) > BEAM_TIE:
                fail(f"beam search B={B} x {nb}: row {b}'s beams part from the plain path's with "
                     f"a least candidate gap of {float(least[b]):.2e}")
        same = [b for b in range(B) if b not in parted]
        d = (sk[same] - sc[same]).abs()
        if not bool((d <= 2e-3 * (1 + sc[same].abs())).all()):
            fail(f"beam search B={B} x {nb}: scores {sk.tolist()} vs plain {sc.tolist()}")
        res = dict(rows_equal=len(same), rows_parted_at_near_ties=len(parted),
                   max_score_err=float(d.max()) if same else None, scores=sk.tolist(),
                   least_candidate_gap=least.tolist())
        print("  " + json.dumps(res))
        out[f"b{B}_nb{nb}"] = res
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return out


def penalised_trace(trace) -> list:
    """Phase 5's requests with submit keywords: every second one carries
    PEN_ENGINE's penalties, every fourth (from the second) a PEN_BIAS bias
    on its prompt's last token."""
    out = []
    for i, (p, n) in enumerate(trace):
        kw = {}
        if i % 2 == 0:
            from quick_tpu_torch.runtime import SamplingParams

            kw["sampling"] = SamplingParams(**PEN_ENGINE)
        if i % 4 == 1:
            kw["logit_bias"] = {p[-1]: PEN_BIAS}
        out.append((p, n, kw))
    return out


def phase15_penalties(params, cfg, unpenalised: dict, int8_trace) -> dict:
    """[15] The Engine with enable_penalties=True, phase 5's bf16 Engine at
    ENGINE_LAYERS layers on phase 5's trace, half its requests penalised and a
    quarter biased (``penalised_trace``): phase_engine's sync-checked,
    profiled, counted and timed runs (every request at its length, launch
    counts those of phase 5's schedule), its greedy windows replayed from the
    captured step (replays > 0), streams other than phase 5's; the graphed
    against the eager windows (streams, stats, pages and launches equal) at
    ENGINE_AB_LAYERS layers over bf16 and INT8 pages; wall time and busy
    share beside phase 5's."""
    eng_kw = dict(ENGINE, enable_penalties=True)
    counts, st = phase_engine(params, cfg, "15", eng_kw, penalised_trace(
        serving_trace(cfg.vocab_size)), keep_streams=True)
    streams = st.pop("streams")
    moved = sum(a != b for a, b in zip(streams, unpenalised["streams"]))
    replays = st["runs"][0]["stats"]["graph_replays"]
    if not replays:
        fail("the penalised Engine replayed no captured window step")
    if not moved:
        fail("the penalties and biases moved no stream: the check cannot see them act")
    st["streams_moved_by_penalties"] = moved
    st["graph_ab"] = dict(
        bf16=engine_graph_ab(params, cfg, "15", eng_kw, penalised_trace(
            serving_trace(cfg.vocab_size))),
        int8=engine_graph_ab(params, cfg, "15", dict(ENGINE_INT8, enable_penalties=True),
                             penalised_trace(int8_trace)))
    side = dict(
        wall_s=dict(penalised=st["runs"][0]["wall_s"], phase5=unpenalised["runs"][0]["wall_s"]),
        device_busy_share=dict(penalised=st["profile"]["device_busy_share"],
                               phase5=unpenalised["profile"]["device_busy_share"]))
    st["beside_phase5"] = side
    print(f"[15] {moved} of {len(streams)} streams moved by the penalties, {replays} graph "
          "replays; beside phase 5's unpenalised run: " + json.dumps(side))
    return counts, st


# ---------------------------------------------------------------------------
# Phase 16: AWQ on the card (the scale / clip search, its quality, two more
# widths)
# ---------------------------------------------------------------------------

#: examples/basic_quant.py's calibration (--n_calib_samples 32 --calib_block
#: 512) from get_calib_tokens' synthetic draw; Mistral-7B width at AWQ_LAYERS
#: of its 32 layers; AWQ_HOT embedding channels boosted x AWQ_BOOST, as
#: tools/mla_rtn_kl.py:50-56 does (random weights have no outlier channels,
#: the regime AWQ exists for)
AWQ_CALIB = dict(n_samples=32, block_size=512)
AWQ_LAYERS = 4
AWQ_HOT, AWQ_BOOST = 8, 8.0
#: held-out scoring: AWQ_EVAL_WINDOWS windows of 512 tokens from seed 1
AWQ_EVAL_WINDOWS = 4
#: tests/test_awq.py:104: AWQ's mean KL must stay below 2.5 x RTN's
AWQ_KL_BOUND = 2.5
#: [16b] a scale pick may differ between the kernel and the plain route only
#: where both routes' losses at the two picks lie within this relative gap
AWQ_PICK_GAP = 1e-2
#: [16b] the share of each clip search's (group, channel) picks that must
#: agree between the routes
AWQ_CLIP_AGREE = 0.95
#: [16b] x_next of the plain route, the kernel route's clips imposed, within
#: AWQ_XNEXT_TOL * (1 + |ref|): K2 rounds p to bf16 and K13 rounds once, a
#: bf16 step of the attention and norm outputs that the MLP (gate_up over
#: 4096, SiLU-GLU, down over 14336) carries to a few steps on the boosted
#: channels (0.020-0.023 measured on the card before this bound was set)
AWQ_XNEXT_TOL = 5e-2
AWQ_MODELS = ("mixtral-8x7b", "deepseek-v2-lite")


def boost_channels(params, cfg, seed: int = 0) -> list:
    """AWQ_HOT embedding channels (chosen from ``seed``) x AWQ_BOOST, in
    place: the activation outliers of real models."""
    import numpy as np

    hot = np.random.default_rng(seed).choice(cfg.hidden_size, AWQ_HOT, replace=False)
    idx = torch.from_numpy(hot).to(params.embed.device)
    params.embed[:, idx] = params.embed[:, idx] * AWQ_BOOST
    return sorted(int(h) for h in hot)


@contextlib.contextmanager
def awq_block_calls():
    """Record each AWQ block search that ``awq_quantize_model`` makes: its
    arguments, result, seconds (synchronized) and grid searches."""
    from quick_tpu_torch.quantize import awq

    calls, clips = [], []
    orig = awq.awq_quantize_block, awq.awq_quantize_mla_block, awq.search_clip

    def wrap(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clips.clear()
            with awq.recorded_searches() as rec:
                res = fn(*args, **kw)
            torch.cuda.synchronize()
            calls.append(dict(fn=fn, args=args, kw=kw, res=res, rec=rec, clips=list(clips),
                              seconds=time.perf_counter() - t0))
            return res
        return run

    def clip(*args, **kw):
        out = orig[2](*args, **kw)
        clips.append(out)
        return out

    awq.awq_quantize_block, awq.awq_quantize_mla_block = map(wrap, orig[:2])
    awq.search_clip = clip
    try:
        yield calls
    finally:
        awq.awq_quantize_block, awq.awq_quantize_mla_block, awq.search_clip = orig


@contextlib.contextmanager
def imposed_clips(bounds: list):
    """Every search_clip of the block returns the next of ``bounds`` (the
    other route's picks) instead of searching."""
    from quick_tpu_torch.quantize import awq

    orig, it = awq.search_clip, iter(bounds)
    awq.search_clip = lambda *args, **kw: next(it)
    try:
        yield
    finally:
        awq.search_clip = orig


def awq_quantize_timed(model, cfg, calib, tag: str, qcfg=None) -> dict:
    """``model.quantize(calib)`` on the card, host clock ended by
    synchronize(), counted, with each block's seconds and the peak memory."""
    from quick_tpu_torch import QuantConfig

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    with awq_block_calls() as calls:
        t0 = time.perf_counter()
        _, launched = counted(lambda: model.quantize(calib, qcfg or QuantConfig()))
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    blocks = [c["seconds"] for c in calls]
    print(f"  [{tag}] quantize(): {seconds:.2f} s for {len(blocks)} blocks (each "
          f"{', '.join(f'{b:.2f}' for b in blocks)} s); peak {peak / 1e9:.2f} GB "
          f"({before / 1e9:.2f} GB before); launches "
          f"{ {k: sum(v.values()) for k, v in launched.items()} }")
    return dict(seconds=seconds, block_seconds=blocks, peak_gb=peak / 1e9, launches=launched,
                calls=calls)


def awq_expected_launches(cfg) -> dict:
    """The kernels an AWQ search launches. A llama-path block: K2 at every
    attention of the qkv group's loss forward (the float output and N_GRID
    candidates) and once for the o group's input; K13 at the attention and
    MLP norms. An MLA block (no q-LoRA): K2 at every MLA forward (the float
    attention, the qkv group's float output and N_GRID candidates, the o
    group's input), K13 at each forward's kv_a norm and at the two block
    norms. The qk-norm adds K13 on q and k at each attention forward, the
    post-norms K13 on the two sub-layer outputs."""
    from quick_tpu_torch.quantize.awq import N_GRID

    L = cfg.num_hidden_layers
    if cfg.is_mla:
        forwards = N_GRID + 3
        return {"flash_attention": L * forwards, "rms_norm": L * (forwards + 2)}
    # the qk-norm: K13 on q and on k in each attention forward; the
    # post-norms (gemma2, gemma3) K13 on each sub-layer's output
    qk = 2 * (N_GRID + 2) if cfg.use_qk_norm else 0
    norms = 2 + (2 if cfg.use_post_norms else 0)
    return {"flash_attention": L * (N_GRID + 2), "rms_norm": L * (norms + qk)}


#: [18e] the share of a linear's packed int32 words that may differ between
#: the routes though every search up to it picked alike. With random
#: pre-norm weights K13 and the plain norm round the normed input up to one
#: bf16 step apart (phase 18's K13 rows), which moves the mean |activation|
#: and so the scales by f32 ulps, and flips a code that sits at a half-way
#: point: 22 of qkv's 3.67 M words (H100 80GB HBM3, 700 W). At unit pre-norm
#: weights (16b, 17f) the two norms agree bit for bit and no word may differ
AWQ_HALFWAY_SHARE = 1e-4


def awq_code_check(kernel_blk, plain_blk, agree: list, share: float = 0.0) -> dict:
    """[16b] the packed codes of the llama-path block's linears, kernel
    route against plain route: equal (at most ``share`` of a linear's words
    differing) for every linear whose searches and every search before them
    picked alike (``agree``: each search's picks equal, in call order).
    Returns the differing int32 words by linear."""
    mha_o = len(agree) == 8  # MHA adds the o scale search
    # searches in call order: qkv scale, [o scale], v clip, o clip, gate_up
    # scale, down scale, gate_up clip, down clip
    last = dict(qkv=2 + mha_o, o=3 + mha_o, gate_up=6 + mha_o, down=7 + mha_o)
    lins = dict(qkv=(kernel_blk.attn.qkv_proj, plain_blk.attn.qkv_proj),
                o=(kernel_blk.attn.o_proj, plain_blk.attn.o_proj),
                gate_up=(kernel_blk.mlp.gate_up_proj, plain_blk.mlp.gate_up_proj),
                down=(kernel_blk.mlp.down_proj, plain_blk.mlp.down_proj))
    out = {}
    for name, (a, b) in lins.items():
        n = int((a.qweight != b.qweight).sum())
        out[name] = n
        if all(agree[:last[name]]) and n > share * a.qweight.numel():
            fail(f"[16b] {name}: {n} packed words differ between the routes though every "
                 "search up to it picked alike")
    return out


def awq_route_check(calls, cfg, tag: str = "16b", share: float = 0.0, deep: bool = False) -> dict:
    """[16b, 17f] each block's search again from the same input on the plain
    route (QUICK_TPU_FLASH=0: the einsum attention; plain-torch norms),
    against the kernel route's (K2, K13). Scale picks must agree or differ
    under a loss gap < AWQ_PICK_GAP; at least AWQ_CLIP_AGREE of each clip
    search's picks must agree (the clip loss jumps where both ends of a
    group are clipped: its zero point sits at round(7.5), which an ulp of
    the inputs moves, so such a pick can move at any loss gap); the packed
    codes of every linear before the first differing pick must be equal
    (awq_code_check, ``share``). Then the plain route again with the kernel route's
    clip bounds imposed: x_next within AWQ_XNEXT_TOL * (1 + |ref|), or with
    ``deep`` (post-norms) its relative RMS difference within TOL_DEEP_RMS."""
    from quick_tpu_torch.quantize import awq

    xnext = (f"x_next's relative RMS within {TOL_DEEP_RMS:.3e}" if deep
             else f"x_next within {AWQ_XNEXT_TOL} * (1 + |ref|)")
    print(f"[{tag}] the search on the plain route (QUICK_TPU_FLASH=0, plain norms) from each "
          f"block's input, against the kernel route (K2, K13): scale picks equal or under a loss "
          f"gap < {AWQ_PICK_GAP}; >= {AWQ_CLIP_AGREE:.0%} of each clip search's picks equal; "
          f"{xnext} with the kernel route's clips imposed")
    report = []
    for i, c in enumerate(calls):
        with switches(QUICK_TPU_FLASH="0"), plain_norms(), awq.recorded_searches() as rec:
            res, launched = counted(lambda: c["fn"](*c["args"], **c["kw"]))
        if launched:
            fail(f"[{tag}] the plain route launched kernels: {launched}")
        cmp = awq.compare_searches(c["rec"], rec)
        print(f"  block {i}: searches (kind, picks differ, of, largest loss gap of a differing "
              f"pick) {[(r['kind'], r['differ'], r['picks'], float('%.3g' % r['gap'])) for r in cmp]}",
              flush=True)
        for j, r in enumerate(cmp):
            if r["kind"] == "scale" and r["differ"] and r["gap"] >= AWQ_PICK_GAP:
                fail(f"[{tag}] block {i} search {j}: the routes picked different scales at a "
                     f"loss gap of {r['gap']:.3e}")
            if r["kind"] == "clip" and r["differ"] > (1 - AWQ_CLIP_AGREE) * r["picks"]:
                fail(f"[{tag}] block {i} search {j}: {r['differ']} of {r['picks']} clip picks "
                     "differ")
        words = awq_code_check(c["res"].block, res.block, [r["differ"] == 0 for r in cmp],
                               share)
        with switches(QUICK_TPU_FLASH="0"), plain_norms(), imposed_clips(c["clips"]):
            fixed = c["fn"](*c["args"], **c["kw"])
        ref = c["res"].x_next.float()
        rms = float((fixed.x_next.float() - ref).norm() / ref.norm())
        what = f"block {i} x_next, the kernel route's clips imposed"
        if deep:
            err = float(((fixed.x_next.float() - ref).abs() / (1 + ref.abs())).max())
            print(f"  {what}: relative RMS {rms:.3e} (tol {TOL_DEEP_RMS:.3e}), max |err| / "
                  f"(1 + |ref|) {err:.3e}")
            if not rms <= TOL_DEEP_RMS:
                fail(f"[{tag}] {what}: the routes differ by a relative RMS of {rms:.3e}")
        else:
            err = max_err(fixed.x_next, c["res"].x_next, AWQ_XNEXT_TOL, what)
        free = (res.x_next.float() - ref).abs()
        print(f"  relative RMS of the difference {rms:.3e}; packed int32 words differing "
              f"{words}; x_next with each route's own clips: max |d| {float(free.max()):.3e}",
              flush=True)
        report.append(dict(searches=cmp, words_differ=words, x_next_max_abs_err=err,
                           x_next_rel_rms=rms, x_next_own_clips_max_abs_err=float(free.max())))
    return dict(blocks=report)


def awq_scores(float_params, rtn_params, awq_params, cfg, tokens) -> dict:
    """[16c] perplexity of the float, RTN and AWQ models and the KL of RTN
    and AWQ against the float model over ``tokens``' 512-token windows."""
    from quick_tpu_torch.evaluation import eval_kl_divergence, evaluate_perplexity

    out = {}
    for name, p in (("float", float_params), ("rtn", rtn_params), ("awq", awq_params)):
        t0 = time.perf_counter()
        out[f"ppl_{name}"], launched = counted(
            lambda: evaluate_perplexity(p, cfg, tokens, seqlen=512))
        out[f"ppl_{name}_s"] = time.perf_counter() - t0
        out[f"ppl_{name}_launches"] = {k: sum(v.values()) for k, v in launched.items()}
    for name, p in (("rtn", rtn_params), ("awq", awq_params)):
        rep, launched = counted(lambda: eval_kl_divergence(float_params, cfg, p, cfg, tokens,
                                                           seqlen=512))
        out[f"kl_{name}"] = dataclasses.asdict(rep)
        out[f"kl_{name}_launches"] = {k: sum(v.values()) for k, v in launched.items()}
        print(f"  KL(float || {name}): {rep}")
    print(f"  perplexity: float {out['ppl_float']:.4f}, RTN {out['ppl_rtn']:.4f}, "
          f"AWQ {out['ppl_awq']:.4f}")
    return out


def awq_block_forward_check(name, cfg, packed, x, group: int, tag: str = "16d") -> dict:
    """[16d] the packed block's forward on the card (K8 and K9 or K1, K2,
    K13) against its plain path on the CPU, one row of ``x``: tokens whose
    expert set differs between the paths need a router gap < ROUTE_GAP,
    the rest agree within AWQ_XNEXT_TOL (16b's reason)."""
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
    from quick_tpu_torch.modules.blocks import block_forward

    cpu = params_from_flat(params_to_flat(packed), cfg, device="cpu", group_size=group)
    xs = x[:1, :AWQ_FORWARD_TOKENS]
    S = xs.shape[1]
    pos = torch.arange(S, device=x.device)[None]
    k = cfg.num_experts_per_tok
    with recorded_routes(k) as routes, torch.inference_mode():
        (yg, _), launched = counted(lambda: block_forward(
            packed.blocks[0], cfg, xs, packed.rope_cos, packed.rope_sin, None, 0, pos))
        yc, _ = block_forward(cpu.blocks[0], cfg, xs.cpu(), cpu.rope_cos, cpu.rope_sin, None, 0,
                              pos.cpu())
    flipped = torch.zeros(1, dtype=torch.bool)
    (sg, gg), (sc, gc) = routes["cuda"][0], routes["cpu"][0]
    differ = (sg != sc).any(-1)[0]  # [S]
    if differ.any() and float(torch.minimum(gg, gc)[0][differ].max()) >= ROUTE_GAP:
        fail(f"[{tag}] {name}: a token's experts differ between the paths at a router gap "
             f">= {ROUTE_GAP}")
    keep = ~differ
    err = max_err(yg[0, keep.to(yg.device)].cpu(), yc[0, keep], AWQ_XNEXT_TOL,
                  f"{name} packed block forward, {int(keep.sum())} of {S} tokens")
    print(f"  launches {({n: sum(v.values()) for n, v in launched.items()})}, "
          f"{int(differ.sum())} tokens routed differently")
    return dict(max_abs_err=err, launches=launched, routed_differently=int(differ.sum()))


AWQ_FORWARD_TOKENS = 128


def phase16_awq(dev) -> tuple:
    """Phase 16: (a) AWQ through AutoQuickModel.quantize at Mistral-7B width,
    AWQ_LAYERS layers, timed and counted; (b) each block's search on the
    plain route against the kernel route; (c) the float, RTN and AWQ models
    scored (perplexity, KL); (d) one block of Mixtral-8x7B and of
    DeepSeek-V2-Lite (layer 1's shapes) at full width, timed, and the packed
    block's forward against the plain path. Returns (launch counts, report)."""
    from quick_tpu_torch import ModelConfig, QuantConfig
    from quick_tpu_torch.examples.basic_quant import PRESETS, default_group
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.model import quantize_params
    from quick_tpu_torch.quantize.calib import get_calib_tokens

    t_phase = time.perf_counter()
    report, counts = {}, {}
    cfg = dataclasses.replace(ModelConfig(**MISTRAL_7B), num_hidden_layers=AWQ_LAYERS)
    calib = get_calib_tokens(vocab_size=cfg.vocab_size, **AWQ_CALIB)
    print(f"[16a] AWQ: AutoQuickModel.quantize(calib) at Mistral-7B width, {AWQ_LAYERS} of 32 "
          f"layers, random float weights (seed 0) with {AWQ_HOT} embedding channels x "
          f"{AWQ_BOOST}; calibration {calib.shape[0]} x {calib.shape[1]} synthetic tokens "
          "(get_calib_tokens)")
    model = AutoQuickModel.from_random(cfg, seed=0, device=dev)
    hot = boost_channels(model.params, cfg)
    float_params = model.params
    a = awq_quantize_timed(model, cfg, calib, "16a")
    want = awq_expected_launches(cfg)
    got = {k: sum(v.values()) for k, v in a["launches"].items()}
    if got != want:
        fail(f"[16a] the AWQ search launched {got}, expected {want}")
    counts["awq_search"] = a["launches"]
    per_block = sum(a["block_seconds"]) / len(a["block_seconds"])
    report["mistral_7b"] = dict(
        layers=AWQ_LAYERS, hot_channels=hot, calib=list(calib.shape), seconds=a["seconds"],
        block_seconds=a["block_seconds"], peak_gb=a["peak_gb"],
        seconds_32_layers_extrapolated=a["seconds"] - sum(a["block_seconds"]) + 32 * per_block)
    print(f"  32 layers at {per_block:.2f} s a block: ~{report['mistral_7b']['seconds_32_layers_extrapolated']:.0f} s")
    report["route_check"] = awq_route_check(a["calls"], cfg)
    del a
    print(f"[16c] quality on {AWQ_EVAL_WINDOWS} held-out windows of 512 synthetic tokens "
          f"(seed 1): the float model, RTN and AWQ; KL_AWQ < {AWQ_KL_BOUND} x KL_RTN")
    tokens = get_calib_tokens(vocab_size=cfg.vocab_size, n_samples=AWQ_EVAL_WINDOWS,
                              block_size=512, seed=1)
    rtn_params = quantize_params(float_params, cfg)
    scores = awq_scores(float_params, rtn_params, model.params, cfg, tokens)
    for k in ("quantized_matmul", "flash_attention", "rms_norm"):
        if not scores["ppl_awq_launches"].get(k):
            fail(f"[16c] scoring the AWQ model did not launch {k}")
    if not scores["kl_awq"]["mean_kl"] < AWQ_KL_BOUND * scores["kl_rtn"]["mean_kl"]:
        fail(f"[16c] KL_AWQ {scores['kl_awq']['mean_kl']} is not below {AWQ_KL_BOUND} x KL_RTN "
             f"{scores['kl_rtn']['mean_kl']}")
    report["scores"] = scores
    del model, float_params, rtn_params
    gc.collect()
    torch.cuda.empty_cache()
    for name in AWQ_MODELS:
        mcfg = dataclasses.replace(PRESETS[name], num_hidden_layers=1, first_k_dense_replace=0)
        G = default_group(PRESETS[name])
        print(f"[16d] {name}: one block at full width (layer 1's shapes), G={G}, random float "
              f"weights (seed 0), the same calibration")
        m = AutoQuickModel.from_random(mcfg, seed=0, device=dev)
        boost_channels(m.params, mcfg)
        x = m.params.embed[torch.from_numpy(calib[:1].astype("int64")).to(dev)].to(torch.bfloat16)
        r = awq_quantize_timed(m, mcfg, calib, "16d", QuantConfig(q_group_size=G))
        got = {k: sum(v.values()) for k, v in r["launches"].items()}
        if got != awq_expected_launches(mcfg):
            fail(f"[16d] {name}: the AWQ search launched {got}, expected "
                 f"{awq_expected_launches(mcfg)}")
        fwd = awq_block_forward_check(name, mcfg, m.params, x, G)
        gemm = "quantized_matmul" if G == 128 else "quantized_matmul_dequant"
        for k in ("grouped_matmul", gemm, "flash_attention", "rms_norm"):
            if not fwd["launches"].get(k):
                fail(f"[16d] {name}: the packed block's forward did not launch {k}")
        counts[f"awq_{name}"] = r["launches"]
        report[name] = dict(seconds=r["seconds"], block_seconds=r["block_seconds"],
                            peak_gb=r["peak_gb"], forward=fwd)
        del m, r, x
        gc.collect()
        torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 16 took {report['seconds']:.1f} s")
    return counts, report


# ---------------------------------------------------------------------------
# Phase 17: Qwen3 (per-head q / k RMSNorm) and the task harnesses
# ---------------------------------------------------------------------------

#: the paths of phase 17's counted runs: Qwen3-8B's generate() (17a) and
#: Qwen3-30B-A3B's 2-layer kernel path (17e)
QWEN3_GEN, QWEN3_MOE = "qwen3_generate", "qwen3_moe_2layer"
#: random q / k norm weights: 1 + QK_SPREAD x N(0, 1), so that the norm
#: weights move q and k and a port that skipped them would show
QK_SPREAD = 0.1
#: [17c] the 2-layer model's per-choice scores (mean per-token logprob),
#: kernel route against the plain route on the CPU: the bf16 head's logits
#: (|l| < 8 with the final norm scaled by BEAM_CHECK_NORM; 17b reads
#: max|l| 5.3-5.4) may round one bf16 step (2^-8 x 8) apart, which moves a
#: log-softmax value by up to twice that
MMLU_SCORE_TOL = 2 * 2.0 ** -8 * 8
#: [17c] synthetic 4-choice rows (question words, the answer), their prompts
#: 40-230 bytes: the 64-token bucket (einsum attention) and the 128 / 192 /
#: 256-token buckets (K2 by _use_flash's gate: S >= 64, T >= 128)
MMLU_WORDS = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta")
MMLU_QUESTION_WORDS = (2, 5, 12, 20, 3, 28, 8, 34)
#: [17c] rows of the 2-layer check against the plain route: those of the
#: 64-, 128- and 192-token buckets (its CPU side computes the 151,936-wide
#: head at every position: the slow part)
MMLU_CHECK_ROWS = (0, 1, 2, 3, 4, 6)
#: [17d] hand-written HumanEval problems: (prompt, test, entry point, a
#: completion that passes, one that fails)
HUMANEVAL_PROBLEMS = (
    ("def add(a, b):\n", "def check(f):\n    assert f(2, 3) == 5\n    assert f(-4, 4) == 0\n",
     "add", "    return a + b\n", "    return a - b\n"),
    ("def largest(xs):\n",
     "def check(f):\n    assert f([3, 9, 2]) == 9\n    assert f([-1]) == -1\n",
     "largest", "    return max(xs)\n", "    return xs[0]\n"),
)


def byte_tokenize(vocab: int):
    """A deterministic tokenizer for synthetic text: UTF-8 bytes mod vocab."""
    return lambda text: [b % vocab for b in text.encode("utf-8")]


def mmlu_rows() -> list:
    rows = []
    for i, n in enumerate(MMLU_QUESTION_WORDS):
        words = [MMLU_WORDS[(i + j) % len(MMLU_WORDS)] for j in range(n)]
        rows.append(dict(question=" ".join(words) + "?", answer=i % 4,
                         choices=[str(7 * c + i) for c in range(4)]))
    return rows


def qwen3_params(cfg, dev, seed: int = 0, layers=None):
    """(cfg, params): random g=128 QTPU weights (seed), an untied bf16 head
    (seed + 11) and random q / k norm weights (1 + QK_SPREAD N(0, 1)), the
    first ``layers`` layers if given."""
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.modules.linear import Linear

    if layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    params = init_quant_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    D = cfg.hidden_size
    params.lm_head = Linear((torch.randn((D, cfg.vocab_size), generator=gen, device=dev)
                             / math.sqrt(D)).to(torch.bfloat16))
    random_qk_norms(params, gen)
    return cfg, params


def random_qk_norms(params, gen) -> None:
    """Every block's q / k norm weights, in place: 1 + QK_SPREAD N(0, 1)."""
    for blk in params.blocks:
        for name in ("q_norm", "k_norm"):
            w = getattr(blk.attn, name)
            noise = torch.randn(w.shape, generator=gen, device=w.device)
            setattr(blk.attn, name, (1 + QK_SPREAD * noise).to(torch.bfloat16))


def cpu_copy(params, cfg):
    from quick_tpu_torch.models.convert import params_from_flat, params_to_flat

    return params_from_flat(params_to_flat(params), cfg, device="cpu")


def k13_launches(cfg, forwards) -> int:
    """K13's launches of model_forward calls over ``forwards`` (the rows of
    each call): add_forward_launches' at every layer and the final norm's one
    launch a call (the bf16 head takes no prologue)."""
    n = []
    for rows in forwards:
        add_forward_launches(cfg, rows, cfg.num_hidden_layers,
                             lambda kernel, key, k: n.append(k if kernel == "rms_norm" else 0))
        n.append(1)
    return sum(n)


def qk_copy_ms(gen, dev, rows: int, cfg) -> dict:
    """[17a] the qk-norm as the path runs it: q and k column slices of the
    qkv output, which the K13 wrapper copies to contiguous rows before the
    launch; ms of the copy and K13 together beside K13 on contiguous rows."""
    from quick_tpu_torch.ops import norms

    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = torch.randn((rows, 1, (hq + 2 * hkv) * hd), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.ones(hd, device=dev, dtype=torch.bfloat16)
    out = {}
    for name, lo, h in (("q", 0, hq), ("k", hq * hd, hkv)):
        x = qkv[..., lo:lo + h * hd].reshape(rows, 1, h, hd)
        xc = x.contiguous()
        out[name] = dict(
            slice_ms=device_ms(lambda i: norms.rms_norm_cuda(x, w, 1e-6), 100),
            contiguous_ms=device_ms(lambda i: norms.rms_norm_cuda(xc, w, 1e-6), 100))
    print(f"  qk-norm at {rows} rows, slice (copy + K13) against contiguous (K13): "
          + json.dumps(out))
    return out


def phase17_mmlu(model, cfg, dev) -> dict:
    """[17c] eval_mmlu over mmlu_rows() with the 17a model at full depth
    (the kernel route), timed and counted; then per-choice scores of a
    2-layer model (the final norm scaled by BEAM_CHECK_NORM) on the card
    against the plain route on the CPU at MMLU_CHECK_ROWS, within
    MMLU_SCORE_TOL, the same argmax wherever the two best scores lie more
    than MMLU_SCORE_TOL apart."""
    from quick_tpu_torch.evaluation import eval_mmlu, score_choices
    from quick_tpu_torch.evaluation.mmlu import build_prompt

    rows, tok = mmlu_rows(), byte_tokenize(cfg.vocab_size)
    lens = [len(tok(build_prompt(r))) for r in rows]
    print(f"[17c] eval_mmlu: {len(rows)} synthetic 4-choice rows (prompts of {min(lens)}-"
          f"{max(lens)} byte tokens), {cfg.num_hidden_layers} layers on the card")
    eval_mmlu(model.params, cfg, tok, rows[:1])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, launched = counted(lambda: eval_mmlu(model.params, cfg, tok, rows))
    seconds = time.perf_counter() - t0
    for k in ("quantized_matmul", "flash_attention", "rms_norm"):
        if not launched.get(k):
            fail(f"[17c] eval_mmlu did not launch {k}: {launched}")
    print(f"  accuracy {res['accuracy']:.3f} of {res['n']} rows (random weights) in "
          f"{seconds:.2f} s; launches { {k: sum(v.values()) for k, v in launched.items()} }")
    cfg2, p2 = qwen3_params(cfg, dev, seed=3, layers=2)
    p2.final_norm.mul_(BEAM_CHECK_NORM)
    p2c = cpu_copy(p2, cfg2)
    print(f"  2 layers, the final norm x {BEAM_CHECK_NORM}: scores on the card against the plain "
          f"route (CPU) at rows {MMLU_CHECK_ROWS}, tol {MMLU_SCORE_TOL}")
    worst, same = 0.0, 0
    for i in MMLU_CHECK_ROWS:
        prompt = build_prompt(rows[i])
        sg = score_choices(p2, cfg2, tok, prompt, rows[i]["choices"])
        sc = score_choices(p2c, cfg2, tok, prompt, rows[i]["choices"])
        d = float(abs(sg - sc).max())
        worst = max(worst, d)
        top = sorted(sc)[-2:]
        print(f"  row {i} ({lens[i]} tokens): card {[round(float(v), 4) for v in sg]}, plain "
              f"{[round(float(v), 4) for v in sc]}, max |d| {d:.3e}")
        if not d <= MMLU_SCORE_TOL:
            fail(f"[17c] row {i}: a choice's score differs by {d} between the routes")
        if top[1] - top[0] > MMLU_SCORE_TOL:
            same += 1
            if int(sg.argmax()) != int(sc.argmax()):
                fail(f"[17c] row {i}: the routes pick other choices at a score gap "
                     f"{top[1] - top[0]}")
    del p2, p2c
    torch.cuda.empty_cache()
    return dict(accuracy=res["accuracy"], n=res["n"], seconds=seconds, prompt_tokens=lens,
                launches={k: sum(v.values()) for k, v in launched.items()},
                score_max_abs_err=worst, argmax_compared=same)


def phase17_humaneval(model, cfg, dev) -> dict:
    """[17d] eval_humaneval on HUMANEVAL_PROBLEMS: generate_fn runs the
    port's generate() on the card (8 greedy tokens after the prompt's byte
    tokens), writes them as a comment line and appends the problem's
    passing and failing completions, so pass@1 is 0.5 and pass@2 1.0."""
    from quick_tpu_torch.evaluation import eval_humaneval

    tok = byte_tokenize(cfg.vocab_size)
    known = {p[0]: p for p in HUMANEVAL_PROBLEMS}
    generated = []

    def generate_fn(prompt):
        toks = torch.tensor([tok(prompt)], device=dev)
        out = model.generate(toks, 8, max_seq=64)
        new = out[0, toks.shape[1]:].tolist()
        generated.append(len(new))
        note = "    # " + "".join(chr(32 + t % 95) for t in new) + "\n"
        return [note + known[prompt][3], note + known[prompt][4]]

    problems = [dict(task_id=f"synthetic/{i}", prompt=p, test=t, entry_point=e)
                for i, (p, t, e, _, _) in enumerate(HUMANEVAL_PROBLEMS)]
    print(f"[17d] eval_humaneval: {len(problems)} hand-written problems, generate() on the card "
          "plus a passing and a failing completion each")
    t0 = time.perf_counter()
    scores, launched = counted(lambda: eval_humaneval(generate_fn, problems, ks=(1, 2)))
    seconds = time.perf_counter() - t0
    print(f"  {scores} in {seconds:.2f} s; launches "
          f"{ {k: sum(v.values()) for k, v in launched.items()} }")
    if scores != {"pass@1": 0.5, "pass@2": 1.0} or generated != [8] * len(problems):
        fail(f"[17d] eval_humaneval gave {scores} (generated {generated}), not pass@1 0.5, "
             "pass@2 1.0")
    if not launched.get("fused_decode_step") or not launched.get("quantized_matmul"):
        fail(f"[17d] generate_fn did not run the decode kernels: {launched}")
    return dict(scores=scores, seconds=seconds)


def phase17_qwen3(dev) -> tuple:
    """Phase 17: (a) Qwen3-8B at full width and depth through generate(), K1
    at its four projections and K13 at its qk-norm shapes held and timed;
    (b) 2-layer dense and paged logits against the plain path, K13 counted
    exactly; (c) eval_mmlu; (d) eval_humaneval; (e) Qwen3-30B-A3B: K8 at 128
    experts held and timed, 2 layers against the plain path with phase 8's
    routing rule; (f) one Qwen3-8B block of AWQ through quantize(calib)
    against the plain route. Returns (launch counts, report, kernel rows)."""
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.quantize.calib import get_calib_tokens

    t_phase = time.perf_counter()
    cfg = PRESETS["qwen3-8b"]
    gen = torch.Generator(device=dev).manual_seed(17)
    report, counts = {}, {}
    gemms = main_path_gemms(cfg)
    print(f"[17a] K1 at Qwen3-8B's projections, K13 at its qk-norm shapes")
    errs = {}
    for prologue, M, K, N in gemms:
        key, errs[key], _ = check_gemm(prologue, M, K, N, gen, dev)
    rows = time_gemms(cfg, gen, dev, errs, gemms, QWEN3_GEN)
    hd = cfg.head_dim
    rows += rms_norm_rows(gen, dev, tag="17a", cases=tuple(
        (QWEN3_GEN, r * h, hd, None) for r in (BATCH, BATCH * PROMPT)
        for h in (cfg.num_attention_heads, cfg.num_key_value_heads)))
    report["qk_norm_copy"] = {r: qk_copy_ms(gen, dev, r, cfg) for r in (BATCH, BATCH * PROMPT)}
    print(f"[17a] generate() path: Qwen3-8B, {cfg.num_hidden_layers} layers, B={BATCH}, "
          f"{PROMPT} + {NEW_TOKENS} tokens, max_seq {MAX_SEQ}")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg, params = qwen3_params(cfg, dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    print(f"  random weights in {time.perf_counter() - t0:.1f} s: {weights / 1e9:.2f} GB on "
          "the card")
    model = AutoQuickModel(params, cfg)
    counts[QWEN3_GEN], stats = run_generate(model, cfg, dev, "qwen3-8b", generate_launches(cfg))
    stats["weights_gb"] = weights / 1e9
    prof = stats["decode_profile"]
    print(f"[17a] Qwen3-8B: prefill {min(stats['prefill_ms']):.2f} ms, graphed decode "
          f"{min(stats['decode_ms_per_step']):.3f} ms a token, device "
          f"{prof['device_busy_ms_per_step']:.3f} ms a step, busy share "
          f"{prof['device_busy_share']:.3f}")
    report["generate"] = stats
    report["mmlu"] = phase17_mmlu(model, cfg, dev)
    report["humaneval"] = phase17_humaneval(model, cfg, dev)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 17a, 17c, 17d done at {time.perf_counter() - t_phase:.0f} s of the phase")

    cfg2, p2 = qwen3_params(cfg, dev, seed=1, layers=2)
    pair = (p2, cpu_copy(p2, cfg2))
    dense_rows = [BATCH * PROMPT] + [BATCH] * PHASE6_DECODE
    paged_rows = [4 * 16] + [4] * PHASE6_DECODE  # phase 6's paged chunk: 4 slots x 16
    report["plain_vs_kernel"] = dict(
        dense=phase6_dense_plain_vs_kernel(cfg, dev, params=pair, tag="17b", require={
            "rms_norm": k13_launches(cfg2, dense_rows)}),
        paged=phase6_paged_plain_vs_kernel(cfg, dev, tag="17b", params=pair, require={
            "rms_norm": k13_launches(cfg2, paged_rows)}))
    del p2, pair
    torch.cuda.empty_cache()

    mcfg = PRESETS["qwen3-30b-a3b"]
    moe_prompt = 32
    rows += grouped_rows("qwen3-30b-a3b", mcfg, gen, dev, tag="17e",
                         cases=[(QWEN3_MOE, BATCH), (QWEN3_MOE, BATCH * moe_prompt)])
    mcfg2, m2 = qwen3_params(mcfg, dev, seed=1, layers=2)
    moe = phase8_plain_vs_kernel(
        "qwen3-30b-a3b", mcfg, dev, prompt=moe_prompt, steps=2, max_seq=64, tag="17e",
        params=(m2, cpu_copy(m2, mcfg2)),
        require={"rms_norm": k13_launches(mcfg2, [BATCH * moe_prompt, BATCH, BATCH])})
    counts[QWEN3_MOE] = moe.pop("launches_by_key")
    report["qwen3_30b_a3b_plain_vs_kernel"] = moe
    del m2
    gc.collect()
    torch.cuda.empty_cache()

    fcfg = dataclasses.replace(cfg, num_hidden_layers=1)
    calib = get_calib_tokens(vocab_size=fcfg.vocab_size, **AWQ_CALIB)
    print(f"[17f] AWQ: one Qwen3-8B block at full width through quantize(calib), random float "
          f"weights (seed 0) with random q / k norms and {AWQ_HOT} embedding channels x "
          f"{AWQ_BOOST}; phase 16's calibration ({calib.shape[0]} x {calib.shape[1]})")
    m = AutoQuickModel.from_random(fcfg, seed=0, device=dev)
    random_qk_norms(m.params, torch.Generator(device=dev).manual_seed(5))
    boost_channels(m.params, fcfg)
    a = awq_quantize_timed(m, fcfg, calib, "17f")
    got = {k: sum(v.values()) for k, v in a["launches"].items()}
    if got != awq_expected_launches(fcfg):
        fail(f"[17f] the AWQ search launched {got}, expected {awq_expected_launches(fcfg)}")
    report["awq_block"] = dict(seconds=a["seconds"], block_seconds=a["block_seconds"],
                               peak_gb=a["peak_gb"], route_check=awq_route_check(a["calls"], fcfg,
                                                                                 tag="17f"))
    counts["awq_qwen3_8b"] = a["launches"]
    del m, a
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 17 took {report['seconds']:.1f} s")
    return counts, report, rows


# ---------------------------------------------------------------------------
# Phase 18: the RMSNorm families off the llama path
# ---------------------------------------------------------------------------

GEMMA2_GEN, GEMMA3_GEN = "gemma2_generate", "gemma3_generate"
GEMMA2_LONG = "gemma2_long"
#: [18b] one long stream through the window: a 4,400-token prompt in a
#: 4,608-token cache (K2 with window 4,096 and softcap 50 on the 21 sliding
#: layers; 18 MiB of keys a row in each layer close K3's 3 MiB gate and open
#: K7's 8 MB one on the 21 global layers, the sliding ones decode on the
#: einsum: K7 takes no window, in either package), 16 greedy tokens
LONG18_PROMPT, LONG18_SEQ, LONG18_NEW = 4400, 4608, 16
#: [18c] the 6-layer check (layers 0-4 slide, 5 is global): a 1,280-token
#: prompt in a 1,536-token cache, past the 1,024 window, then phase 6's 4
#: decode steps. B = 1 and 4 steps for the time limit: the CPU's plain
#: prefill of 2 x 1,280 tokens and 8 steps at 6 layers of full width took
#: 90 s (a CPU step dequantizes every weight, ~3.6 s at 6 layers)
G3_CHECK = dict(layers=6, B=1, prompt=1280, max_seq=1536, steps=PHASE6_DECODE)
#: [18d] 2 layers at full width of each; a 64-token prompt in a 128-token
#: cache, where K2's gate (S >= 64, T >= 128) opens
SMALL18 = dict(B=BATCH, prompt=64, max_seq=128, steps=2)
#: allenai/OLMo-2-1124-7B, ibm-granite/granite-3.1-8b-base and
#: openbmb/MiniCPM-2B-sft-bf16 config.json, the fields the port reads
OLMO2_7B = dict(model_type="olmo2", vocab_size=100352, hidden_size=4096,
                intermediate_size=11008, num_hidden_layers=32, num_attention_heads=32,
                num_key_value_heads=32, rope_theta=500000.0, rms_norm_eps=1e-6,
                max_position_embeddings=4096, tie_word_embeddings=False)
GRANITE_8B = dict(model_type="granite", vocab_size=49155, hidden_size=4096,
                  intermediate_size=12800, num_hidden_layers=40, num_attention_heads=32,
                  num_key_value_heads=8, embedding_multiplier=12.0, residual_multiplier=0.22,
                  attention_multiplier=0.0078125, logits_scaling=16.0, rope_theta=10000000.0,
                  rms_norm_eps=1e-5, max_position_embeddings=131072, tie_word_embeddings=True)
MINICPM_2B = dict(model_type="minicpm", vocab_size=122753, hidden_size=2304,
                  intermediate_size=5760, num_hidden_layers=40, num_attention_heads=36,
                  num_key_value_heads=36, scale_emb=12, scale_depth=1.4, dim_model_base=256,
                  rms_norm_eps=1e-5, max_position_embeddings=4096, rope_theta=10000.0,
                  tie_word_embeddings=True)
SMALL18_MODELS = {"olmo2-7b": OLMO2_7B, "granite-3.1-8b": GRANITE_8B,
                  "minicpm-2b": MINICPM_2B}
MINICPM_CHECK = "minicpm_2layer"
#: every norm weight of the phase's models: 1 + NORM_SPREAD N(0, 1), so that
#: neither the pre- nor the post-norms nor the q / k norms are all ones
NORM_SPREAD = 0.1


def random_norms(params, gen) -> None:
    """Every norm weight of ``params`` in place (pre-, post-, q / k and the
    final norm): 1 + NORM_SPREAD N(0, 1), bf16."""
    def r(w):
        if w is None:
            return None
        return (1 + NORM_SPREAD * torch.randn(w.shape, generator=gen, device=w.device)).to(
            torch.bfloat16)

    for blk in params.blocks:
        for name in ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm"):
            setattr(blk, name, r(getattr(blk, name)))
        for name in ("q_norm", "k_norm"):
            setattr(blk.attn, name, r(getattr(blk.attn, name)))
    params.final_norm = r(params.final_norm)


def family_params(cfg, dev, seed: int = 0, layers=None):
    """(cfg, params): random g=128 QTPU weights (seed), random norms
    (random_norms, seed + 11), the tied bf16 head, or a random untied one
    (seed + 11) where the config unties it; the first ``layers`` layers if
    given."""
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.modules.linear import Linear

    if layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    params = init_quant_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    if not cfg.tie_word_embeddings:
        D = cfg.hidden_size
        params.lm_head = Linear((torch.randn((D, cfg.vocab_size), generator=gen, device=dev)
                                 / math.sqrt(D)).to(torch.bfloat16))
    random_norms(params, gen)
    return cfg, params


def long_launches(cfg, B=1, prompt=LONG18_PROMPT, T=LONG18_SEQ, new=LONG18_NEW) -> dict:
    """[18b] launches of one generate() call of B x (prompt + new) tokens in
    a T-token cache past K3's gate: the prefill (K1, K2 at every layer, K13),
    then new - 1 eager decode forwards, K7 at the global layers (the sliding
    ones decode on the einsum)."""
    from quick_tpu_torch.ops import decode_attention as dda
    from quick_tpu_torch.ops._cuda import sm_count

    L = cfg.num_hidden_layers
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    want = {}

    def add(kernel, key, n):
        if n:
            want.setdefault(kernel, {})
            want[kernel][key] = want[kernel].get(key, 0) + n

    add_forward_launches(cfg, B * prompt, L, add)
    add_forward_launches(cfg, B, L * (new - 1), add)
    add("rms_norm", k13_key(B, cfg.hidden_size), new)
    add("flash_attention", f"B={B} S={prompt} T={T} Hq={Hq} Hkv={Hkv} D={D}", L)
    globals_ = sum(not cfg.layer_is_sliding(i) for i in range(L))
    _, splits = dda.split_plan(B, Hkv, T, sm_count(0))
    add("decode_attention", dda.launch_key(B, Hq, Hkv, T, D, splits), globals_ * (new - 1))
    return want


def phase18_long(model, cfg, dev) -> tuple:
    """[18b] generate() of one 4,400-token prompt and 16 greedy tokens at
    full depth, counted exactly (a warm-up first), then prefill and the
    eager decode timed apart."""
    from quick_tpu_torch.runtime import decode_loop, make_cache, prefill

    gen = torch.Generator(device=dev).manual_seed(18)
    prompts = torch.randint(0, cfg.vocab_size, (1, LONG18_PROMPT), generator=gen, device=dev)
    print(f"[18b] generate(): B=1, a {LONG18_PROMPT}-token prompt + {LONG18_NEW} tokens in a "
          f"{LONG18_SEQ}-token cache, {cfg.num_hidden_layers} layers (the window of "
          f"{cfg.sliding_window} binds on the sliding layers)")
    model.generate(prompts, 2, max_seq=LONG18_SEQ)  # warm-up
    want = long_launches(cfg)
    t0 = time.perf_counter()
    out, launched = counted(lambda: model.generate(prompts, LONG18_NEW, max_seq=LONG18_SEQ))
    seconds = time.perf_counter() - t0
    if launched != want:
        fail(f"[18b] launch counts {launched} differ from the path's {want}")
    if tuple(out.shape) != (1, LONG18_PROMPT + LONG18_NEW) or not torch.equal(
            out[:, :LONG18_PROMPT], prompts):
        fail(f"[18b] generate returned {tuple(out.shape)} or lost the prompt")
    cache = make_cache(cfg, 1, LONG18_SEQ, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model.params, cfg, prompts, cache)
    first = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest, cache = decode_loop(model.params, cfg, first, cache, LONG18_NEW - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    if not torch.equal(torch.cat([first[:, None], rest], 1), out[:, LONG18_PROMPT:]):
        fail("[18b] a second greedy run gave other tokens")
    stats = dict(generate_s=seconds, prefill_ms=t_prefill * 1e3,
                 prefill_tok_s=LONG18_PROMPT / t_prefill,
                 decode_ms_per_step=t_decode * 1e3 / (LONG18_NEW - 1),
                 launches={k: sum(v.values()) for k, v in launched.items()})
    print(f"  launches exact {stats['launches']}; prefill {stats['prefill_ms']:.1f} ms "
          f"({stats['prefill_tok_s']:.0f} tok/s), eager decode {stats['decode_ms_per_step']:.2f} "
          "ms a token")
    del cache
    return launched, stats


def phase18_generate(name, cfg, dev, path) -> tuple:
    """[18a, 18c] ``name`` at full width and depth through generate() as
    phase 4 (random weights and norms, seed 0), its launches exact. Returns
    (counts, stats, model)."""
    from quick_tpu_torch.models.auto import AutoQuickModel

    print(f"[18] generate() path: {name}, {cfg.num_hidden_layers} layers, B={BATCH}, "
          f"{PROMPT} + {NEW_TOKENS} tokens, max_seq {MAX_SEQ}")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg, params = family_params(cfg, dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    print(f"  random weights in {time.perf_counter() - t0:.1f} s: {weights / 1e9:.2f} GB on the "
          "card")
    model = AutoQuickModel(params, cfg)
    counts, stats = run_generate(model, cfg, dev, name, generate_launches(cfg))
    stats["weights_gb"] = weights / 1e9
    prof = stats["decode_profile"]
    print(f"[18] {name}: prefill {min(stats['prefill_ms']):.2f} ms, graphed decode "
          f"{min(stats['decode_ms_per_step']):.3f} ms a token, device "
          f"{prof['device_busy_ms_per_step']:.3f} ms a step, busy share "
          f"{prof['device_busy_share']:.3f}")
    return counts, stats, model


def phase18_kernel_rows(cfg, gen, dev, path, tag) -> list:
    """[18a, 18c] K1 at the model's four projections (prefill and decode
    rows, the decode rows' prologues as the path takes them), K2 and K3 at
    head_dim 256 with the path's softcap, K13 at the post-norm (and gemma3's
    qk-norm) shapes: each held against its plain version and timed."""
    errs = {}
    gemms = main_path_gemms(cfg)
    print(f"[{tag}] K1 at {cfg.model_type}'s projections, K2 / K3 at head_dim {cfg.head_dim}, "
          "K13 at its norm shapes")
    for prologue, M, K, N in gemms:
        key, errs[key], _ = check_gemm(prologue, M, K, N, gen, dev)
    rows = time_gemms(cfg, gen, dev, errs, gemms, path)
    kw = {} if cfg.attn_logit_softcap is None else dict(logit_softcap=cfg.attn_logit_softcap)
    rows.append(flash_row(cfg, gen, dev, path=path, tag=tag, path_kw=kw))
    rows.append(fused_row(cfg, gen, dev, path=path, path_kw=kw, tag=tag))
    D, hd = cfg.hidden_size, cfg.head_dim
    cases = [(path, r, D, None) for r in (BATCH, BATCH * PROMPT)]
    if cfg.use_qk_norm:
        cases += [(path, r * h, hd, None) for r in (BATCH, BATCH * PROMPT)
                  for h in (cfg.num_attention_heads, cfg.num_key_value_heads)]
    return rows + rms_norm_rows(gen, dev, tag=tag, cases=tuple(cases))


def phase18_rms_families(dev) -> tuple:
    """Phase 18: (a) Gemma2-9B at full width and depth through generate(),
    K1 at its projections, K2 / K3 at head_dim 256 with softcap 50 and K13
    at the post-norm shapes held and timed; (b) one 4,400-token stream
    through the window at full depth, K2 windowed and K7 at its shape held
    and timed, then 2-layer dense and paged checks against the plain path;
    (c) Gemma3-12B as (a), and a 6-layer dense and paged check past its
    1,024 window; (d) OLMo-2-7B, Granite-3.1-8B and MiniCPM-2B at 2 layers
    of full width against the plain path, K2 / K3 at MiniCPM's head_dim 64
    held and timed; (e) one Gemma2-9B block of AWQ through quantize(calib)
    against the plain route. Returns (launch counts, report, kernel rows)."""
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.quantize.calib import get_calib_tokens

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(18)
    report, counts = {}, {}
    g2, g3 = PRESETS["gemma2-9b"], PRESETS["gemma3-12b"]
    rows = phase18_kernel_rows(g2, gen, dev, GEMMA2_GEN, "18a")
    counts[GEMMA2_GEN], report["gemma2_generate"], model = phase18_generate(
        "gemma2-9b", g2, dev, GEMMA2_GEN)
    print(f"  phase 18a done at {time.perf_counter() - t_phase:.0f} s of the phase")

    # [18b] the window binds: K2 and K7 at the stream's shapes, then the stream
    soft = dict(logit_softcap=g2.attn_logit_softcap)
    rows.append(flash_row(g2, gen, dev, B=1, S=LONG18_PROMPT, T=LONG18_SEQ, path=GEMMA2_LONG,
                          tag="18b", path_kw=dict(soft, window=g2.sliding_window)))
    lengths = LONG18_PROMPT + torch.randint(0, LONG18_NEW, (1,), generator=gen, device=dev)
    rows.append(k7_row(g2, gen, dev, "gemma2 long stream", 1, LONG18_SEQ, lengths,
                       [("", {}), (", softcap 50", soft)], GEMMA2_LONG, timed_kw=soft,
                       tag="18b"))
    counts[GEMMA2_LONG], report["gemma2_long"] = phase18_long(model, model.cfg, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cfg2, p2 = family_params(g2, dev, seed=1, layers=2)
    pair = (p2, cpu_copy(p2, cfg2))
    report["gemma2_plain_vs_kernel"] = dict(
        dense=phase6_dense_plain_vs_kernel(
            g2, dev, B=1, max_seq=LONG18_SEQ, prompt=LONG18_PROMPT, params=pair, tag="18b",
            decode_kernel="decode_attention", decode_layers=1),
        paged=phase6_paged_plain_vs_kernel(
            g2, dev, tag="18b", params=pair, starts=(LONG18_PROMPT,), max_seq=LONG18_SEQ))
    del p2, pair
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 18b done at {time.perf_counter() - t_phase:.0f} s of the phase")

    rows += phase18_kernel_rows(g3, gen, dev, GEMMA3_GEN, "18c")
    counts[GEMMA3_GEN], report["gemma3_generate"], model = phase18_generate(
        "gemma3-12b", g3, dev, GEMMA3_GEN)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    c = G3_CHECK
    cfg6, p6 = family_params(g3, dev, seed=1, layers=c["layers"])
    pair = (p6, cpu_copy(p6, cfg6))
    globals_ = sum(not cfg6.layer_is_sliding(i) for i in range(c["layers"]))
    start = c["prompt"] - 16
    report["gemma3_plain_vs_kernel"] = dict(
        dense=phase6_dense_plain_vs_kernel(
            g3, dev, B=c["B"], max_seq=c["max_seq"], prompt=c["prompt"], params=pair,
            tag="18c", steps=c["steps"], decode_kernel="decode_attention",
            decode_layers=globals_, deep=True),
        paged=phase6_paged_plain_vs_kernel(
            g3, dev, tag="18c", params=pair, starts=(start, start - 200),
            max_seq=c["max_seq"], steps=c["steps"], deep=True))
    del p6, pair
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 18c done at {time.perf_counter() - t_phase:.0f} s of the phase")

    small = {}
    for name, hf in SMALL18_MODELS.items():
        cfg = ModelConfig.from_hf_config(hf)
        m = SMALL18
        cfgs, ps = family_params(cfg, dev, seed=1, layers=2)
        pair = (ps, cpu_copy(ps, cfgs))
        launched = {}
        small[name] = phase6_dense_plain_vs_kernel(
            cfg, dev, B=m["B"], max_seq=m["max_seq"], prompt=m["prompt"], params=pair,
            tag=f"18d {name}", steps=m["steps"], counts=launched)
        if name == "minicpm-2b":
            counts[MINICPM_CHECK] = launched
            mcfg = cfg
        del ps, pair
        torch.cuda.empty_cache()
    report["small_plain_vs_kernel"] = small
    rows.append(flash_row(mcfg, gen, dev, B=SMALL18["B"], S=SMALL18["prompt"],
                          T=SMALL18["max_seq"], path=MINICPM_CHECK, tag="18d"))
    rows.append(fused_row(mcfg, gen, dev, B=SMALL18["B"], S=SMALL18["max_seq"],
                          length=SMALL18["prompt"] + SMALL18["steps"] - 1, path=MINICPM_CHECK,
                          tag="18d"))
    print(f"  phase 18d done at {time.perf_counter() - t_phase:.0f} s of the phase")

    fcfg = dataclasses.replace(g2, num_hidden_layers=1)
    calib = get_calib_tokens(vocab_size=fcfg.vocab_size, **AWQ_CALIB)
    print(f"[18e] AWQ: one Gemma2-9B block at full width through quantize(calib), random float "
          f"weights (seed 0) with random norms and {AWQ_HOT} embedding channels x {AWQ_BOOST}; "
          f"phase 16's calibration ({calib.shape[0]} x {calib.shape[1]})")
    m = AutoQuickModel.from_random(fcfg, seed=0, device=dev)
    random_norms(m.params, torch.Generator(device=dev).manual_seed(5))
    boost_channels(m.params, fcfg)
    a = awq_quantize_timed(m, fcfg, calib, "18e")
    got = {k: sum(v.values()) for k, v in a["launches"].items()}
    if got != awq_expected_launches(fcfg):
        fail(f"[18e] the AWQ search launched {got}, expected {awq_expected_launches(fcfg)}")
    report["awq_block"] = dict(seconds=a["seconds"], block_seconds=a["block_seconds"],
                               peak_gb=a["peak_gb"],
                               route_check=awq_route_check(a["calls"], fcfg, tag="18e",
                                                           share=AWQ_HALFWAY_SHARE, deep=True))
    counts["awq_gemma2_9b"] = a["launches"]
    del m, a
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 18 took {report['seconds']:.1f} s")
    return counts, report, rows


def depth_costs(dev) -> dict:
    """``python3 chip_smoke.py --depth-costs``: the seconds of the phases
    that the time limit runs at a cut depth, run at full depth instead
    (phase 5's Engine and phase 12b's Engine host A/B, phase 9c's INT8
    Engine and phase 8's Mixtral Engine at 32 layers, phase 10b's GGUF file
    at 32, phase 11d's DeepSeek-V2-Lite Engines at 27), for PERF.md
    section 4. A measurement only: it checks what those
    phases check and ends without the kernels line."""
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.models.model import init_quant_params

    global GGUF_LAYERS
    out = {}

    def timed(tag, fn):
        t0 = time.perf_counter()
        fn()
        out[tag] = time.perf_counter() - t0
        print(f"[depth] {tag}: {out[tag]:.1f} s", flush=True)

    cfg = ModelConfig(**MISTRAL_7B)
    params = init_quant_params(cfg, seed=0, device=dev)
    timed("5 bf16 Engine, 32 layers", lambda: phase_engine(params, cfg, "5"))
    timed("12b Engine host A/B, 32 layers", lambda: engine_host_ab(params, cfg, "12b"))
    timed("9c INT8 Engine, 32 layers", lambda: phase_engine(
        params, cfg, "9c", ENGINE_INT8, serve_bench_trace(cfg.vocab_size)))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = PRESETS["mixtral-8x7b"]
    mparams = init_quant_params(mcfg, seed=0, device=dev)
    timed("8 Mixtral Engine, 32 layers", lambda: phase_engine(mparams, mcfg, "8"))
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    GGUF_LAYERS = 32
    timed("10b GGUF file, 32 layers", lambda: phase10_gguf(dev))
    dcfg = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE)
    dparams = init_quant_params(dcfg, seed=0, group_size=DS_G, device=dev)
    trace = serving_trace(dcfg.vocab_size)
    for kind, engine in (("bf16", ENGINE), ("INT8", dict(ENGINE, dtype=torch.int8))):
        timed(f"11d DeepSeek-V2-Lite {kind} Engine, 27 layers", lambda: phase_engine(
            dparams, dcfg, "11d", engine, trace, ds_engine_launches, warmup=False))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not (ROOT / "quick_tpu_torch" / "__init__.py").is_file():
        fail(f"quick_tpu_torch/ is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from quick_tpu_torch import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()
    phase1_build()
    if "--depth-costs" in sys.argv[1:]:
        print("depth costs: " + json.dumps(depth_costs(dev)))
        return
    if "--phase18" in sys.argv[1:]:
        _, family_report, family_rows = phase18_rms_families(dev)
        print("phase 18: " + json.dumps(dict(report=family_report, kernels=[
            {k: v for k, v in r.items() if k != "launches"} for r in family_rows]), default=str))
        return
    cfg = ModelConfig(**MISTRAL_7B)
    gen = torch.Generator(device=dev).manual_seed(0)
    trace = serving_trace(cfg.vocab_size)
    gemm_errs = check_gemms(cfg, gen, dev)
    dense_route = dense_route_rows(cfg, gen, dev)
    rows = time_gemms(cfg, gen, dev, gemm_errs, main_path_gemms(cfg), "generate")
    rows += time_gemms(cfg, gen, dev, gemm_errs, engine_gemms(cfg), "engine")
    rows.append(flash_row(cfg, gen, dev))
    rows += [fused_row(cfg, gen, dev, *shape) for shape in FUSED_SHAPES]
    rows += paged_write_rows(cfg, gen, dev, trace)
    k4_graph = k4_graph_pdl(cfg, gen, dev, trace)
    rows += paged_attention_rows(cfg, gen, dev, trace)
    rows += time_gemms(cfg, gen, dev, gemm_errs, checkpoint_gemms(cfg), "checkpoint")
    rows += [flash_row(cfg, gen, dev, B=B, S=S, T=T, path="checkpoint")
             for B, S, T in checkpoint_flash_shapes()]
    rows += dense_decode_rows(cfg, gen, dev)
    int8_trace = serve_bench_trace(cfg.vocab_size)
    rows += int8_write_rows(cfg, gen, dev, int8_trace)
    rows += int8_attention_rows(cfg, gen, dev, int8_trace)
    print(f"  phases 1-3 and 9a-b done at {time.perf_counter() - t_start:.0f} s")
    rows += a8_rows("Mistral-7B width", gemm_shapes(cfg), A8_CASES, 128, gen, dev)
    # checked and timed; no path runs it, so its rows stay out of the kernel line
    ds_a8 = a8_rows("DeepSeek-V2-Lite", ds_k9_shapes(ModelConfig.from_hf_config(DEEPSEEK_V2_LITE)),
                    (("no path", None, BATCH * PROMPT),), DS_G, gen, dev)
    rows += rms_norm_rows(gen, dev)
    k13_graph = k13_graph_pdl(gen, dev)
    print(f"  phase 12a-b (K11, K11f, K13) done at {time.perf_counter() - t_start:.0f} s")
    tail_row, tail_every = tail_rows(cfg, gen, dev)
    rows.append(tail_row)
    print(f"  phase 13a (K14) done at {time.perf_counter() - t_start:.0f} s")
    counts = {}
    counts["generate"], gen_stats, params = phase4_main_path(cfg, dev)
    a8_counts, a8_gen_stats = phase12_generate(params, cfg, dev)
    counts.update(a8_counts)
    counts[TAIL_GEN], tail_gen_stats = phase13_generate(params, cfg, dev)
    print("[13b] the graphed decode step's device ms (32 profiled steps, B=4): "
          f"{tail_gen_stats['decode_profile']['device_busy_ms_per_step']:.3f} under "
          "QUICK_TPU_LAYER_TAIL=1, "
          f"{gen_stats['decode_profile']['device_busy_ms_per_step']:.3f} without it (phase 4)")
    counts[FUSED_SHAPES_PATH], fused_shape_stats = phase4b_fused_step(params, cfg, dev)
    graph_ab = dict(k7_b32=graph_vs_eager_k7(params, cfg, dev),
                    engine_bf16=engine_graph_ab(params, cfg, "13d"),
                    engine_int8=engine_graph_ab(params, cfg, "13d", ENGINE_INT8, int8_trace))
    print(f"  phases 13b and 13d (Mistral width) done at {time.perf_counter() - t_start:.0f} s")
    beam_counts, beam_stats = phase14_beam(params, cfg, dev)
    counts.update(beam_counts)
    print(f"  phase 14a (beam search) done at {time.perf_counter() - t_start:.0f} s")
    cut = (dataclasses.replace(params, blocks=params.blocks[:ENGINE_LAYERS]),
           dataclasses.replace(cfg, num_hidden_layers=ENGINE_LAYERS))
    counts["engine"], engine_stats = phase_engine(*cut, "5", keep_streams=True)
    counts["penalised_engine"], pen_engine_stats = phase15_penalties(*cut, engine_stats, int8_trace)
    del engine_stats["streams"]
    print(f"  phases 5 and 15 done at {time.perf_counter() - t_start:.0f} s")
    engine_stats["timing"] = engine_timing(*cut, "5")
    engine_stats["k13_host_ab"] = engine_host_ab(*cut, "12b")
    counts["checkpoint"], ckpt_stats = phase7_checkpoint(params, cfg, dev)
    counts["int8_engine"], int8_stats = phase_engine(*cut, "9c", ENGINE_INT8, int8_trace)
    del cut
    cut = (dataclasses.replace(params, blocks=params.blocks[:A8_ENGINE_LAYERS]),
           dataclasses.replace(cfg, num_hidden_layers=A8_ENGINE_LAYERS))
    with switches(QUICK_TPU_A8="1"):  # [12e]: K11 at the [8, 16] chunks
        counts[A8_INT8_ENGINE], a8_int8_stats = phase_engine(*cut, "12e", ENGINE_INT8, int8_trace)
    del cut
    print(f"  phases 4, 5, 7, 9c, 12c and 12e done at {time.perf_counter() - t_start:.0f} s")
    del params
    torch.cuda.empty_cache()
    moe_counts, moe_report, moe_rows = phase8_moe(dev)
    counts.update(moe_counts)
    rows += moe_rows
    print(f"  phase 8 done at {time.perf_counter() - t_start:.0f} s")
    from quick_tpu_torch.examples.basic_quant import PRESETS

    qwen = PRESETS["qwen1.5-moe-a2.7b"]
    gen = torch.Generator(device=dev).manual_seed(10)
    rows += dequant_rows("Mistral-7B width (GGUF)", gemm_shapes(cfg), GGUF_K9_CASES, 32, gen, dev)
    rows += dequant_rows("Qwen1.5-MoE attention and shared expert",
                         {f"{K}x{N}": (K, N) for K, N, _ in k1_projections(qwen)},
                         QWEN_K9_CASES, QWEN_G, gen, dev)
    rows += grouped_rows("qwen1.5-moe-a2.7b", qwen, gen, dev, group=QWEN_G,
                         cases=QWEN_K8_CASES, tag="10")
    gguf_counts, gguf_stats = phase10_gguf(dev)
    counts.update(gguf_counts)
    counts[QWEN_G_PATH], qwen_g_stats = phase10_qwen(dev)
    print(f"  phase 10a-c done at {time.perf_counter() - t_start:.0f} s")
    ds_counts, ds_report, ds_rows = phase11_deepseek(dev)
    counts.update(ds_counts)
    rows += ds_rows
    print(f"  phase 11 done at {time.perf_counter() - t_start:.0f} s")
    qwen3_counts, qwen3_report, qwen3_rows = phase17_qwen3(dev)
    counts.update(qwen3_counts)
    rows += qwen3_rows
    print(f"  phase 17 done at {time.perf_counter() - t_start:.0f} s")
    family_counts, family_report, family_rows = phase18_rms_families(dev)
    counts.update(family_counts)
    rows += family_rows
    print(f"  phase 18 done at {time.perf_counter() - t_start:.0f} s")
    for row in rows:  # (path, kernel, key) -> this shape's launches on that path
        path, kernel, key = row["launches"]
        row["launches"] = counts[path][kernel].get(key, 0)
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on the {path} path")
    dense_err = phase6_dense_plain_vs_kernel(cfg, dev)
    dense_k7_err = phase6_dense_plain_vs_kernel(cfg, dev, B=16, max_seq=512, prompt=64,
                                                decode_kernel="decode_attention")
    paged_err = phase6_paged_plain_vs_kernel(cfg, dev)
    int8_err = phase9_int8_plain_vs_kernel(cfg, dev)
    small_g_err, small_g_forms = phase10_plain_vs_kernel(dev)
    with switches(QUICK_TPU_A8="1"):  # [12f] K11 at the prefill's 512 rows
        a8_err = phase6_dense_plain_vs_kernel(cfg, dev, tag="12f", tol=TOL_A8_MODEL,
                                              prefill_kernel="quantized_matmul_a8")
    with switches(QUICK_TPU_LAYER_TAIL="1"):  # [13c] K14 at every decode layer
        tail_err = dict(
            dense=phase6_dense_plain_vs_kernel(
                cfg, dev, tag="13c", require={"fused_layer_tail": 2 * PHASE6_DECODE}),
            paged=phase6_paged_plain_vs_kernel(
                cfg, dev, tag="13c", require={"fused_layer_tail": 2 * PHASE6_DECODE}))
    penalties = phase13_penalties(cfg, dev)
    beam_stats["plain_vs_kernel"] = phase14_plain_vs_kernel(cfg, dev)
    print(f"  phases 6-15 done at {time.perf_counter() - t_start:.0f} s")
    awq_counts, awq_report = phase16_awq(dev)
    counts.update(awq_counts)
    report = dict(card=card, kernels=rows, dense_route=dense_route, generate_path=gen_stats,
                  engine_path=engine_stats,
                  fused_step_shapes=fused_shape_stats,
                  launch_counts=counts, checkpoint_path=ckpt_stats, moe=moe_report,
                  int8_engine_path=int8_stats, gguf_path=gguf_stats, qwen_g64_path=qwen_g_stats,
                  gguf_cpu_forms_gap=small_g_forms, deepseek=ds_report,
                  a8=dict(generate=a8_gen_stats, int8_engine=a8_int8_stats, deepseek_k11=ds_a8,
                          plain_vs_kernel_max_abs_err=dict(
                              dense=a8_err, mixtral=moe_report["plain_vs_kernel_a8"]["max_abs_err"])),
                  phase6_max_abs_err=dict(dense=dense_err, dense_k7=dense_k7_err, paged=paged_err,
                                          int8_paged=int8_err, **small_g_err),
                  k13_graph=k13_graph,
                  layer_tail=dict(kernel=tail_every, generate=tail_gen_stats,
                                  plain_vs_kernel_max_abs_err=tail_err),
                  graphs=dict(graph_ab, mixtral_engine=moe_report["mixtral_engine_graph_ab"],
                              deepseek_engines=ds_report["engine_graph_ab"]),
                  penalties=penalties, k4_graph=k4_graph, beam=beam_stats,
                  penalised_engine=pen_engine_stats, awq=awq_report, qwen3=qwen3_report,
                  rms_families=family_report,
                  seconds=time.perf_counter() - t_start)
    out = ROOT / "build" / "chip_smoke_report.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"done in {report['seconds']:.0f} s; report in build/chip_smoke_report.json")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
