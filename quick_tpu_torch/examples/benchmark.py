"""End-to-end generation benchmark; the port's counterpart of
``examples/benchmark.py``:

    python -m quick_tpu_torch.examples.benchmark --random mistral-7b
    python -m quick_tpu_torch.examples.benchmark --quant_path out/ --batches 1,8,32
    python -m quick_tpu_torch.examples.benchmark --random debug --batches 2 --device cpu
    python -m quick_tpu_torch.examples.benchmark --random mistral-7b --group 32 --batches 1

Sweeps batch sizes at fixed prompt and generation lengths (the 128/128
protocol) and prints one JSON row per round: prefill time and tok/s, decode
time per token and tok/s. Times are host clocks ended by
``torch.cuda.synchronize()``, the minimum over ``trials`` runs after a
warm-up. Decode time per token is differential, ``(t(gen) - t(1)) /
(gen - 1)``, so the fixed cost of a call (the first step's launch queue,
the final sync) drops out. Every timed greedy decode must give the same
tokens. Running out of memory ends the sweep with a report row; any other
error propagates.
"""
import argparse
import json
import time
import types

import numpy as np
import torch

from quick_tpu_torch.runtime import decode_loop, make_cache, prefill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_once(fn, dev, *args):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(dev)
    return time.perf_counter() - t0, out


def run_round(model, batch: int, ctx: int, gen: int, trials: int = 3) -> dict:
    """One round of the protocol: ``batch`` random prompts of ``ctx`` tokens
    (seed 0), then ``gen`` greedy tokens. Runs 1 + trials prefills and
    2 + 2 trials decode loops (of 1 and ``gen`` steps); the row says how many
    forwards of each kind it ran."""
    cfg, params = model.cfg, model.params
    dev = params.embed.device
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, ctx))).to(dev)
    max_seq = ctx + gen

    def prefill_once():
        cache = make_cache(cfg, batch, max_seq, device=dev)
        return prefill(params, cfg, tokens, cache)

    _, (first_logits, cache0) = time_once(prefill_once, dev)  # warm-up
    t_prefill = min(time_once(prefill_once, dev)[0] for _ in range(trials))
    first = torch.argmax(first_logits, dim=-1)

    def decode_n(n):  # rewrites the same cache rows from position ctx on
        return decode_loop(params, cfg, first, cache0, n)[0]

    decode_n(1)
    ref = decode_n(gen)
    t1 = min(time_once(decode_n, dev, 1)[0] for _ in range(trials))
    tg = []
    for _ in range(trials):
        t, toks = time_once(decode_n, dev, gen)
        if not torch.equal(toks, ref):
            raise RuntimeError("two greedy decodes of the same prompts gave other tokens")
        tg.append(t)
    t_tok = (min(tg) - t1) / (gen - 1)
    return {
        "batch": batch, "ctx": ctx, "gen": gen,
        "prefill_tok_s": batch * ctx / t_prefill, "decode_tok_s": batch / t_tok,
        "prefill_ms": t_prefill * 1e3, "decode_ms_per_tok": t_tok * 1e3,
        "forwards": {"prefill": 1 + trials, "decode": (1 + gen) * (1 + trials)},
    }


def main(argv=None):
    from quick_tpu_torch.device import resolve_device
    from quick_tpu_torch.examples.basic_quant import PRESETS
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.model import init_quant_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--quant_path")
    ap.add_argument("--random", help="random preset (see basic_quant.py)")
    ap.add_argument("--group", type=int, default=128,
                    help="quant group of the --random packed weights: 128 (K1, K8), or 32 "
                         "(GGUF's group) and 64 (the small-group kernel K9; K8 at G=64)")
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--gen", type=int, default=128)
    ap.add_argument("--batches", default="1,8,32,64,128,256")
    ap.add_argument("--lengths", help="sweep ctx=gen lengths at a fixed batch instead "
                    "of sweeping batch, e.g. '32,128,512,2048'")
    ap.add_argument("--batch", type=int, default=1, help="batch for the --lengths sweep")
    ap.add_argument("--trials", type=int, default=3, help="timed runs per measurement")
    ap.add_argument("--device", default=None, help="'cpu' for the plain path (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.quant_path:
        model = AutoQuickModel.from_quantized(args.quant_path, device=dev)
    else:
        # random weights, made directly in packed form (seed 0)
        import dataclasses

        cfg = PRESETS[args.random or "debug"]
        if args.lengths:  # rope tables must cover ctx + gen
            need = 2 * max(int(n) for n in args.lengths.split(","))
            if need > cfg.max_position_embeddings:
                cfg = dataclasses.replace(cfg, max_position_embeddings=need)
        model = types.SimpleNamespace(
            cfg=cfg, params=init_quant_params(cfg, seed=0, group_size=args.group, device=dev))
    if dev.type == "cuda":
        print(json.dumps({"device": torch.cuda.get_device_name(dev)}), flush=True)
    if args.lengths:
        rounds = [(args.batch, int(n), int(n)) for n in args.lengths.split(",")]
    else:
        rounds = [(int(b), args.ctx, args.gen) for b in args.batches.split(",")]
    rows = []
    for batch, ctx, gen in rounds:
        try:
            row = run_round(model, batch, ctx, gen, args.trials)
        except (torch.cuda.OutOfMemoryError, MemoryError) as e:  # report and stop
            rows.append({"batch": batch, "ctx": ctx, "error": str(e)[:200]})
            print(json.dumps(rows[-1]), flush=True)
            break
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
