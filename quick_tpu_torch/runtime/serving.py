"""Continuous-batching inference engine over the paged KV cache (port of
``quick_tpu/runtime/serving.py``).

Requests are admitted and retired independently (continuous batching) and
prefill is chunked. Per scheduler turn, with ``decode_window`` > 1 (the
decoupled schedule): decoding slots advance through a pipelined decode
window of W forward steps over all ``max_slots`` rows ([B, 1] each, the
sampled token feeding the next step on the device), and prefilling slots
advance through [prefill_rows, chunk] sub-batches over gathered slot
metadata (``PagedKVCache.select`` / ``merge``); the padded [B, chunk] or
[B, 1] mixed step serves cold start, capacity-tight tails and
``decode_window=1``. Scheduling (admission, page allocation, retirement,
prefix caching, preemption) is host-side Python, as in the JAX package.
MoE models run through the same programs: the padded rows of a chunk or
of an idle slot get zero expert weights (``advance`` -> ``model_forward``'s
token mask), and their routing stays on the device.

What differs from the JAX package, which jits each program:
- The W steps of a window are a Python loop (the JAX ``fori_loop``,
  :445-481). On the card a greedy window replays one [max_slots, 1] step
  captured as a CUDA graph (``runtime/graphs.py``; tokens, valid rows and
  lengths are copied into its static buffers before the first replay, the
  block table and pages are read in place); the first greedy window runs
  its first step eagerly and captures the step, which synchronizes once.
  Sampled windows and the [prefill_rows, chunk] sub-steps stay eager.
  Everything a dispatch sends to the card goes through pinned
  memory without blocking (``device.to_device``), and each window's and
  each completed prefill's sampled tokens are copied back behind an event;
  the host waits on that event when it drains them, one wait per window,
  and never while it dispatches.
- The page tensors are written in place (K4 or its scatter); admission and
  retirement write the block table and lengths in place too. Every write is
  queued on the one stream behind the work already dispatched, so an
  in-flight window reads the table as it was when the window was queued,
  as the JAX program reads its own operands.
- Random draws come from a ``torch.Generator`` seeded by ``seed``; sampled
  streams do not reproduce ``jax.random``'s, greedy streams match.

``dtype=torch.int8`` serves from INT8 KV pages (``PagedKVCache``: codes
plus per-page scale tiles, written by K4q and read by K5q / K6q on the
card); preemption and the prefix cache hand pages on whole, scale tiles
with them. MLA models (DeepSeek-V2 / V3) serve from paged LATENT pages:
one kv head, k_pe in the k plane, the latent in the v plane, bf16 or INT8,
read at decode by K10 / K10q. Not ported, raising ``NotImplementedError``:
tensor-parallel serving (``mesh``, ROADMAP A15).

``enable_penalties=True`` keeps the JAX Engine's per-slot penalty state on
the device, three static [max_slots, V] buffers: the generated-token counts
(int32), the prompt-token mask (int8) and the additive ``logit_bias`` row
(f32), rebuilt on the host at each admission (and so after a preemption).
Every program applies ``apply_penalties`` and the bias to its rows before
it samples (the delivered logprobs are post-penalty) and counts the tokens
it will deliver; a greedy window replays the penalised step as one graph.
Without it, penalised ``SamplingParams`` and ``logit_bias`` raise the JAX
Engine's ``ValueError``.

The JAX package's two switches: ``QUICK_TPU_ENGINE_TIMING=1`` (read when the
Engine is made) fills ``timing`` with the host seconds of each phase of a
turn (``time.perf_counter``, no synchronization of its own);
``QUICK_TPU_MIXED_COLD=1`` (read at every turn) takes the padded mixed step
while more slots prefill than decode, as the JAX Engine's round-3 schedule.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.device import DeviceLike, resolve_device, to_device
from quick_tpu_torch.models.model import ModelParams, check_supported, model_forward
from quick_tpu_torch.modules.paged_cache import TRASH_PAGE, PageAllocator, PagedKVCache
from quick_tpu_torch.runtime.generate import SamplingParams, apply_penalties, sample_token_rows
from quick_tpu_torch.runtime.prefix_cache import PrefixCache, page_hashes


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    # additional stop tokens (any hit ends the request)
    stop_token_ids: Optional[frozenset] = None
    # streaming: on_token(uid, token_id) for every token delivered (decode
    # windows deliver in bursts of up to ``decode_window`` tokens)
    on_token: Optional[Callable[[int, int], None]] = None
    # per-request SamplingParams; None falls back to the engine's default
    sampling: Optional[tuple] = None
    # runtime state
    output: List[int] = dataclasses.field(default_factory=list)
    # OpenAI logit_bias: {token_id: additive bias} added to every sampling
    # distribution of this request (needs enable_penalties)
    logit_bias: Optional[dict] = None
    # per delivered token: its logprob under the (post-penalty) model
    # distribution, and
    # with Engine(logprobs_topk=K) the top-K [(token_id, logprob), ...]
    logprobs: List[float] = dataclasses.field(default_factory=list)
    top_logprobs: List[list] = dataclasses.field(default_factory=list)
    prefill_cursor: int = 0
    aborted: bool = False
    # prefix caching: chain hashes of the prompt's shareable full pages, and
    # how many leading pages this request reuses from the index
    page_hashes: List[bytes] = dataclasses.field(default_factory=list)
    n_reused: int = 0
    # preemption-by-recompute (reserve="optimistic"): feed tokens prefill
    # must cover (None: len(prompt)); a preempted request requeues with
    # prompt + delivered output, and only new samples are emitted
    resume_len: Optional[int] = None
    # output length at preemption: after a resume the slot decodes only
    # once output has grown past it (the prefill-completion sample landed)
    resume_out: int = 0
    admit_seq: int = 0  # admission order; preemption evicts the youngest
    # cached [7] f32 sampling row (temp, top_k, top_p, min_p, rep, freq, pres)
    _samp_np: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    #: scheduling priority (higher admits first; ties FIFO). Preemption
    #: evicts the lowest-priority slot first, youngest within a priority.
    priority: int = 0

    @property
    def _resume(self) -> int:
        return len(self.prompt) if self.resume_len is None else self.resume_len

    def feed(self, lo: int, hi: int) -> List[int]:
        """Tokens [lo:hi) of the prefill feed (prompt, then — after a
        preemption — the already-generated output)."""
        if hi <= len(self.prompt):
            return self.prompt[lo:hi]
        return (self.prompt + self.output)[lo:hi]

    @property
    def prefill_done(self) -> bool:
        return self.prefill_cursor >= self._resume

    @property
    def done(self) -> bool:
        if self.aborted or len(self.output) >= self.max_new_tokens:
            return True
        if not self.output:
            return False
        last = self.output[-1]
        if self.eos_token_id is not None and last == self.eos_token_id:
            return True
        return bool(self.stop_token_ids) and last in self.stop_token_ids


class _Fetch:
    """Device tensors copied back to the host behind the work queued so far.
    On the card the copies go to pinned memory without blocking and an event
    marks their end; ``get`` waits on that event only."""

    def __init__(self, *tensors: Optional[torch.Tensor]):
        self.event = None
        if any(t is not None and t.is_cuda for t in tensors):
            self.host = [
                None if t is None else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors
            ]
            for h, t in zip(self.host, tensors):
                if t is not None:
                    h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def get(self) -> List[Optional[np.ndarray]]:
        if self.event is not None:
            self.event.synchronize()
        return [None if h is None else h.numpy() for h in self.host]


class Engine:
    """Continuous-batching engine.

    Usage::

        eng = Engine(params, cfg, max_slots=4, max_seq=512)  # on the card
        eng.submit([1, 2, 3], max_new_tokens=32)
        outputs = eng.run()          # {uid: [token, ...]}

    ``device`` is the card unless given "cpu" (the plain path); ``params``
    must live there. ``stats`` counts the schedule: besides the JAX
    package's keys, ``window_forwards`` (forward steps run by decode
    windows, the sum of their widths) and ``mixed_chunk_steps`` (mixed
    steps at [B, chunk]; the rest ran at [B, 1]).
    """

    def __init__(
        self,
        params: ModelParams,
        cfg: ModelConfig,
        max_slots: int = 4,
        max_seq: int = 512,
        page_size: int = 64,
        chunk: int = 16,
        n_pages: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,  # torch.int8: INT8 KV pages
        # (0.5625x the bf16 pool's bytes: codes plus f32 scale tiles)
        mesh=None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        decode_window: int = 8,  # decode steps per dispatched window; the
        # host syncs once per window. 1 restores step-at-a-time behavior
        prefill_rows: int = 8,  # sub-batch width of the decoupled prefill
        prefix_cache: bool = True,  # reuse the KV pages of shared prompt
        # prefixes (runtime/prefix_cache.py)
        logprobs_topk: int = 0,  # also return the top-K (token, logprob)
        # alternatives per delivered token
        enable_penalties: bool = False,
        reserve: str = "full",  # "full": admission reserves prompt +
        # max_new_tokens; "optimistic": prompt + a window of headroom, slots
        # grow as they decode and the youngest is preempted (recomputed)
        # when the pool runs out
        device: DeviceLike = None,
        _graphs: bool = True,  # False: every window eager (a measurement's
        # or a test's comparison on the card)
    ):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh) is not ported yet — ROADMAP A15"
            )
        if sampling is not None and sampling.has_penalties and not enable_penalties:
            raise ValueError("history penalties need Engine(enable_penalties=True)")
        check_supported(cfg)  # other families raise (A12)
        dev = resolve_device(device)
        if params.embed.device.type != dev.type:
            raise ValueError(
                f"params live on {params.embed.device}, the engine runs on {dev}"
            )
        self.device = params.embed.device
        self.sampling = sampling or SamplingParams()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.chunk = chunk
        self.page_size = page_size
        pages_per_seq = (max_seq + page_size - 1) // page_size
        if n_pages is None:
            n_pages = max_slots * pages_per_seq + 1  # +1 trash page
        if cfg.is_mla:
            # the paged LATENT cache (serving.py:199-208): one kv head, the
            # rope'd k_pe in the k plane and the latent in the v plane
            self.cache = PagedKVCache.create(
                cfg.num_hidden_layers, n_pages, page_size, max_slots, max_seq, 1,
                cfg.qk_rope_head_dim, dtype, device=self.device, v_head_dim=cfg.kv_lora_rank,
            )
        else:
            self.cache = PagedKVCache.create(
                cfg.num_hidden_layers, n_pages, page_size, max_slots, max_seq,
                cfg.num_key_value_heads, cfg.head_dim, dtype, device=self.device,
            )
        if reserve not in ("full", "optimistic"):
            raise ValueError(f"reserve must be 'full'|'optimistic': {reserve}")
        self.optimistic = reserve == "optimistic"
        self.topk = int(logprobs_topk)
        self.penalties = enable_penalties
        if enable_penalties:
            # per slot: generated-token counts, prompt-token mask, logit_bias
            V = cfg.vocab_size
            self.counts = torch.zeros((max_slots, V), dtype=torch.int32, device=self.device)
            self.pseen = torch.zeros((max_slots, V), dtype=torch.int8, device=self.device)
            self.lbias = torch.zeros((max_slots, V), dtype=torch.float32, device=self.device)
        self.alloc = PageAllocator(n_pages)
        self._admit_seq = 0
        self.prefix: Optional[PrefixCache] = PrefixCache(self.alloc) if prefix_cache else None
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self.finished: Dict[int, List[int]] = {}
        self.requests: Dict[int, Request] = {}
        self._uid = 0
        self.decode_window = max(1, decode_window)
        self.prefill_rows = max(1, min(prefill_rows, max_slots))
        # the dispatched, not yet drained decode window (see _dispatch_window)
        self._inflight = None
        # the captured [max_slots, 1] decode step and its static buffers
        # (token, valid, lengths); keyed by the page and table tensors it reads
        self._graphs = _graphs and self.device.type == "cuda"
        self._graph = self._graph_key = None
        self.graph_replays = 0  # replays of the captured step (windows' steps)
        self._g_tok = self._g_valid = self._g_len = self._g_pen = None
        # completed prefills' first-token samples not yet fetched:
        # (_Fetch, [(row, slot, request)], dispatch seq) — see _drain_pending
        self._pending = []
        # host seconds per phase of a turn under QUICK_TPU_ENGINE_TIMING=1
        # (the JAX Engine's keys, :270-279); a fetch is "serial" when nothing
        # was dispatched after the fetched work (the card idles while the
        # host waits): every dispatch bumps _dispatch_seq
        self._timed = os.environ.get("QUICK_TPU_ENGINE_TIMING") == "1"
        self._dispatch_seq = 0
        self.timing = dict.fromkeys(
            ("admit", "window_dispatch", "window_fetch", "window_fetch_serial",
             "prefill_dispatch", "pending_fetch", "pending_fetch_serial", "mixed"), 0.0)
        self.stats = {
            "steps": 0,            # scheduler turns
            "window_steps": 0,     # decode-window dispatches
            "window_forwards": 0,  # forward steps run by decode windows
            "prefill_substeps": 0,  # decoupled [P, chunk] dispatches
            "mixed_steps": 0,      # padded [B, chunk] / [B, 1] dispatches
            "mixed_chunk_steps": 0,  # ... of which at [B, chunk]
            "tokens_out": 0,       # sampled tokens delivered to requests
            "prompt_tokens": 0,    # prompt tokens consumed by prefill
            "admitted": 0,
            "retired": 0,
            "decode_slot_steps": 0,  # sum over windows of ready-slots * W
            "prefix_hit_tokens": 0,  # prompt tokens served from the index
            "preemptions": 0,        # slots evicted for pages (optimistic)
        }

    # -- the device programs ------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    def _forward_rows(self, cache, tokens, valid):
        """(logits [B, V] at each row's last valid token, cache)."""
        logits, cache = model_forward(
            self.params, self.cfg, tokens, cache, advance=valid, last_valid=valid,
        )
        return logits[:, 0], cache

    def _penalised(self, row, pen, rows=None):
        """Under ``enable_penalties``: the rows' logits with the history
        penalties and the logit bias applied (:357-359), ``pen`` the
        [3, B] (rep, freq, pres) on the device and ``rows`` the slots of a
        gathered sub-batch (None: every slot)."""
        if not self.penalties:
            return row
        c, m, b = ((self.counts, self.pseen, self.lbias) if rows is None else
                   (self.counts[rows], self.pseen[rows], self.lbias[rows]))
        return apply_penalties(row, c, m, pen[0], pen[1], pen[2]) + b

    def _count(self, tokens, emit, rows=None) -> None:
        """Add ``emit`` [B] (1 for a sample that will be delivered) to each
        row's slot count of its sampled token."""
        if self.penalties:
            slots = torch.arange(self.max_slots, device=self.device) if rows is None else rows
            self.counts.index_put_((slots, tokens.to(torch.int64)), emit.to(torch.int32),
                                   accumulate=True)

    def _pen_rows(self, samp):
        """The (rep, freq, pres) rows of ``_samp_rows`` as one [3, B] f32
        device tensor, or None without penalties."""
        if not self.penalties:
            return None
        return self._dev(np.ascontiguousarray(np.stack(samp[4:7])))

    def _draw(self, row: torch.Tensor, samp):
        """Sample one token per row and its logprob. Returns (tl [B, 2] int32
        (token, bitcast-f32 logprob), tk [B, K, 2] int32 (id, bitcast-f32
        logprob) or None): packed int32 planes, one host fetch each."""
        s = sample_token_rows(row, *samp[:3], generator=self._gen, min_ps=samp[3])
        rf = row.to(torch.float32)
        lse = torch.logsumexp(rf, dim=-1)
        lp = torch.gather(rf, 1, s[:, None])[:, 0] - lse
        tl = torch.stack([s.to(torch.int32), lp.view(torch.int32)], dim=-1)
        tk = None
        if self.topk:
            tv, ti = torch.topk(rf, self.topk, dim=-1)
            tk = torch.stack(
                [ti.to(torch.int32), (tv - lse[:, None]).view(torch.int32)], dim=-1
            )
        return tl, tk

    def _window(self, tokens: torch.Tensor, valid: torch.Tensor, samp, W: int):
        """W decode steps over all slots; each step's samples feed the next
        on the device. Returns (tl [B, W, 2], tk [B, W, K, 2] or None)."""
        B = tokens.shape[0]
        tl_all = torch.empty((B, W, 2), dtype=torch.int32, device=self.device)
        tk_all = (torch.empty((B, W, self.topk, 2), dtype=torch.int32, device=self.device)
                  if self.topk else None)
        if self._graphs and not (np.asarray(samp[0]) > 0).any():
            return self._window_graphed(tokens, valid, samp, W, tl_all, tk_all)
        cache = self.cache
        pen = self._pen_rows(samp)
        for i in range(W):
            row, cache = self._forward_rows(cache, tokens, valid)
            tl, tk = self._draw(self._penalised(row, pen), samp)
            self._count(tl[:, 0], valid)
            tl_all[:, i] = tl
            if tk_all is not None:
                tk_all[:, i] = tk
            tokens = tl[:, :1].to(torch.int64)
        self.cache = cache
        return tl_all, tk_all

    def _graph_step(self, samp):
        """One greedy [max_slots, 1] step over the static buffers: the
        sampled token feeds the next step, the lengths advance in place."""
        cache = dataclasses.replace(self.cache, length=self._g_len)
        row, cache = self._forward_rows(cache, self._g_tok, self._g_valid)
        tl, tk = self._draw(self._penalised(row, self._g_pen), samp)
        self._count(tl[:, 0], self._g_valid)
        self._g_len.copy_(cache.length)
        self._g_tok.copy_(tl[:, :1].to(torch.int64))
        return tl, tk

    def _window_graphed(self, tokens, valid, samp, W, tl_all, tk_all):
        """``_window`` for an all-greedy window on the card: replays of the
        captured step (captured at the first such window, after an eager
        first step, and again if the page or table tensors change)."""
        from quick_tpu_torch.runtime.graphs import StepGraph

        c = self.cache
        key = tuple(None if t is None else t.data_ptr()
                    for t in (c.k_pages, c.v_pages, c.kv_scales, c.block_table))
        if self._g_tok is None:
            B = self.max_slots
            self._g_tok = torch.zeros((B, 1), dtype=torch.int64, device=self.device)
            self._g_valid = torch.zeros((B,), dtype=torch.int32, device=self.device)
            self._g_len = torch.zeros((B,), dtype=torch.int32, device=self.device)
            if self.penalties:
                self._g_pen = torch.zeros((3, B), dtype=torch.float32, device=self.device)
        self._g_tok.copy_(tokens)
        if self.penalties:
            self._g_pen.copy_(self._pen_rows(samp))
        self._g_valid.copy_(valid)
        self._g_len.copy_(c.length)
        first = 0
        if self._graph is None or self._graph_key != key:
            tl, tk = self._graph_step(samp)  # eager: the window's first step
            tl_all[:, 0] = tl
            if tk_all is not None:
                tk_all[:, 0] = tk
            self._graph = StepGraph(lambda: self._graph_step(samp))
            self._graph_key, first = key, 1
        tl, tk = self._graph.out
        for i in range(first, W):
            self._graph.replay()
            self.graph_replays += 1
            tl_all[:, i] = tl
            if tk_all is not None:
                tk_all[:, i] = tk
        self.cache = dataclasses.replace(c, length=self._g_len.clone())
        return tl_all, tk_all

    # -- submission -------------------------------------------------------------
    def submit(
        self,
        prompt: List[int],
        max_new_tokens: int,
        eos_token_id: Optional[int] = None,
        stop_token_ids=None,
        on_token: Optional[Callable[[int, int], None]] = None,
        sampling: Optional[SamplingParams] = None,
        logit_bias: Optional[dict] = None,
        priority: int = 0,  # higher admits first; preempted last
    ) -> int:
        if sampling is not None and sampling.has_penalties and not self.penalties:
            raise ValueError("history penalties need Engine(enable_penalties=True)")
        if logit_bias and not self.penalties:
            raise ValueError("logit_bias needs Engine(enable_penalties=True)")
        if not prompt:
            raise ValueError("empty prompt")
        full_need = -(-(len(prompt) + max_new_tokens) // self.page_size)
        max_pages = self.cache.block_table.shape[1]
        if full_need > max_pages:
            # reject here, in the caller's thread: at admission the request
            # could never become admissible
            raise ValueError(
                f"prompt + max_new_tokens needs {full_need} pages > table "
                f"width {max_pages}; raise max_seq or shorten the request"
            )
        uid = self._uid
        self._uid += 1
        req = Request(
            uid, list(prompt), max_new_tokens, eos_token_id,
            frozenset(stop_token_ids) if stop_token_ids else None,
            on_token, sampling, logit_bias=dict(logit_bias or {}) or None, priority=priority,
        )
        self.queue.append(req)
        # uid -> Request registry (logprobs live here); callers pop it
        self.requests[uid] = req
        return uid

    def _samp_rows(self, reqs):
        """Per-row sampling host arrays (temps, top_ks, top_ps, min_ps), and
        under ``enable_penalties`` (reps, freqs, press) after them. None rows
        (idle or padding) are greedy and unpenalised, so an all-greedy batch
        stays on the argmax-only path of sample_token_rows."""
        m = np.zeros((len(reqs), 7), np.float32)
        m[:, 2] = 1.0  # top_p
        m[:, 4] = 1.0  # repetition_penalty
        for i, r in enumerate(reqs):
            if r is None:
                continue
            row = r._samp_np
            if row is None:
                sp = r.sampling or self.sampling
                row = np.asarray(
                    [sp.temperature, sp.top_k, sp.top_p, getattr(sp, "min_p", 0.0),
                     sp.repetition_penalty, sp.frequency_penalty, sp.presence_penalty],
                    np.float32,
                )
                r._samp_np = row
            m[i] = row
        base = (m[:, 0], m[:, 1].astype(np.int64), m[:, 2], m[:, 3])
        return base + (m[:, 4], m[:, 5], m[:, 6]) if self.penalties else base

    def pop_finished(self, uid: int) -> Optional[List[int]]:
        """Release a completed request's bookkeeping (its ``finished``
        output and its Request). Long-running callers must pop what they
        consume, or the per-request state accumulates."""
        self.requests.pop(uid, None)
        return self.finished.pop(uid, None)

    @torch.no_grad()
    def abort(self, uid: int) -> bool:
        """Cancel a request. Queued requests are dropped; active ones retire
        at once with what they produced so far (an in-flight window may
        still compute the slot: its tokens are discarded by the drain's done
        guard, its page writes land on the reset trash table row). Returns
        False if the uid is unknown or already finished."""
        for req in self.queue:
            if req.uid == uid:
                req.aborted = True
                self.queue.remove(req)
                self.finished[uid] = req.output
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.uid == uid:
                req.aborted = True
                self._retire(slot)
                return True
        return False

    def _emit(self, req: Request, token: int, lp: Optional[float] = None,
              top: Optional[list] = None) -> None:
        req.output.append(token)
        if lp is not None:
            req.logprobs.append(lp)
        if top is not None:
            req.top_logprobs.append(top)
        self.stats["tokens_out"] += 1
        if req.on_token is not None:
            req.on_token(req.uid, token)

    @staticmethod
    def _unpack_tl(arr: np.ndarray):
        """Split a packed [..., 2] int32 (token, bitcast-f32 logprob) plane."""
        toks = arr[..., 0]
        lps = np.ascontiguousarray(arr[..., 1]).view(np.float32)
        return toks, lps

    @staticmethod
    def _top_list(tk_row: np.ndarray) -> list:
        """[K, 2] int32 (id, bitcast-f32 logprob) -> [(id, lp), ...]."""
        ids = tk_row[:, 0]
        vals = np.ascontiguousarray(tk_row[:, 1]).view(np.float32)
        return list(zip(ids.tolist(), vals.tolist()))

    # -- block table (written in place, in stream order) ---------------------------
    def _set_table_row(self, slot: int, pages: List[int]) -> None:
        row = np.full((self.cache.block_table.shape[1],), TRASH_PAGE, np.int32)
        row[: len(pages)] = pages
        self.cache.block_table[slot] = self._dev(row)

    def _set_penalty_rows(self, slot: int, req: Request) -> None:
        """The slot's penalty state, rebuilt on the host at admission
        (:686-706): the prompt's tokens marked seen (repetition), the output
        already delivered (a preempted request's) counted (frequency and
        presence), and the request's ``logit_bias`` row."""
        V = self.cfg.vocab_size
        seen = np.zeros((V,), np.int8)
        seen[np.asarray(req.prompt, np.int64)] = 1
        cnt = np.bincount(np.asarray(req.output, np.int64), minlength=V).astype(np.int32)
        bias = np.zeros((V,), np.float32)
        for tid, b in (req.logit_bias or {}).items():
            if 0 <= int(tid) < V:
                bias[int(tid)] = float(b)
        self.pseen[slot] = self._dev(seen)
        self.counts[slot] = self._dev(cnt[:V])
        self.lbias[slot] = self._dev(bias)

    def _reset_slot(self, slot: int) -> None:
        # an idle slot still takes part in every batched step (padding
        # tokens): its writes must land on the trash page, never on pages
        # since handed to other requests
        self.cache.block_table[slot] = TRASH_PAGE
        self.cache.length[slot] = 0

    # -- scheduling -------------------------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = max(self.queue, key=lambda r: r.priority)  # FIFO in ties
            full_need = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
            max_pages = self.cache.block_table.shape[1]
            if full_need > max_pages:
                raise ValueError(
                    f"request {req.uid} needs {full_need} pages > table "
                    f"width {max_pages}; raise max_seq"
                )
            if self.optimistic:
                # prompt (or resumed feed) + one pipelined decode window of
                # headroom; the slot grows from there (_ensure_pages)
                w2 = 2 * self.decode_window + 1
                need = min(-(-(req._resume + w2) // self.page_size), full_need)
            else:
                need = full_need
            covered = 0
            if self.prefix is not None:
                req.page_hashes = page_hashes(req.prompt, self.page_size)
                reused = self.prefix.match(req.page_hashes)
                fresh = self.prefix.alloc(need - len(reused))
                if fresh is None:
                    self.prefix.release(reused)
                    return  # no memory — retry after a retirement
                pages = reused + fresh
                req.n_reused = len(reused)
                covered = len(reused) * self.page_size
                req.prefill_cursor = covered
                self.stats["prefix_hit_tokens"] += covered
            else:
                pages = self.alloc.alloc(need)
                if pages is None:
                    return  # no memory — retry after a retirement
            self.queue.remove(req)
            self.stats["admitted"] += 1
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slots[slot] = req
            if self.penalties:
                self._set_penalty_rows(slot, req)
            self.slot_pages[slot] = pages
            self._set_table_row(slot, pages)
            # reused prefix pages are valid context: the slot starts
            # mid-prefill at ``covered`` tokens
            self.cache.length[slot] = covered

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        self.stats["retired"] += 1
        self.finished[req.uid] = req.output
        self._release_pages(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.slots[slot] = None
        self._reset_slot(slot)

    # -- optimistic reservation: growth + preemption ------------------------------
    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        if self.prefix is not None:
            return self.prefix.alloc(n)
        return self.alloc.alloc(n)

    def _release_pages(self, pages: List[int]) -> None:
        if self.prefix is not None:
            self.prefix.release(pages)
        else:
            self.alloc.release(pages)

    def _preempt(self, slot: int) -> None:
        """Evict a slot to free its pages: deliver what is already computed
        for it (flush the in-flight window and pending prefill samples),
        release the pages and requeue the request at the front. Re-admission
        rebuilds prompt + output by chunked prefill; nothing delivered is
        emitted again."""
        self._flush_window()
        self._drain_pending()
        req = self.slots[slot]
        if req is None or req.done:
            return  # the flush drained it to completion
        self.stats["preemptions"] += 1
        self._release_pages(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.slots[slot] = None
        self._reset_slot(slot)
        req.resume_len = len(req.prompt) + len(req.output)
        req.resume_out = len(req.output)
        req.prefill_cursor = 0
        req.n_reused = 0
        self.queue.appendleft(req)

    def _ensure_pages(self, slot: int) -> bool:
        """Grow a decoding slot's pages to cover its output plus one
        pipelined window of headroom. On pool exhaustion, preempt the
        youngest lower-or-equal-priority other slot and retry (or yield this
        slot). Returns False if this slot was retired or preempted."""
        req = self.slots[slot]
        if req is None:
            return False
        want = min(
            len(req.prompt) + len(req.output) + 2 * self.decode_window + 1,
            len(req.prompt) + req.max_new_tokens,
        )
        need = -(-want // self.page_size) - len(self.slot_pages[slot])
        if need <= 0:
            return True
        while True:
            pages = self._alloc_pages(need)
            if pages is not None:
                break
            # draining the pipeline may retire finished slots (free pages)
            self._flush_window()
            self._drain_pending()
            if self.slots[slot] is not req:
                return False
            pages = self._alloc_pages(need)
            if pages is not None:
                break
            others = [s for s, r in enumerate(self.slots) if r is not None and s != slot]
            if not others:
                raise RuntimeError(
                    f"page pool too small: request {req.uid} holds "
                    f"{len(self.slot_pages[slot])} pages and needs {need} "
                    f"more; raise n_pages"
                )
            victim = min(
                others,
                key=lambda s: (self.slots[s].priority, -self.slots[s].admit_seq),
            )
            if self.slots[victim].priority > req.priority:
                self._preempt(slot)  # every other slot outranks this one
                return False
            self._preempt(victim)
            if self.slots[slot] is not req:
                return False  # retired by the preemption's flush
        self.slot_pages[slot].extend(pages)
        self._set_table_row(slot, self.slot_pages[slot])
        return True

    def _register_prompt_pages(self, slot: int, req, old_cursor: int) -> None:
        """Publish prompt pages this slot finished writing (their chunk has
        been dispatched; a sharer's work is queued strictly after it)."""
        if self.prefix is None:
            return
        lo = max(old_cursor // self.page_size, req.n_reused)
        hi = min(req.prefill_cursor // self.page_size, len(req.page_hashes))
        for i in range(lo, hi):
            self.prefix.register(req.page_hashes[i], self.slot_pages[slot][i])

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    @property
    def max_seq(self) -> int:
        return self.page_size * self.cache.block_table.shape[1]

    def ready_slots(self) -> List[int]:
        """Slots whose next step is a decode step."""
        return [
            s for s, r in enumerate(self.slots)
            if r is not None and r.prefill_done and not r.done
            and len(r.output) > r.resume_out  # post-resume sample landed
        ]

    # -- the step ----------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """Admit, dispatch, drain, retire — one scheduler turn (the JAX
        ``Engine.step``, :874)."""
        t0 = time.perf_counter() if self._timed else 0.0
        self._admit()
        if self._timed:
            self.timing["admit"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        if self.optimistic:
            # top up every decoding slot BEFORE any dispatch this step: the
            # work queued below reads the block table as it stands
            for s in range(self.max_slots):
                r = self.slots[s]
                if r is not None and r.prefill_done and r.output and not r.done:
                    self._ensure_pages(s)
        W = self.decode_window
        prefilling = [
            s for s, r in enumerate(self.slots)
            if r is not None and not r.prefill_done
        ]
        ready = self.ready_slots()
        # QUICK_TPU_MIXED_COLD=1: the padded mixed step while prefilling
        # slots outnumber decoding ones (:922-928)
        decoupled = (os.environ.get("QUICK_TPU_MIXED_COLD") != "1"
                     or len(ready) >= len(prefilling))
        if W > 1 and decoupled and (ready or prefilling or self._pending):
            # capacity-tight tails SHRINK the window: a slot near max_seq
            # needs 2 * W_eff of junk-overrun slack (two undrained windows)
            W_eff = W
            if ready:
                worst = max(
                    len(self.slots[s].prompt) + len(self.slots[s].output)
                    for s in ready
                )
                while W_eff > 1 and worst + 2 * W_eff >= self.max_seq:
                    W_eff //= 2
                cap_ok = worst + 2 * W_eff < self.max_seq
            else:
                cap_ok = True
            if cap_ok:
                # dispatch everything first, then drain only results of
                # earlier steps: this step's prefill samples are queued
                # behind the window just dispatched, so they wait a step
                pending_prev, self._pending = self._pending, []
                prev = self._dispatch_window(ready, W_eff) if ready else None
                for off in range(0, len(prefilling), self.prefill_rows):
                    self._prefill_substep(prefilling[off : off + self.prefill_rows])
                if prev is not None:
                    self._drain_window(prev)
                elif not ready:
                    self._flush_window()  # stale in-flight, no new window
                self._drain_pending(pending_prev)
                return
        self._mixed_step()

    def _mixed_step(self) -> None:
        """The padded [B, chunk] (any slot prefilling) or [B, 1] step; it
        fetches its samples at once."""
        t0 = time.perf_counter() if self._timed else 0.0
        self._drain_pending()
        self._flush_window()
        if all(r is None for r in self.slots):
            return  # the flushes retired everything
        B = self.max_slots
        any_prefill = any(r is not None and not r.prefill_done for r in self.slots)
        C = self.chunk if any_prefill else 1
        tokens = np.zeros((B, C), np.int64)
        valid = np.zeros((B,), np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if not req.prefill_done:
                nxt = req.feed(req.prefill_cursor, min(req.prefill_cursor + C, req._resume))
                tokens[slot, : len(nxt)] = nxt
                valid[slot] = len(nxt)
            else:
                tokens[slot, 0] = req.output[-1] if req.output else req.prompt[-1]
                valid[slot] = 1
        row, self.cache = self._forward_rows(self.cache, self._dev(tokens), self._dev(valid))
        samp = self._samp_rows(self.slots)
        tl, tk = self._draw(self._penalised(row, self._pen_rows(samp)), samp)
        if self.penalties:
            # count only the samples the host will deliver: decode rows and
            # prefill completions (:1006-1013)
            emit = np.zeros((B,), np.int32)
            for s2, r2 in enumerate(self.slots):
                if r2 is not None and (r2.prefill_done
                                       or r2.prefill_cursor + int(valid[s2]) >= r2._resume):
                    emit[s2] = 1
            self._count(tl[:, 0], self._dev(emit))
        arr, tk = _Fetch(tl, tk).get()
        if self._timed:
            self.timing["mixed"] += time.perf_counter() - t0
        self._dispatch_seq += 1
        sampled, lps = self._unpack_tl(arr)
        self.stats["mixed_steps"] += 1
        self.stats["mixed_chunk_steps"] += int(C > 1)
        self.stats["prompt_tokens"] += int(sum(
            v for s2, v in enumerate(valid)
            if self.slots[s2] is not None and not self.slots[s2].prefill_done
        ))
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            lp = float(lps[slot])
            top = None if tk is None else self._top_list(tk[slot])
            if not req.prefill_done:
                old_cursor = req.prefill_cursor
                req.prefill_cursor += int(valid[slot])
                self._register_prompt_pages(slot, req, old_cursor)
                if req.prefill_done:
                    self._emit(req, int(sampled[slot]), lp, top)
            else:
                self._emit(req, int(sampled[slot]), lp, top)
            if req.done and self.slots[slot] is req:
                self._retire(slot)

    def _dispatch_window(self, ready: List[int], W: Optional[int] = None) -> Optional[dict]:
        """Dispatch a decode window for the ``ready`` slots and return the
        previously in-flight window (software pipelining): a slot decoding
        in both takes its input token from the previous window's output on
        the device, so nothing on this path waits for the card. Slots the
        following drain retires were still computing in the in-flight
        window; their writes land on their own or the trash pages and their
        tokens are discarded by the drain's valid/done guards."""
        t0 = time.perf_counter() if self._timed else 0.0
        B = self.max_slots
        W = self.decode_window if W is None else W
        valid = np.zeros((B,), np.int32)
        host_tok = np.zeros((B, 1), np.int64)
        for s in ready:
            valid[s] = 1
            host_tok[s, 0] = self.slots[s].output[-1]
        prev = self._inflight
        tok_in = self._dev(host_tok)
        if prev is not None:
            # rows decoding in BOTH windows chain on the device; rows newly
            # joining start from their host token
            cont = (prev["valid"] > 0) & (valid > 0)
            last_tok = prev["out"][:, -1, 0:1].to(torch.int64)
            tok_in = torch.where(self._dev(cont)[:, None], last_tok, tok_in)
        samp = self._samp_rows([r if valid[s] else None for s, r in enumerate(self.slots)])
        out, tk = self._window(tok_in, self._dev(valid), samp, W)
        self._dispatch_seq += 1
        self._inflight = {
            "out": out, "fetch": _Fetch(out, tk), "slots": list(self.slots),
            "valid": valid, "seq": self._dispatch_seq,
        }
        if self._timed:
            self.timing["window_dispatch"] += time.perf_counter() - t0
        self.stats["window_steps"] += 1
        self.stats["window_forwards"] += W
        self.stats["decode_slot_steps"] += int(valid.sum()) * W
        return prev

    def _flush_window(self) -> None:
        if self._inflight is not None:
            prev, self._inflight = self._inflight, None
            self._drain_window(prev)

    def _drain_window(self, inflight: dict) -> None:
        snapshot, valid = inflight["slots"], inflight["valid"]
        t0 = time.perf_counter() if self._timed else 0.0
        arr, tk = inflight["fetch"].get()  # ONE wait for W tokens per slot
        if self._timed:
            self._add_fetch("window_fetch", time.perf_counter() - t0, inflight["seq"])
        toks, lps = self._unpack_tl(arr)  # [B, W] each
        for slot, req in enumerate(snapshot):
            if req is None or not valid[slot] or req.done:
                continue  # idle/prefilling row, or retired in flight
            for j in range(toks.shape[1]):
                self._emit(
                    req, int(toks[slot, j]), float(lps[slot, j]),
                    None if tk is None else self._top_list(tk[slot, j]),
                )
                if req.done:
                    break  # the window's remaining tokens are junk
            if req.done and self.slots[slot] is req:
                self._retire(slot)

    # -- decoupled prefill --------------------------------------------------------
    def _prefill_substep(self, prefilling: List[int]) -> None:
        """Advance up to ``prefill_rows`` prefilling slots by one chunk
        through the gathered sub-batch; decoding slots never pay for it. The
        first token of rows that complete their prompt is fetched at a later
        drain point (``_pending``), overlapping the in-flight window."""
        t0 = time.perf_counter() if self._timed else 0.0
        P, C = self.prefill_rows, self.chunk
        rows = prefilling[:P]
        slot_ids = np.zeros((P,), np.int64)
        valid = np.zeros((P,), np.int32)
        tokens = np.zeros((P, C), np.int64)
        fin = []
        for i, s in enumerate(rows):
            r = self.slots[s]
            nxt = r.feed(r.prefill_cursor, min(r.prefill_cursor + C, r._resume))
            tokens[i, : len(nxt)] = nxt
            valid[i] = len(nxt)
            slot_ids[i] = s
            old_cursor = r.prefill_cursor
            r.prefill_cursor += len(nxt)
            self._register_prompt_pages(s, r, old_cursor)
            if r.prefill_done:
                fin.append((i, s, r))
        # padding rows need DISTINCT slot ids (merge scatters by id);
        # select() trashes their table rows, so any unused slot works
        pad_pool = [s for s in range(self.max_slots) if s not in rows]
        for i in range(len(rows), P):
            slot_ids[i] = pad_pool[i - len(rows)]
        self.stats["prefill_substeps"] += 1
        self.stats["prompt_tokens"] += int(valid.sum())
        ids, valid_d = self._dev(slot_ids), self._dev(valid)
        row_valid = valid_d > 0
        sub = self.cache.select(ids, row_valid)
        row, sub = self._forward_rows(sub, self._dev(tokens), valid_d)
        self.cache = self.cache.merge(sub, ids, row_valid)
        self._dispatch_seq += 1
        if fin:
            samp = self._samp_rows([self.slots[s] for s in rows] + [None] * (P - len(rows)))
            tl, tk = self._draw(self._penalised(row, self._pen_rows(samp), ids), samp)
            if self.penalties:  # the completion samples, delivered via pending
                emit = np.zeros((P,), np.int32)
                for i, _, _ in fin:
                    emit[i] = 1
                self._count(tl[:, 0], self._dev(emit), ids)
            self._pending.append((_Fetch(tl, tk), fin, self._dispatch_seq))
        if self._timed:
            self.timing["prefill_dispatch"] += time.perf_counter() - t0

    def _add_fetch(self, key: str, dt: float, seq: int) -> None:
        """Time blocked on a fetch; also under ``<key>_serial`` when nothing
        was dispatched after the fetched work."""
        self.timing[key] += dt
        if seq == self._dispatch_seq:
            self.timing[key + "_serial"] += dt

    def _drain_pending(self, pending=None) -> None:
        if pending is None:
            pending, self._pending = self._pending, []
        for fetch, fin, seq in pending:
            t0 = time.perf_counter() if self._timed else 0.0
            arr, tk = fetch.get()  # tiny [P, 2]; overlaps in-flight work
            if self._timed:
                self._add_fetch("pending_fetch", time.perf_counter() - t0, seq)
            toks, lps = self._unpack_tl(arr)
            for i, slot, req in fin:
                if req.done:
                    continue  # aborted while its first token was pending
                self._emit(
                    req, int(toks[i]), float(lps[i]),
                    None if tk is None else self._top_list(tk[i]),
                )
                if req.done and self.slots[slot] is req:
                    self._retire(slot)

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Step until all submitted work is finished; returns uid -> tokens."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine exceeded max_steps")
        return dict(self.finished)
