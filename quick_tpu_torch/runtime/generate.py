"""Generation: prefill, the decode loop, sampling and history penalties
(port of ``quick_tpu/runtime/generate.py``).

The JAX package runs the decode loop as one ``lax.scan``. Here each decode
step writes its token into a static buffer on the device and reads the
dense cache's length there, so on the card the loop runs its first step
eagerly and then replays that step captured as one CUDA graph
(``runtime/graphs.py``); the host never waits for the card inside the
loop. A step takes the eager loop instead where it cannot be captured: on
the CPU, for sampled (temperature > 0) decoding (its draws take a
``torch.Generator``), and where a layer attends over the dense cache with
the plain einsum route, which slices the cache by the host length.
History penalties (repetition / frequency / presence, ``apply_penalties``)
carry a [B, V] count of generated tokens through the steps, inside the
graph. ``sample_token_rows`` serves the continuous-batching engine, which
applies the same penalties under ``Engine(enable_penalties=True)``.
``beam_generate`` runs beam search over a [B x num_beams]-row dense cache;
on the card its search step (the beam reorder, a one-token forward,
log-softmax, top-k and the EOS mask) is captured and replayed as
``decode_loop``'s is.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.device import DeviceLike, to_device
from quick_tpu_torch.models.model import ModelParams, model_forward
from quick_tpu_torch.modules.blocks import dense_decode_route, top_k
from quick_tpu_torch.modules.cache import KVCache


class SamplingParams(NamedTuple):
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0            # 0 => disabled
    top_p: float = 1.0
    min_p: float = 0.0        # keep tokens with prob >= min_p * max_prob
    # history-dependent penalties (vLLM/OpenAI semantics), as in the JAX
    # package: applied by generate(), decode_loop() and the Engine (with
    # enable_penalties=True)
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0

    @property
    def has_penalties(self) -> bool:
        return (
            self.repetition_penalty != 1.0
            or self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
        )


def apply_penalties(
    logits: torch.Tensor,       # [B, V] raw logits
    out_counts: torch.Tensor,   # [B, V] int32 generated-token counts
    prompt_seen: torch.Tensor,  # [B, V] bool-ish: the token is in the prompt
    rep,                        # [B] or scalar, 1.0 => off
    freq,                       # [B] or scalar, 0.0 => off
    pres,                       # [B] or scalar, 0.0 => off
) -> torch.Tensor:
    """vLLM-semantics penalties (``apply_penalties`` :45), f32: a seen
    token's logit divided by ``rep`` when positive, multiplied when not;
    minus ``freq`` per generated occurrence and ``pres`` once if generated.
    Pass ``rep`` / ``freq`` / ``pres`` as tensors on the logits' device
    inside a captured step."""
    def col(v):
        return torch.as_tensor(v, dtype=torch.float32, device=logits.device).reshape(-1, 1)

    rep, freq, pres = col(rep), col(freq), col(pres)
    logits = logits.to(torch.float32)
    seen = (out_counts > 0) | (prompt_seen != 0)
    scaled = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, scaled, logits)
    logits = logits - out_counts.to(torch.float32) * freq
    return logits - (out_counts > 0).to(torch.float32) * pres


def filter_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature / top-k / top-p / min-p filtered logits; softmax of the
    result is the sampling distribution. Needs temperature > 0."""
    logits = logits / params.temperature
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e9), logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative prob exceeds top_p (top-1 kept)
        cutoff_idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e9), logits)
    if params.min_p > 0.0:
        thresh = logits.amax(dim=-1, keepdim=True) + math.log(params.min_p)
        logits = torch.where(logits < thresh, torch.full_like(logits, -1e9), logits)
    return logits


def sample_token(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy or filtered sampling. Returns [B] int64."""
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits.to(torch.float32), params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_token_rows(
    logits: torch.Tensor,  # [B, V]
    temps,                 # [B] f32 host array; 0 => greedy for that row
    top_ks,                # [B] int host array; 0 => disabled
    top_ps,                # [B] f32 host array; 1.0 => disabled
    generator: Optional[torch.Generator] = None,
    min_ps=None,           # [B] f32 host array; 0 => disabled
) -> torch.Tensor:
    """Per-row sampling for continuous batching (``sample_token_rows``
    :105): every slot carries its own temperature, top-k, top-p and min-p,
    and greedy and sampled rows mix in one batch. The sampling rows are host
    arrays, so whether any row samples is decided on the host (the JAX
    package decides it on the device with ``lax.cond``, :148): an all-greedy
    batch runs the argmax alone, and neither path waits for the card. The
    draw is an exponential race on the filtered distribution (no
    ``multinomial``), drawn from ``generator``. Returns [B] int64."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    if not (temps > 0).any():
        return greedy
    dev = logits.device
    V = logits.shape[-1]
    t = to_device(np.where(temps > 0, temps, 1.0).astype(np.float32), dev)
    k = to_device(np.clip(np.asarray(top_ks, np.int64), 0, V), dev)
    tp = to_device(np.asarray(top_ps, np.float32), dev)
    scaled = logits.to(torch.float32) / t[:, None]
    sl = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sl, 1, torch.clamp(k - 1, min=0)[:, None])
    kth = torch.where((k > 0)[:, None], kth, torch.full_like(kth, -math.inf))
    cum = torch.cumsum(torch.softmax(sl, dim=-1), dim=-1)
    # smallest prefix whose mass reaches top_p (top-1 always kept)
    cut = (cum < tp[:, None]).sum(dim=-1, keepdim=True)
    thresh = torch.maximum(kth, torch.gather(sl, 1, torch.clamp(cut, max=V - 1)))
    if min_ps is not None:
        mp = np.asarray(min_ps, np.float32)
        mth = sl[:, :1] + to_device(np.log(np.where(mp > 0, mp, 1.0)).astype(np.float32), dev)[:, None]
        on = to_device(mp > 0, dev)[:, None]
        thresh = torch.maximum(thresh, torch.where(on, mth, torch.full_like(mth, -math.inf)))
    masked = torch.where(scaled < thresh, torch.full_like(scaled, -1e9), scaled)
    race = torch.empty_like(masked).exponential_(generator=generator)
    drawn = torch.argmax(torch.softmax(masked, dim=-1) / race, dim=-1)
    return torch.where(to_device(temps == 0, dev), greedy, drawn)


def make_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> KVCache:
    """An empty dense cache for ``cfg`` on ``device`` (the card unless
    given "cpu"; raises without a card); for MLA models the latent cache
    (``make_mla_cache``, as ``make_cache`` :152-156)."""
    if cfg.is_mla:
        from quick_tpu_torch.modules.mla import make_mla_cache

        return make_mla_cache(cfg, batch, max_seq, dtype, device=device)
    return KVCache.create(
        cfg.num_hidden_layers, batch, max_seq, cfg.num_key_value_heads,
        cfg.head_dim, dtype, device=device,
    )


@torch.inference_mode()
def prefill(
    params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor, cache: KVCache
) -> Tuple[torch.Tensor, KVCache]:
    """Process the prompt; returns (last-position logits [B, V], cache)."""
    logits, cache = model_forward(params, cfg, tokens, cache, last_token_only=True)
    return logits[:, -1], cache


@torch.inference_mode()
def decode_step(
    params: ModelParams, cfg: ModelConfig, token: torch.Tensor, cache: KVCache
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: token [B] -> logits [B, V]."""
    logits, cache = model_forward(params, cfg, token[:, None], cache)
    return logits[:, -1], cache


def graphable(params: ModelParams, cfg: ModelConfig, cache: KVCache, sampling: SamplingParams) -> bool:
    """Whether ``decode_loop`` captures its step: a greedy loop over a dense
    cache on the card whose every layer reads the length on the device (K3,
    K7 or MLA's latent attention; not the einsum route)."""
    if not cache.k.is_cuda or sampling.temperature != 0.0:
        return False
    B = cache.k.shape[1]
    return cfg.is_mla or all(
        dense_decode_route(cfg, cache, B, params.rope_cos, i, cache.k.device) != "einsum"
        for i in range(len(params.blocks)))


@torch.inference_mode()
def decode_loop(
    params: ModelParams,
    cfg: ModelConfig,
    first_token: torch.Tensor,  # [B]
    cache: KVCache,
    n_tokens: int,
    sampling: SamplingParams = SamplingParams(),
    generator: Optional[torch.Generator] = None,
    prompt_seen: Optional[torch.Tensor] = None,  # [B, V] repetition-penalty mask
    _graph: Optional[bool] = None,  # None: capture where ``graphable``;
    # False: the eager loop (a measurement's or a test's comparison)
) -> Tuple[torch.Tensor, KVCache]:
    """Generate ``n_tokens`` autoregressively. With history penalties a
    [B, V] generated-token count rides along (``first_token`` counts as
    generated) and ``prompt_seen`` marks the prompt's tokens. Returns
    (tokens [B, n], cache)."""
    B = first_token.shape[0]
    dev = first_token.device
    out = torch.empty((B, n_tokens), dtype=torch.int64, device=dev)
    if n_tokens == 0:
        return out, cache
    rows = torch.arange(B, device=dev)
    token = first_token.to(torch.int64).clone()  # the step's static input
    pos = torch.zeros((1,), dtype=torch.int64, device=dev)  # next column of out
    pen = None
    if sampling.has_penalties:
        counts = torch.zeros((B, cfg.vocab_size), dtype=torch.int32, device=dev)
        counts.index_put_((rows, token), torch.ones(B, dtype=torch.int32, device=dev),
                          accumulate=True)
        if prompt_seen is None:
            prompt_seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev)
        coef = [torch.full((1,), v, dtype=torch.float32, device=dev) for v in (
            sampling.repetition_penalty, sampling.frequency_penalty, sampling.presence_penalty)]
        pen = (counts, prompt_seen, coef)

    # the n_tokens steps write one k/v row each: checked here, on the host,
    # since a replayed step cannot raise
    cache.check_room(n_tokens)
    # the loop's own device length, advanced in place
    cache = dataclasses.replace(cache, length_dev=cache.length_dev.clone())

    def step(cache):
        logits, nxt = decode_step(params, cfg, token, cache)
        cache.length_dev.copy_(nxt.length_dev)
        nxt = dataclasses.replace(nxt, length_dev=cache.length_dev)
        if pen is not None:
            logits = apply_penalties(logits, pen[0], pen[1], *pen[2])
        tok = sample_token(logits, sampling, generator)
        if pen is not None:
            pen[0].index_put_((rows, tok), torch.ones(B, dtype=torch.int32, device=dev),
                              accumulate=True)
        token.copy_(tok)
        out.index_copy_(1, pos, tok[:, None])
        pos.add_(1)
        return nxt

    use_graph = graphable(params, cfg, cache, sampling) if _graph is None else _graph
    cache = step(cache)  # eager: builds and allocates what a capture needs
    if use_graph and n_tokens > 1:
        from quick_tpu_torch.runtime.graphs import StepGraph

        graph = StepGraph(lambda: step(cache))  # its host length is dropped
        for _ in range(n_tokens - 1):
            graph.replay()
        # the replays moved length_dev; the host mirror follows
        cache = dataclasses.replace(cache, length=cache.length + n_tokens - 1)
    else:
        for _ in range(n_tokens - 1):
            cache = step(cache)
    return out, cache


@torch.inference_mode()
def generate(
    params: ModelParams,
    cfg: ModelConfig,
    prompt_tokens: torch.Tensor,  # [B, S]
    max_new_tokens: int,
    sampling: SamplingParams = SamplingParams(),
    max_seq: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    eos_token_id: Optional[int] = None,
    _graph: Optional[bool] = None,  # decode_loop's
) -> torch.Tensor:
    """Prefill + decode loop. Returns [B, S + max_new_tokens] tokens (prompt
    included); with ``eos_token_id``, tokens after the first EOS become EOS.
    History penalties mark the prompt's tokens as seen and apply to the
    first token too (:376-383)."""
    B, S = prompt_tokens.shape
    if max_seq is None:
        max_seq = S + max_new_tokens
    dev = params.embed.device
    prompt_tokens = prompt_tokens.to(dev)
    cache = make_cache(cfg, B, max_seq, device=dev)
    logits, cache = prefill(params, cfg, prompt_tokens, cache)
    prompt_seen = None
    if sampling.has_penalties:
        prompt_seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev).scatter_(
            1, prompt_tokens.to(torch.int64), True)
        logits = apply_penalties(
            logits, torch.zeros(prompt_seen.shape, dtype=torch.int32, device=dev), prompt_seen,
            sampling.repetition_penalty, sampling.frequency_penalty, sampling.presence_penalty)
    first = sample_token(logits, sampling, generator)
    rest, cache = decode_loop(
        params, cfg, first, cache, max_new_tokens - 1, sampling, generator,
        prompt_seen=prompt_seen, _graph=_graph,
    )
    out = torch.cat([prompt_tokens.to(torch.int64), first[:, None], rest], dim=1)
    if eos_token_id is not None:
        gen = out[:, S:]
        is_eos = (gen == eos_token_id).to(torch.int32)
        hit = torch.cumsum(is_eos, dim=1) - is_eos > 0
        gen = torch.where(hit, torch.full_like(gen, eos_token_id), gen)
        out = torch.cat([out[:, :S], gen], dim=1)
    return out


@torch.inference_mode()
def beam_generate(
    params: ModelParams,
    cfg: ModelConfig,
    prompt_tokens: torch.Tensor,  # [B, S]
    max_new_tokens: int,
    num_beams: int = 4,
    length_penalty: float = 1.0,
    eos_token_id: Optional[int] = None,
    max_seq: Optional[int] = None,
    _graph: Optional[bool] = None,  # None: capture where ``graphable``;
    # False: the eager search (a measurement's or a test's comparison)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search (``beam_generate`` :245-346). The prompts are tiled to
    B x num_beams rows, one prefill each; only beam 0 is live at the first
    step. Each step ranks the [B, num_beams x V] cumulative candidates in
    ``lax.top_k``'s order (``blocks.top_k``), reorders the beams' cache rows,
    histories and lengths by a batch-axis gather (``KVCache.take_rows``),
    and runs one token per row. A beam that emitted ``eos_token_id`` only
    extends with EOS at cost 0 and stops growing. Returns (tokens [B, S +
    max_new_tokens] int64, scores [B] f32): per batch row the beam with the
    best ``score / max(length, 1) ** length_penalty``, and its summed
    logprob.

    On the card the step is captured once (after an eager first step) and
    replayed, where every layer reads the cache length on the device
    (``graphable``); a layer on the plain einsum route keeps the search
    eager, with a warning."""
    B, S = prompt_tokens.shape
    nb, V, n = num_beams, cfg.vocab_size, max_new_tokens
    R = B * nb
    if max_seq is None:
        max_seq = S + n
    dev = params.embed.device
    prompt_tokens = prompt_tokens.to(dev)
    cache = make_cache(cfg, R, max_seq, device=dev)
    logits, cache = prefill(params, cfg, prompt_tokens.repeat_interleave(nb, dim=0), cache)
    # the search's static state, advanced in place by each step
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)  # [R, V]
    scores = torch.where(torch.arange(R, device=dev) % nb == 0, 0.0, -1e9).to(torch.float32)
    hist = torch.zeros((R, n), dtype=torch.int64, device=dev)
    lens = torch.zeros((R,), dtype=torch.int32, device=dev)
    pos = torch.zeros((1,), dtype=torch.int64, device=dev)  # the step's column of hist
    base = (torch.arange(B, device=dev) * nb)[:, None]
    eos_row = None
    if eos_token_id is not None:
        eos_row = torch.full((V,), -1e9, dtype=torch.float32, device=dev)
        eos_row[eos_token_id] = 0.0
    cache.check_room(n)  # a replayed step cannot raise
    cache = dataclasses.replace(cache, length_dev=cache.length_dev.clone())

    def step(cache):
        cand = (scores[:, None] + logp).reshape(B, nb * V)
        top, idx = top_k(cand, nb)  # [B, nb]
        src = (base + idx // V).reshape(-1)
        tok = (idx % V).reshape(-1)
        cache.take_rows(src)
        hist.copy_(hist.index_select(0, src))
        lens.copy_(lens.index_select(0, src))
        scores.copy_(top.reshape(-1))
        hist.index_copy_(1, pos, tok[:, None])
        logits, nxt = decode_step(params, cfg, tok, cache)
        cache.length_dev.copy_(nxt.length_dev)
        nxt = dataclasses.replace(nxt, length_dev=cache.length_dev)
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        if eos_row is None:
            lens.add_(1)
        else:
            frozen = tok == eos_token_id
            lp = torch.where(frozen[:, None], eos_row[None, :], lp)
            lens.add_((~frozen).to(torch.int32))
        logp.copy_(lp)
        pos.add_(1)
        return nxt

    if n > 0:
        use_graph = graphable(params, cfg, cache, SamplingParams()) if _graph is None else _graph
        if _graph is None and cache.k.is_cuda and not use_graph:
            warnings.warn("beam_generate: a layer attends through the einsum route; the "
                          "search runs eager")
        cache = step(cache)  # eager: builds and allocates what a capture needs
        if use_graph and n > 1:
            from quick_tpu_torch.runtime.graphs import StepGraph

            graph = StepGraph(lambda: step(cache))
            for _ in range(n - 1):
                graph.replay()
        else:
            for _ in range(n - 1):
                cache = step(cache)
    ranked = scores / torch.clamp(lens, min=1).to(torch.float32) ** length_penalty
    best = torch.argmax(ranked.reshape(B, nb), dim=1)
    rows = torch.arange(B, device=dev) * nb + best
    out = torch.cat([prompt_tokens.to(torch.int64), hist[rows]], dim=1)
    return out, scores.reshape(B, nb)[torch.arange(B, device=dev), best]
