"""One decode step captured as a CUDA graph: the port's counterpart of the
JAX package's one XLA program per decode loop (``decode_loop``'s
``lax.scan``, the Engine's jitted window).

A step function reads and writes static tensors only (the token buffer,
the device lengths, the caches, written in place), so replaying its graph
runs the next step. The kernels' launch counts are host counters that a
replay does not touch: ``StepGraph`` records each kernel's launches made
while capturing (capture runs nothing on the card, so they are taken back
off) and adds them on every replay, so a run's counts are those of the
launches that ran.
"""
from __future__ import annotations

import collections
from typing import Callable

import torch


class StepGraph:
    """Capture ``step()`` once; ``replay()`` runs it again. ``out`` is what
    ``step`` returned while capturing (tensors the graph writes). Capture
    needs the kernels built and every lazily made buffer made, so the
    caller runs ``step`` eagerly first."""

    def __init__(self, step: Callable):
        from quick_tpu_torch.ops import all_kernels

        self.kernels = all_kernels()
        before = [(k.launches, collections.Counter(k.launches_by_key)) for k in self.kernels]
        self.graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)  # the capture's own synchronize is set-up
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="relaxed"):
                self.out = step()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        self.launches = []  # (kernel, launches per replay by key)
        for k, (n, by_key) in zip(self.kernels, before):
            delta = k.launches_by_key - by_key
            k.launches = n
            k.launches_by_key.clear()
            k.launches_by_key.update(by_key)
            if delta:
                self.launches.append((k, delta))

    def replay(self) -> None:
        self.graph.replay()
        for k, delta in self.launches:
            k.launches += sum(delta.values())
            k.launches_by_key.update(delta)
