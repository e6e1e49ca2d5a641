"""Benchmark timing on the card.

Port of ``hydragen_tpu.utils.timing``: where the TPU needed a host readback
to fence a call, CUDA events on the current stream time the device work and
``torch.cuda.synchronize`` fences it.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch


def cuda_time_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of one ``fn()`` call over ``iters`` calls
    back to back, after ``warmup`` calls, timed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_time_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of one ``fn()`` call with no host work
    between calls: ``iters`` calls captured into one CUDA graph, the graph
    replayed once to warm it and once under CUDA events. ``cuda_time_ms``
    reads the host's pace instead where a call's host work outlasts its
    kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timed(fn: Callable, num_iters: int = 10, num_warmup: int = 3,
          between_fn: Optional[Callable] = None) -> Tuple[List[float], List[float]]:
    """Time ``fn`` -> (times, warmup_times) in seconds per call, each call
    measured by CUDA events around it and fenced by a synchronize;
    ``between_fn`` runs untimed between iterations."""

    def once():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    warmup_times = [once() for _ in range(num_warmup)]
    times = []
    for _ in range(num_iters):
        if between_fn is not None:
            between_fn()
            torch.cuda.synchronize()
        times.append(once())
    return times, warmup_times
