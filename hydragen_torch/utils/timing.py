"""Benchmark timing on the card.

Port of ``hydragen_tpu.utils.timing``: where the TPU needed a host readback
to fence a call, ``torch.cuda.synchronize`` fences it (``fence``); CUDA
events on the current stream time device work alone. ``timed_scanned``, a
TPU device loop, is not ported: ``cuda_time_ms``, ``cuda_graph_time_ms`` and
``time_flushed`` (a graph replay after an L2 flush, what the microbenchmarks
time) take its place. ``bound_ms`` is the least time the card could take for
a call's bytes and operations.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

from hydragen_torch.ops import cuda_lib

# One H100 SXM (NVIDIA's data sheet, dense rates): HBM bytes a second and
# peak operations a second by operand type, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    card's memory rate and ``ops`` over its peak rate for ``kind``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


def fence(device) -> None:
    """Wait for the work queued on ``device``: a synchronize on a CUDA
    device, nothing on the CPU (its ops return when done)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, num_iters: int = 10, num_warmup: int = 3,
          between_fn: Optional[Callable] = None,
          device="cuda") -> Tuple[List[float], List[float]]:
    """Time ``fn`` -> (times, warmup_times) in seconds per call: the host
    clock around each call, which ends with a ``fence`` of ``device``, so a
    call's time is its whole wall time, host work included (the JAX
    package's ``timed`` fences each call by a host readback).
    ``between_fn`` runs untimed between iterations."""

    def once():
        fence(device)
        t = time.perf_counter()
        fn()
        fence(device)
        return time.perf_counter() - t

    warmup_times = [once() for _ in range(num_warmup)]
    times = []
    for _ in range(num_iters):
        if between_fn is not None:
            between_fn()
        times.append(once())
    return times, warmup_times


def time_flushed(op, args, iters: int, device) -> list:
    """Seconds of each of ``iters`` calls of ``op(*args)``. On the card the
    op is captured once as a CUDA graph (after a warm-up call) and each
    replay follows a write of twice the L2 cache's bytes; CUDA events
    around the replay time the op's kernels alone, with no host work
    between them (a Hydragen call is a dozen small launches, whose host
    pace would otherwise be timed). Each replay adds the capture's kernel
    launches to ``cuda_lib.LAUNCHES``. On the CPU the host clock times each
    call."""
    device = torch.device(device)
    op(*args)
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            op(*args)
            times.append(time.perf_counter() - t)
        return times
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        op(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    graph, launches = torch.cuda.CUDAGraph(), {}
    with cuda_lib.captured_launches(launches), torch.cuda.graph(graph):
        op(*args)
    flush = torch.empty(2 * torch.cuda.get_device_properties(device).L2_cache_size,
                        dtype=torch.uint8, device=device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        graph.replay()
        end.record()
        cuda_lib.add_launches(launches)
    torch.cuda.synchronize(device)
    return [start.elapsed_time(end) / 1e3 for start, end in events]
