"""Process meshes over ``torch.distributed``: one process a rank.

Port of ``hydragen_tpu.parallel.mesh``. JAX runs one program over a mesh of
devices and its partitioner inserts the collectives; here every rank is its
own process (as in gpt-fast and the reference's ``tp.py``), holds only its
shards, and the collectives are explicit calls of this module, made at the
points where the JAX program has them.

Axes, in the JAX order ``reshape(dp, sp, tp)`` with tp minor:
- ``dp``: unique rows over ranks; the forward pass needs no collective;
- ``sp``: the shared levels' sequence over ranks; the level reads' partials
  merge by the exact LSE math (two all-reduces a level read);
- ``tp``: heads and MLP channels over ranks; two all-reduces a layer (after
  the row-parallel o and down projections) and one all-gather of the
  vocab-sharded logits.

The backend is NCCL for CUDA tensors on distinct cards and gloo on the CPU,
or when ranks share one card (NCCL refuses two ranks on one device). Gloo
collectives on CUDA tensors are staged through host memory here; only the
collective is staged, never a kernel's input. Every collective goes through
a counted wrapper (``COLLECTIVES``, and the bytes it is handed in
``COLLECTIVE_BYTES``), as ``ops/cuda_lib.LAUNCHES`` counts kernel launches,
and a CUDA graph's capture records its counts for each replay in the same
way. While a profiler records, each wrapper is a host range
``hg.all_reduce`` or ``hg.all_gather`` (``utils/profiling.span``).

``launch(fn, world, ...)`` spawns ``fn(rank, world, *args)`` in ``world``
processes (the spawn start method) with a time limit on the group's set-up
and on the join; ``torchrun`` works as well, with ``make_mesh`` called
after ``init_process_group``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from hydragen_torch.utils.profiling import span

AXES = ("dp", "sp", "tp")

# Calls of each counted collective. The tests and ``chip_smoke.py`` hold
# them exactly, as they hold kernel launches.
COLLECTIVES: dict[str, int] = {"all_reduce_sum": 0, "all_reduce_max": 0, "all_gather": 0}
# Bytes this rank hands to each counted collective: the tensor it reduces
# (a low-precision sum in its f32 copy), or the piece it contributes to a
# gather.
COLLECTIVE_BYTES: dict[str, int] = dict.fromkeys(COLLECTIVES, 0)


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0
        COLLECTIVE_BYTES[name] = 0


def _count(name: str, x: torch.Tensor) -> None:
    COLLECTIVES[name] += 1
    COLLECTIVE_BYTES[name] += x.numel() * x.element_size()


@contextlib.contextmanager
def captured_collectives(into: dict, nbytes: dict):
    """Within the block (a CUDA graph's capture), the counts go to ``into``
    and the bytes to ``nbytes``, and COLLECTIVES and COLLECTIVE_BYTES are
    left as they were; ``add_collectives(into, nbytes)`` counts one
    replay."""
    before = dict(COLLECTIVES), dict(COLLECTIVE_BYTES)
    try:
        yield into
    finally:
        for counter, was, sink in ((COLLECTIVES, before[0], into),
                                   (COLLECTIVE_BYTES, before[1], nbytes)):
            for name, n in counter.items():
                if n != was[name]:
                    sink[name] = n - was[name]
            counter.update(was)


def add_collectives(counts: dict, nbytes: dict) -> None:
    for name, n in counts.items():
        COLLECTIVES[name] += n
    for name, n in nbytes.items():
        COLLECTIVE_BYTES[name] += n


# Host seconds spent inside the counted collectives (host staging, the
# transfer, the wait for the other ranks), summed while ``timed_collectives``
# is on. Each timed call synchronizes the card before and after itself, so
# the time of the kernels queued before it is not counted; off, nothing is
# synchronized or read. Collectives inside a graph's replays are not host
# calls and are not timed.
COLLECTIVE_SECONDS = [0.0]
_TIMED = [False]


@contextlib.contextmanager
def timed_collectives():
    _TIMED[0] = True
    try:
        yield COLLECTIVE_SECONDS
    finally:
        _TIMED[0] = False


@contextlib.contextmanager
def _clock(x: torch.Tensor):
    # A capture records the collective for its replays: nothing to time, and
    # a synchronize would break the capture.
    if not _TIMED[0] or (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        yield
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t = time.perf_counter()
    yield
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    COLLECTIVE_SECONDS[0] += time.perf_counter() - t


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``(dp, sp, tp)`` mesh: its coordinates, one
    process group per axis and its device.

    An axis is *active* when it has more than one rank, or when the mesh
    was made with ``keep_trivial``: then every axis issues its collectives
    even over one rank (a one-rank mesh that still runs the collective
    path, as the card check's one-rank NCCL mesh does)."""

    tp: int
    dp: int
    sp: int
    rank: int
    coords: dict
    groups: dict
    device: torch.device
    backend: str
    keep_trivial: bool = False

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def active(self, axis: str) -> bool:
        return self.size(axis) > 1 or self.keep_trivial

    @property
    def graphs_ok(self) -> bool:
        """NCCL collectives can be captured in a CUDA graph; gloo's, staged
        through the host, cannot."""
        return self.backend == "nccl"


def default_device(rank: int) -> torch.device:
    """The card of this rank (``LOCAL_RANK`` under torchrun, else the rank
    modulo the card count); raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a CPU mesh")
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, device=None,
              keep_trivial: bool = False) -> Mesh:
    """The ``(dp, sp, tp)`` mesh over the initialised default process group
    (whose world size must be ``tp * dp * sp``). Every rank must call it, in
    the same order as any other group it makes: each axis group is made with
    ``new_group`` on every rank. ``device`` None is this rank's card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed.init_process_group first "
                           "(or run under parallel.launch / torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != tp * dp * sp:
        raise ValueError(f"make_mesh: world size {world} != dp*sp*tp = {dp}*{sp}*{tp}")
    grid = np.arange(world).reshape(dp, sp, tp)
    at = np.argwhere(grid == rank)[0]
    coords = dict(zip(AXES, (int(i) for i in at)))
    groups = {}
    for ax_i, axis in enumerate(AXES):
        if grid.shape[ax_i] == 1 and not keep_trivial:
            continue
        lines = np.moveaxis(grid, ax_i, -1).reshape(-1, grid.shape[ax_i])
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    dev = default_device(rank) if device is None else torch.device(device)
    return Mesh(tp=tp, dp=dp, sp=sp, rank=rank, coords=coords, groups=groups,
                device=dev, backend=dist.get_backend(), keep_trivial=keep_trivial)


# ---------------------------------------------------------------------------
# Counted collectives
# ---------------------------------------------------------------------------


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def all_reduce(x: torch.Tensor, op: str, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``x`` over the ranks of ``axis``, as a
    new tensor of ``x``'s dtype. A low-precision sum is taken in f32 and
    rounded once, so two ranks give the correctly rounded sum whatever the
    backend's reduction order."""
    if not mesh.active(axis):
        return x
    with span("all_reduce"):
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        wide = op == "sum" and x.dtype in (torch.bfloat16, torch.float16)
        y = x.float() if wide else x.clone()
        _count(f"all_reduce_{op}", y)
        with _clock(y):
            if _staged(mesh, y):
                h = y.cpu()
                dist.all_reduce(h, op=red, group=mesh.groups[axis])
                y.copy_(h)
            else:
                dist.all_reduce(y, op=red, group=mesh.groups[axis])
        return y.to(x.dtype) if wide else y


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along ``dim``
    in rank order of ``axis``."""
    if not mesh.active(axis):
        return x
    with span("all_gather"):
        src = x.contiguous()
        _count("all_gather", src)
        staged = _staged(mesh, src)
        with _clock(src):
            if staged:
                src = src.cpu()
            parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
            dist.all_gather(parts, src, group=mesh.groups[axis])
            out = torch.cat(parts, dim=dim)
            if staged:
                out = out.to(x.device)
        return out


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(obj):
    """Tensors in a worker's result -> numpy (a queue then carries plain
    pickles, with no shared-memory handles outliving the worker)."""
    if torch.is_tensor(obj):
        t = obj.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if hasattr(obj, "_fields"):  # a named tuple (a quantized weight)
        return type(obj)(*(_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _worker(fn, rank, world, port, backend, init_timeout, results, args):
    # The result or the traceback reaches the parent's pipe before the group
    # is torn down (the queue's feeder thread flushed): destroy_process_group
    # may not return, with a peer stuck in a collective or over NCCL
    # communicators that captured graphs used, and the parent stops a rank
    # whose result it holds.
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=init_timeout))
        results.put((rank, True, _host(fn(rank, world, *args))))
    except BaseException:  # the parent raises with this rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        results.close()
        results.join_thread()
        if dist.is_initialized():
            dist.destroy_process_group()


TEARDOWN_S = 30.0  # seconds the ranks of a finished launch get to exit


def launch(fn: Callable, world: int, *args, backend: str = "gloo",
           timeout: float = 300.0, init_timeout: float = 60.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes over a
    fresh default group (``tcp://localhost``, a free port), and return the
    ranks' results in rank order (tensors as numpy arrays). ``fn`` must be
    importable by name (a module-level function). A rank that raises, a
    group that does not form within ``init_timeout`` seconds, or a run
    longer than ``timeout`` seconds fails the call: every process is then
    stopped and this raises. A rank still tearing its group down
    ``TEARDOWN_S`` seconds after the last result is stopped."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world, port, backend, init_timeout, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: dict = {}
    error = None
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                error = f"timed out after {timeout:.0f} s with ranks {sorted(got)} done"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)
                    if results.empty():
                        error = f"a rank exited with code {dead[0]} and no result"
                        break
                continue
            if not ok:
                error = f"rank {rank} raised:\n{out}"
                break
            got[rank] = out
        # With every result in, a rank gets TEARDOWN_S to leave (1 s after
        # an error); then it is stopped.
        end = time.monotonic() + (TEARDOWN_S if error is None else 1.0)
        for p in procs:
            p.join(timeout=max(0.1, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
    if error is not None:
        raise RuntimeError(f"parallel.launch({getattr(fn, '__name__', fn)}, world={world}): "
                           f"{error}")
    return [got[r] for r in range(world)]
