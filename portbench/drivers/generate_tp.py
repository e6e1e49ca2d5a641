"""The ``generate_tp`` driver: the ``generate`` driver's calls on a model
split over ``serving.tp`` cards by tensor parallelism, one process a rank
(``portbench/ranks.py``).

The harness's process is rank 0 on ``cuda:0`` (the one the tracer sees);
ranks 1 to tp-1 are its spawned followers on ``cuda:1`` onwards, joined
in one NCCL group (gloo where rank 0 runs on the CPU). Every rank builds
``HydragenLlama(config, RankParams(...), mesh=make_mesh(tp=...))`` over its
own slices of the seeded weights, drawn one tensor at a time and cut at
once, so no card holds the whole model. Before each call, the window's and
the traced run's extra ones alike, rank 0 sends every follower the call's
index and budget; each rank makes the same inputs from the seed and calls
the same ``generate``.

Traffic parameters: those of ``generate``; the configuration's
``serving.tp`` is the number of ranks. A row fails as in ``generate``, and
also where a follower's tokens of that row differ from rank 0's. The work
counted (``work()``) is rank 0's own: its query and kv heads, its MLP
channels and its slice of the vocabulary at the full hidden size.

Set-up ends with calls at the window's full shapes and budget until two in
a row take the same time within ``WARM_AGREE`` (at most ``WARM_CALLS``): on
four H100s the decode steps of every rank ran 3-8 % slower, at full clocks,
for some 45 s after the processes started, so a window begun sooner read
slow first calls. The device's peak is then reset,
so the result's ``memory_peak_bytes`` is the window's (each rank's set-up
peak, the weights' draw, goes to standard error). Every rank times each
call: its host wall, and on the card its prefill (the call's start to the
decode steps' start) and its decode steps; ``close()`` prints them by rank
for every call.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from portbench import port, ranks, yardstick
from portbench.drivers import generate

WARM_CALLS = 6  # the most full calls set-up makes
WARM_AGREE = 0.005  # set-up ends when two calls in a row agree this closely


def collective_bytes():
    """A copy of the program's bytes handed to each collective kind (None
    where the program does not count them)."""
    from hydragen_torch.parallel import mesh

    counted = getattr(mesh, "COLLECTIVE_BYTES", None)
    return None if counted is None else dict(counted)


class Driver(generate.Driver):
    def __init__(self, cell, seed: int, device, tracer=None, rank: int = 0):
        super().__init__(cell, seed, device, tracer)
        self.tp, self.rank = int(cell.config["serving"]["tp"]), rank
        self.group = None  # rank 0: the followers
        self.plan = None  # the rank's ShardPlan
        self.seq = 0  # rank 0: commands sent
        self.timed = range(0)  # the window's calls, by command number
        self.splits = []  # each call's (wall s, prefill ms, decode ms) on this rank
        self._mark = None  # the card's clock at the call's decode steps

    def build(self) -> None:
        """Every rank: the mesh, the rank's weights, its engine and caches."""
        from hydragen_torch import HydragenLlama
        from hydragen_torch.parallel import make_mesh

        cfg = self.cell.config
        mesh = make_mesh(tp=self.tp, device=self.device)
        params = ranks.rank_params(cfg, self.seed, self.device, mesh)
        self.plan = params.plan
        self.eng = HydragenLlama(port.model_config(cfg), params,
                                 quantization=cfg["serving"]["weights"], mesh=mesh)
        self.eng.setup_caches(self.b, self.t + self.n, [1], [self.P],
                              kv_quant=cfg["serving"]["kv_cache"])
        decode = self.eng._decode_steps

        def marked(*a, **kw):
            if self._mark is None and self.device.type == "cuda":
                self._mark = torch.cuda.Event(enable_timing=True)
                self._mark.record()
            return decode(*a, **kw)

        self.eng._decode_steps = marked
        where = str(self.device)
        if self.device.type == "cuda":
            p = torch.cuda.get_device_properties(self.device)
            where += f" (PCI bus {getattr(p, 'pci_bus_id', '?')}, {p.uuid})"
        print(f"portbench: rank {self.rank} on {where}, {len(os.sched_getaffinity(0))} CPUs "
              f"allowed", file=sys.stderr, flush=True)

    def generate(self, call: int, new: int) -> np.ndarray:
        """Every rank: one call (``generate``'s), timed into ``splits``."""
        cuda = self.device.type == "cuda"
        self._mark = None
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        t = time.perf_counter()
        if cuda:
            start.record()
        toks = super()._call(call, new)
        wall = time.perf_counter() - t
        if cuda and self._mark is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.splits.append((wall, start.elapsed_time(self._mark),
                                self._mark.elapsed_time(end)))
        else:
            self.splits.append((wall,))
        return toks

    def setup(self) -> None:
        """Rank 0: the followers and the group, this rank's engine, and
        calls at the window's shapes and budget on every rank until their
        time settles; then the device's peak is reset."""
        self.group = ranks.Group(self.tp, self.device, self.cell, self.seed)
        self.build()
        peaks = {0: torch.cuda.max_memory_allocated(self.device)
                 if self.device.type == "cuda" else 0, **self.group.setup_peaks()}
        self.records["setup_peak_bytes"] = peaks
        print("portbench: device peak at the end of set-up by rank: " + ", ".join(
            f"{r}: {b / 2**30:.2f} GiB" for r, b in peaks.items()), file=sys.stderr, flush=True)
        walls = []
        while len(walls) < WARM_CALLS and (
                len(walls) < 2 or abs(walls[-1] / walls[-2] - 1) > WARM_AGREE):
            t = time.perf_counter()
            self._call(-1, self.n)
            walls.append(time.perf_counter() - t)
        print("portbench: set-up's full calls took (s) " + ", ".join(
            f"{w:.3f}" for w in walls), file=sys.stderr, flush=True)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _call(self, call: int, new: int) -> np.ndarray:
        self.seq += 1
        self.group.send(("call", self.seq, call, new))
        traced = self.tracer is not None and self.tracer.active
        before = collective_bytes() if traced else None
        toks = self.generate(call, new)
        if before is not None:
            after = collective_bytes()
            self.records["collective_bytes"] = {k: after[k] - before[k] for k in after}
        return toks

    def run(self, seconds: float) -> None:
        first = self.seq + 1
        super().run(seconds)
        self.timed = range(first, first + len(self.tokens))

    def attempted_failed(self) -> tuple:
        """Completions (rows) attempted and failed: a row fails as in
        ``generate``, or where a follower got other tokens in it."""
        failed = 0
        for toks, seq in zip(self.tokens, self.timed):
            theirs = self.group.hashes(seq)
            if toks.shape != (self.b, self.n):
                failed += self.b
                continue
            bad = ((toks < 0) | (toks >= self.V)).any(axis=1)
            mine = ranks.row_hashes(toks)
            for hashes in theirs:
                bad |= np.array([a != b for a, b in zip(mine, hashes)]) \
                    if len(hashes) == len(mine) else True
            failed += int(bad.sum())
        return self.b * len(self.tokens), failed

    def work(self) -> dict:
        """The work of one call by phase, rank 0's share of it."""
        m, p = yardstick.Model(self.cell.config), self.plan
        m.nh, m.nkv = p.nh, p.nkv
        m.I //= self.tp if p.mlp else 1
        m.V //= self.tp if p.vocab else 1
        return yardstick.generate_work(m, self.P, self.b, self.t, self.n)

    def close(self) -> None:
        """Rank 0: its engine dropped, the followers stopped, the group
        destroyed and the device memory returned."""
        print("portbench: the window's calls took (s) " + ", ".join(
            f"{b - a:.3f}" for a, b in self.calls), file=sys.stderr, flush=True)
        theirs = self.group.splits if self.group is not None else {}
        for seq, mine in enumerate(self.splits, 1):
            label = ("set-up" if seq < self.timed.start else f"window {seq - self.timed.start}"
                     if seq in self.timed else "after the window")
            ranks_ = [mine] + [theirs.get((r, seq), ()) for r in range(1, self.tp)]
            print(f"portbench: call {seq} ({label}), by rank: wall s / prefill ms / decode ms: "
                  + "; ".join(f"{r}: " + " / ".join(f"{v:.3f}" for v in x)
                              for r, x in enumerate(ranks_)), file=sys.stderr, flush=True)
        self.eng = None
        port.free()
        if self.group is not None:
            if not self.group.close():
                print("portbench: the process group's teardown did not return",
                      file=sys.stderr, flush=True)
            self.group = None
        port.free()
        if self.device.type == "cuda":
            print(f"portbench: rank 0 holds {torch.cuda.memory_allocated(self.device) / 2**30:.2f}"
                  f" GiB after close", file=sys.stderr, flush=True)
