"""A cell whose model is split over several cards by tensor parallelism: one
process a rank, the harness's own process rank 0.

The harness runs and profiles one process on ``cuda:0``. That process is
rank 0; ``Group`` spawns ranks 1 to tp-1 as its followers, on ``cuda:1``
onwards (or on the CPU, over gloo, where rank 0 runs on the CPU), and joins
them in one process group. A follower (``follow``) builds what its driver
builds, then waits for rank 0's commands: each command is one call, which
every rank makes with the same inputs, and the follower answers with a
hash of each row it got back. Any rank that raises ends the run: a
follower prints its traceback and exits, and rank 0's watchdog then stops
every process and exits nonzero; a follower whose rank 0 is gone exits too.

``drawn`` gives the seeded weights of ``cell.make_weights`` one tensor at a
time, in its order and from its generator stream, and ``rank_params`` cuts
each at once to this rank's slice with the program's own rule
(``hydragen_torch.parallel.sharding.shard_leaf`` under ``param_pspecs``):
a rank holds what ``shard_params`` would give it, and no card ever holds
the whole model. Nothing here imports the program at module level.
"""

from __future__ import annotations

import atexit
import datetime
import hashlib
import math
import os
import queue as queue_mod
import sys
import threading
import time
import traceback

import numpy as np
import torch

from portbench.cell import stream_seed

INIT_TIMEOUT_S = 600.0  # the group's forming, and the longest collective
STOP_S = 30.0  # a follower's time to leave after ``stop``
POLL_S = 0.2


def drawn(config: dict, seed: int, device):
    """``(key, value)`` of ``cell.make_weights(config, seed, device)``, one
    at a time and equal to it: the same draws, in the same order, from the
    same generator. A projection's value is its ``(int8 payload, f32
    scale)`` pair."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "weights"))
    H, I = int(config["hidden_size"]), int(config["intermediate_size"])
    L, V = int(config["num_hidden_layers"]), int(config["vocab_size"])
    nh, nkv = int(config["num_attention_heads"]), int(config["num_key_value_heads"])
    hd = H // nh

    def int8(shape, K):
        q = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
        s = torch.rand(shape[:-1], generator=g, device=device, dtype=torch.float32)
        return q, (s * 0.5 + 0.75) / (73.6 * math.sqrt(K))

    def norm(shape):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return (1.0 + 0.1 * x).to(torch.bfloat16)

    yield "embed", torch.randn((V, H), generator=g, device=device, dtype=torch.float32).to(
        torch.bfloat16)
    yield "input_norm", norm((L, H))
    yield "post_attn_norm", norm((L, H))
    yield "final_norm", norm((H,))
    yield "lm_head", int8((V, H), H)
    for fam, N, K in (("wq", nh * hd, H), ("wk", nkv * hd, H), ("wv", nkv * hd, H),
                      ("wo", H, nh * hd), ("gate", I, H), ("up", I, H), ("down", H, I)):
        yield fam, int8((L, N, K), K)


def rank_params(config: dict, seed: int, device, mesh):
    """This rank's slices of the seeded weights as the program's
    ``RankParams``, each tensor cut as soon as it is drawn and the rest
    freed."""
    from hydragen_torch.ops.quant import QuantizedTensor
    from hydragen_torch.parallel.sharding import (
        RankParams,
        param_pspecs,
        shard_leaf,
        shard_plan,
    )

    from portbench import port

    cfg = port.model_config(config)
    plan, specs = shard_plan(cfg, mesh), param_pspecs(cfg, mesh)
    names = {"embed": "embed_tokens", "final_norm": "final_norm", "lm_head": "lm_head"}
    tree: dict = {"layers": {}}
    for key, value in drawn(config, seed, device):
        if isinstance(value, tuple):
            value = QuantizedTensor(q=value[0], scale=value[1])
        if key in names:
            tree[names[key]] = shard_leaf(value, specs[names[key]], plan.tp, plan.rank)
        else:
            tree["layers"][key] = shard_leaf(value, specs["layers"][key], plan.tp, plan.rank)
        del value
    return RankParams(tree, plan)


def row_hashes(tokens: np.ndarray) -> list:
    """A digest of each row of a call's tokens."""
    return [hashlib.blake2b(np.ascontiguousarray(r).tobytes(), digest_size=8).digest()
            for r in tokens]


def _join(world: int, rank: int, port: int, device: torch.device) -> None:
    import torch.distributed as dist

    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def _destroy(within: float) -> bool:
    """Destroy the default process group, waiting at most ``within`` seconds
    (with NCCL communicators that captured graphs used it may not return);
    whether it returned."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return True
    t = threading.Thread(target=dist.destroy_process_group, daemon=True)
    t.start()
    t.join(within)
    return not t.is_alive()


class Group:
    """Rank 0's side: the followers, their command queues and replies, and
    a watchdog that ends the run when a follower fails."""

    def __init__(self, world: int, device, cell, seed: int):
        import torch.multiprocessing as mp

        from hydragen_torch.parallel.mesh import _free_port

        ctx = mp.get_context("spawn")
        port = _free_port()
        self.world, self.replies = world, ctx.Queue()
        self.cmds = [ctx.Queue() for _ in range(1, world)]
        self.procs = [ctx.Process(target=follow, daemon=True, args=(
            r, world, port, cell, seed, str(device), torch.get_num_threads(), self.cmds[r - 1],
            self.replies, os.getpid())) for r in range(1, world)]
        self.stopping = False
        self.got: dict = {}  # (rank, seq) -> row hashes
        self.splits: dict = {}  # (rank, seq) -> the follower's timing of the call
        self.ready: dict = {}  # rank -> its set-up's device peak bytes
        for p in self.procs:
            p.start()
        threading.Thread(target=self._watch, daemon=True).start()
        atexit.register(self._at_exit)
        _join(world, 0, port, torch.device(device))

    def _watch(self) -> None:
        while not self.stopping:
            dead = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                    if p.exitcode is not None]
            if dead and not self.stopping:
                print(f"portbench: rank {dead[0][0]} exited with code {dead[0][1]}; "
                      f"stopping every rank", file=sys.stderr, flush=True)
                self._kill()
                os._exit(1)
            time.sleep(POLL_S)

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()

    def _at_exit(self) -> None:
        # Rank 0 left without ``close()`` (it raised): the followers are
        # stopped, and the exit does not wait on the group's teardown.
        if not self.stopping:
            self.stopping = True
            self._kill()
            sys.stderr.flush()
            os._exit(1)

    def send(self, cmd: tuple) -> None:
        for q in self.cmds:
            q.put(cmd)

    def _read(self, timeout: float) -> bool:
        try:
            kind, rank, *rest = self.replies.get(timeout=timeout)
        except queue_mod.Empty:
            return False
        if kind == "ready":
            self.ready[rank] = rest[0]
        else:
            self.got[(rank, rest[0])] = rest[1]
            self.splits[(rank, rest[0])] = rest[2]
        return True

    def hashes(self, seq: int, timeout: float = 600.0) -> list:
        """Each follower's row hashes of call ``seq``, in rank order."""
        want = [(r, seq) for r in range(1, self.world)]
        deadline = time.monotonic() + timeout
        while not all(k in self.got for k in want):
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"portbench: no tokens of call {seq} from ranks "
                                   f"{[r for r, _ in want if (r, seq) not in self.got]}")
            self._read(min(left, 1.0))
        return [self.got[k] for k in want]

    def setup_peaks(self, timeout: float = 600.0) -> dict:
        """Each follower's device peak at the end of its set-up, in bytes."""
        deadline = time.monotonic() + timeout
        while len(self.ready) < self.world - 1 and time.monotonic() < deadline:
            self._read(1.0)
        return dict(sorted(self.ready.items()))

    def close(self) -> bool:
        """Stop the followers and destroy the group; whether the group's
        teardown returned."""
        self.stopping = True
        self.send(("stop",))
        end = time.monotonic() + STOP_S
        for p in self.procs:
            p.join(max(0.1, end - time.monotonic()))
        self._kill()
        atexit.unregister(self._at_exit)
        return _destroy(STOP_S)


def follow(rank: int, world: int, port: int, cell, seed: int, device: str, threads: int,
           cmds, replies, parent: int) -> None:
    """A follower's life: join the group, build the rank's engine through
    the cell's own driver (``driver.build()``), answer ``("ready", rank,
    peak)``, then run each ``("call", seq, call, new)`` and answer
    ``("tokens", rank, seq, row hashes, timing)`` until ``("stop",)``. On any error,
    the traceback to standard error and exit 1; without rank 0, exit 1."""

    def orphaned():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    try:
        from portbench import run

        torch.set_num_threads(threads)
        dev = torch.device(device)  # rank 0's: card ``rank`` where it is a card
        if dev.type == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
        _join(world, rank, port, dev)
        drv = run.driver_for(cell)(cell, seed, dev, rank=rank)
        drv.build()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        replies.put(("ready", rank, peak))
        while True:
            cmd = cmds.get()
            if cmd[0] == "stop":
                break
            _, seq, call, new = cmd
            toks = drv.generate(call, new)
            replies.put(("tokens", rank, seq, row_hashes(toks), drv.splits[-1]))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    replies.close()
    replies.join_thread()
    sys.stderr.flush()
    os._exit(0)
