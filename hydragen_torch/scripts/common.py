"""What the scripts share: the device, the attention impl's names, and
ranks for ``--tp`` / ``--dp``.

The JAX scripts shard one process in place (``engine.shard(make_mesh(...))``);
here every rank is a process (``parallel.launch``), which builds its engine
over the mesh and runs the script's body with the same arguments. Rank 0
alone prints and writes results; the others' standard output is dropped.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import subprocess

import torch

from hydragen_torch.parallel import launch, make_mesh

# The JAX scripts' --impl names onto the port's (ops/hydragen.py:IMPLS):
# Pallas and the automatic choice are the hand-written kernels, XLA the
# plain PyTorch ops.
IMPLS = {"kernel": "kernel", "torch": "torch", "auto": "kernel", "pallas": "kernel",
         "xla": "torch"}
IMPL_HELP = ("attention impl: kernel (the hand-written CUDA kernels; the JAX scripts' "
             "auto and pallas map to it) or torch (the plain PyTorch ops; xla maps to it); "
             "default: the engine's, kernel")
# A run over ranks may take RANK_SETUP_S (a checkpoint read and quantized on
# every rank, the kernels built) and RANK_POINT_S for each point of its sweep;
# past that, ``launch`` stops the ranks as hung (a rank stuck in a collective
# or at teardown would otherwise hold the cards without end).
RANK_SETUP_S = 3600.0
RANK_POINT_S = 900.0


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu: without a card the script exits "
                        "unless given --device cpu")


def device_of(args, prog: str) -> torch.device:
    """The run's device; with no card for a CUDA run, exit with one line."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device is available; pass --device cpu to run "
                         "on the CPU")
    return dev


def card_name(device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives it (its power limit sets its speed), or
    ``"cpu"``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    return out[index] if index < len(out) else torch.cuda.get_device_name(device)


def impl_of(name):
    return None if name is None else IMPLS[name]


def generator(device) -> torch.Generator:
    """The scripts' random weights and inputs: seed 0 on ``device``."""
    return torch.Generator(device=device).manual_seed(0)


def over_ranks(fn, world: int, device: torch.device, *args, points: int = 1) -> list:
    """``fn(rank, world, *args)`` in ``world`` processes; their results in
    rank order. NCCL where each rank has a card of its own, else gloo (the
    CPU, or ranks sharing a card: NCCL refuses two ranks on one device).
    ``points`` is the size of the run's sweep, which sets its time limit."""
    nccl = device.type == "cuda" and torch.cuda.device_count() >= world
    return launch(fn, world, *args, backend="nccl" if nccl else "gloo",
                  timeout=RANK_SETUP_S + RANK_POINT_S * max(points, 1))


def rank_mesh(args, tp: int, dp: int = 1):
    """This rank's mesh: on the CPU for ``--device cpu``, else its card."""
    return make_mesh(tp=tp, dp=dp, device="cpu" if args.device == "cpu" else None)


@contextlib.contextmanager
def rank_output(rank: int):
    """Rank 0 prints; another rank's standard output goes nowhere."""
    if rank == 0:
        yield
    else:
        with contextlib.redirect_stdout(io.StringIO()):
            yield
