"""The yardstick of the collectives between the cards of a tensor-parallel
cell: the link's peak, the bytes a call's all-reduces need, the least time
they can take, and the names of NCCL's kernels. Frozen here, with the
readers, as ``yardstick.py`` keeps the kernels'. Nothing here imports the
program."""

from __future__ import annotations

from portbench import yardstick

# One direction of an H100 SXM's NVLink 4: 18 links of 25 GB/s each way
# (NVIDIA's data sheet: 900 GB/s both ways together).
NVLINK_BYTES_PER_S = 450e9
WIDTH = {"bfloat16": 2, "float16": 2, "float32": 4}


def allreduce_bytes(config: dict, shared: int, rows: int, suffix: int, new: int) -> float:
    """The bytes of the partials one rank's sum all-reduces need in one
    ``generate`` call, counted from the shapes: two a layer (after the o and
    the down projection), each a ``[tokens, hidden]`` partial in the
    configuration's compute precision, over the prompt's tokens, the rows'
    suffix tokens (without bucket padding) and the rows of the ``new - 1``
    decode steps. What the program hands NCCL (its own ``COLLECTIVE_BYTES``:
    an f32 copy, padded rows) is not the yardstick."""
    tokens = shared + rows * suffix + rows * (new - 1)
    width = WIDTH[config["serving"]["compute_dtype"]]
    return 2.0 * int(config["num_hidden_layers"]) * tokens * int(config["hidden_size"]) * width


def allreduce_floor_s(nbytes: float) -> float:
    """The least seconds an all-reduce of ``nbytes`` (one rank's whole
    partial) takes: the rank sends its partial once and receives the sum
    once, at the same time, each way at the link's one-way peak. An
    in-switch reduction (NVLink SHARP) moves that; no algorithm moves less,
    and a ring moves 2 (n - 1) / n times as much each way."""
    return nbytes / NVLINK_BYTES_PER_S


def is_nccl(name: str) -> bool:
    """A kernel of NCCL's (``ncclDevKernel_...``, ``ncclKernel_...``), not
    the card's side of the process group's own range (``nccl:all_reduce``)."""
    return yardstick.fold_name(name).startswith(("ncclDevKernel", "ncclKernel"))


def is_all_reduce(name: str) -> bool:
    return is_nccl(name) and "AllReduce" in name
