"""Build and load the port's CUDA kernels.

Each source under ``hydragen_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds). Libraries are built
at first use into ``build/kernels/`` at the root of the checkout, named by a
hash of their source and flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing here runs
when the package is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("gemm", "flash", "decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# Launch count of each kernel wrapper: incremented where the wrapper launches
# its kernel and nowhere else (a CPU tensor's plain path does not count). A
# CUDA graph's capture launches nothing: its wrappers' counts are moved out
# of LAUNCHES into the graph (``captured_launches``) and added back at each
# replay (``add_launches``), so a replayed step counts what an eager one does.
LAUNCHES: dict[str, int] = {
    "w8a8_matmul_cached": 0,
    "w8a8_matmul": 0,
    # K1 with f32 column scales (a HF-loaded model): its own instantiation.
    "w8a8_matmul_cached_f32_scales": 0,
    "w8a8_matmul_f32_scales": 0,
    "flash_attention_cached_bhsd": 0,
    "flash_attention_bhsd": 0,
    "flash_decode_bhsd": 0,
    "decode_attention_cached": 0,
    "decode_attention_cached_int4": 0,
    "w4a8_matmul_cached": 0,
    "w4a8_matmul": 0,
    "write_token_int4_cached": 0,
}
# ptxas' report (registers, shared memory, spills) of each build, by source.
BUILD_LOG: dict[str, str] = {}


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "kernels"


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named sources that have no up-to-date library, all nvcc
    processes started together. Returns the seconds each build took (0.0 for
    a library that was already there); raises with nvcc's output on failure.
    """
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            tmp, out, time.perf_counter(),
        )
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def check_aligned(what: str, t, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (the
    kernels load 16-byte vectors; a view with an odd storage offset would
    fault or read across rows)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{what}: data is not {nbytes}-byte aligned "
                         f"(storage offset {t.storage_offset()})")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches(into: dict):
    """Within the block (a CUDA graph's capture), the wrappers' counts go to
    ``into`` (name: count) and LAUNCHES is left as it was."""
    before = dict(LAUNCHES)
    try:
        yield into
    finally:
        for name, n in LAUNCHES.items():
            if n != before[name]:
                into[name] = n - before[name]
        LAUNCHES.update(before)


def add_launches(counts: dict) -> None:
    """Count one replay of a graph whose capture recorded ``counts``."""
    for name, n in counts.items():
        LAUNCHES[name] += n


@functools.cache
def sm_count(device) -> int:
    """The SM count of CUDA device ``device`` (read once a device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
