"""The port's kernels alone: ``chip_smoke.py``'s kernel phase with no path
driven.

Run from the root of a checkout: ``python3 kernel_times.py``. Each kernel is
built, held to its plain version and timed at the shapes the paths give it,
as in ``chip_smoke.py``. No path runs, so it prints no launch counts and no
success line: only ``python3 chip_smoke.py`` gives those. Copied with
``chip_smoke.py`` into another checkout (an older tree unpacked with ``git
archive``), it times that checkout's kernels, so two trees compare in one
run on one card.

``--gemm-plans`` also times K1 at every launch plan its kernel takes (tile
and K split) at the paths' decode and prefill shapes, each output held to the
scaled ``torch._int_mm`` product bit for bit, marks ``gemm_plan``'s choice,
and reads how many thread block clusters of each size the card holds at once:
the readings ``ops/gemm.py``'s cost model is fitted to. ``--gemm-trace`` builds
a copy of ``csrc/gemm.cu`` that stamps the global timer at the phases of each
block (entry, first stage in, main loop done, reduction done, output staged,
stored) and prints where a block's time goes at a few plans.

``--k6-variants`` times K6 at a 7B int4 layer at each activation tile, at
decode and at the 2,048-row prefill (the readings behind
``ops/gemm.py:w4a8_tile``), and builds copies of ``csrc/gemm.cu`` whose K6
leaves out a part of its per-group flush, or runs it another way, timed
beside it at decode: where K6's time goes (the variants' outputs are wrong
by design; only the kernel's is checked).

``--k3-variants`` times K3 at its three shapes (``chip_smoke.py``'s) beside
copies of ``csrc/decode.cu`` with another ring depth or another count of
warps a block (each held to the plain version), and copies that leave out
work: the ring's copies and waits alone, and the scores without the value
product.

``--k7-variants`` times K7 at its shape (``chip_smoke.py``'s), at a
low-plane and a high-plane slot, beside copies of ``csrc/decode.cu`` that read
the old byte row after the arithmetic, read the token with 2-byte loads, or
launch blocks of 64 or 1,024 threads (each held to the plain version byte
for byte), or multiply by 1/scale where the kernel divides (wrong by
design), beside a graph node's floor and a ``copy_`` of the token.

``--k8-plans`` times K8's three entries (``ops/act.py``) at
``chip_smoke.py``'s K8 shapes at every block its kernel takes (threads and
units a thread), each result held to the plain version as
``chip_smoke.check_k8`` holds it, and marks ``act_plan``'s choice: the
readings behind ``act_plan``.

``--split-policy`` also times K5 at ``chip_smoke.py``'s split shapes (one
32,768-key sequence over 8 kv heads, int8 and bf16) for each count of items
an SM that ``ops/flash.py:decode_splits`` could aim for, each held to the
plain version.

Prints the ``[kernel]`` records and, as the last line, one
``{"kernel_times": ...}`` JSON object. Exits 1 if a kernel disagrees with
its plain version, 2 without a CUDA device or the package beside the script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

POLICY_PER_SM = (1, 2, 4, 8, 16)
POLICY_REPS = 3


def split_policy(failures: list) -> dict:
    """K5's device ms at the split shapes for each items-an-SM count: reps
    interleaved over the counts, each count's output held to the plain
    version once."""
    import chip_smoke
    from hydragen_torch.ops import flash
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    NL, b, hq, hkv, S, d = 2, 1, 32, 8, 32768, 128
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    shape = (NL, b, hkv, S, d)

    def case(dtype, filled):
        if dtype == torch.int8:
            k, v = (torch.randint(-127, 128, shape, dtype=dtype, device=dev, generator=g)
                    for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
                      for _ in range(2))
        else:
            k, v = (torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(2))
            ks = vs = None
        lens = torch.full((b,), filled, dtype=torch.int32, device=dev)

        def kw(i):
            sc = {} if ks is None else dict(k_scale=ks[i], v_scale=vs[i])
            return dict(kv_seq_lens=lens, **sc)

        def call(i):
            return flash.flash_attention_bhsd(q, k[i], v[i], **kw(i))

        ref = flash.flash_attention_bhsd_plain(q, k[NL - 1], v[NL - 1], **kw(NL - 1))[0]
        return call, ref

    cases = {torch.int8: case(torch.int8, S), torch.bfloat16: case(torch.bfloat16, S - 100)}
    keep = dict(flash.DECODE_WARPS_PER_SM)
    times: dict = {}
    try:
        for rep in range(POLICY_REPS):
            for per_sm in POLICY_PER_SM:
                for dtype, (call, ref) in cases.items():
                    flash.DECODE_WARPS_PER_SM[dtype] = per_sm
                    splits, chunk = flash.decode_splits(b * hkv, S, n_sm, per_sm)
                    name = f"{str(dtype).split('.')[-1]} {per_sm} an SM"
                    if rep == 0:
                        _, rel = chip_smoke.rel_err(call(NL - 1)[0], ref)
                        if rel > chip_smoke.TOL_REL:
                            failures.append(f"K5 split policy {name}: rel err {rel:.3g}")
                    ms = cuda_graph_time_ms(chip_smoke.Cycle(call, NL))
                    entry = times.setdefault(name, dict(splits=splits, chunk=chunk,
                                                        device_ms=[]))
                    entry["device_ms"].append(ms)
                    print(f"[split policy] rep {rep}: {name}: {splits} splits of {chunk}: "
                          f"{ms:.4f} ms (device, CUDA graph)", flush=True)
    finally:
        flash.DECODE_WARPS_PER_SM.update(keep)
    return times


GEMM_SHAPES = ((4096, 4096), (11264, 4096), (4096, 11264), (1024, 4096), (14336, 4096),
               (4096, 14336))  # (N, K) of the 7B and 8B projections


def _gemm_case(M, N, K, g, NL=4):
    from hydragen_torch.ops import gemm

    dev = torch.device("cuda")
    w = torch.randint(-127, 128, (NL, N, K), dtype=torch.int8, device=dev, generator=g)
    ws = (torch.rand(NL, N, device=dev, generator=g) * 2e-3 + 1e-4).to(torch.bfloat16)
    a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
    return a_q, a_s, w, ws


def gemm_plans(failures: list) -> dict:
    """K1's device ms (CUDA graph) at every (bm, bn, split) at the paths'
    shapes, each output bit-exact against the scaled torch._int_mm product,
    and the clusters of 1-4 blocks the card holds at once."""
    import ctypes

    import chip_smoke
    from hydragen_torch.ops import cuda_lib, gemm
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    f = cuda_lib.library("gemm").hydragen_w8a8_max_clusters
    f.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int(0)
    slots = {s: f(256, 128, s, ctypes.byref(status)) for s in gemm.GEMM_SPLITS}
    if status.value:
        failures.append(f"hydragen_w8a8_max_clusters: CUDA error {status.value}")
    print(f"[gemm plans] clusters the card holds at once, by blocks a cluster: {slots}",
          flush=True)
    n_sm = cuda_lib.sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(5)
    out: dict = {"cluster_slots": slots}
    readings = []
    for M in (256, 2048):
        for N, K in GEMM_SHAPES:
            a_q, a_s, w, ws = _gemm_case(M, N, K, g)
            ref = chip_smoke.int_mm_oracle(a_q, a_s, w[1].t().contiguous(), ws[1])
            steps = -(-K // gemm.GEMM_BK)
            chosen = gemm.gemm_plan(M, N, K, n_sm)
            times = {}
            for bm in ((128, 256) if M > 128 else (128,)):
                for bn in (128, 64):
                    for s in gemm.GEMM_SPLITS:
                        per = -(-steps // s)
                        if -(-steps // per) != s:
                            continue
                        plan = gemm.GemmPlan(bm, bn, s, per)

                        def call(i, plan=plan):
                            return gemm._launch_w8a8("w8a8_matmul_cached", a_q, a_s, w, ws, i,
                                                     torch.bfloat16, plan=plan)
                        if not torch.equal(call(1), ref):
                            failures.append(f"K1 M={M} N={N} K={K} {plan}: not bit-exact")
                        times[plan] = cuda_graph_time_ms(chip_smoke.Cycle(call, w.shape[0]))
            best = min(times, key=times.get)
            print(f"[gemm plans] M={M} N={N} K={K}: " + " | ".join(
                f"{p.bm}/{p.bn}/{p.splits}: {t:.4f}{' (plan)' if p == chosen else ''}"
                for p, t in times.items())
                + f"; best {list(best)}, plan {list(chosen)} at "
                  f"{times[chosen] / times[best]:.3f} x the best", flush=True)
            out[f"M={M} N={N} K={K}"] = dict(
                device_ms={"/".join(map(str, p[:3])): t for p, t in times.items()},
                plan=list(chosen), best=list(best))
            readings += [((M, N, K), p, t * 1e3) for p, t in times.items()]
            del a_q, a_s, w, ws, ref
    out["fit"] = fit_gemm_model(readings, n_sm)
    print(f"[gemm plans] cost model fitted to these readings: {out['fit']}", flush=True)
    return out


def fit_gemm_model(readings, n_sm) -> dict:
    """The constants of ops/gemm.py's cost model, fitted by least squares
    on the log of each reading's time (us)."""
    import math

    from scipy.optimize import least_squares

    from hydragen_torch.ops import gemm

    names = ("GEMM_STEP_US_A_ROW", "GEMM_STEP_US_BASE", "GEMM_STEP_US_PRODUCTS",
             "GEMM_BLOCK_US", "GEMM_SPLIT_US")
    keep = {n: getattr(gemm, n) for n in names}

    def residuals(x):
        for n, v in zip(names, x):
            setattr(gemm, n, v)
        return [math.log(gemm.gemm_plan_us(p, M, N, n_sm) / us)
                for (M, N, _), p, us in readings]
    try:
        fit = least_squares(residuals, [keep[n] for n in names])
    finally:
        for n, v in keep.items():
            setattr(gemm, n, v)
    return dict(zip(names, (round(float(v), 4) for v in fit.x)),
                rms_log_error=round(float(math.sqrt((fit.fun ** 2).mean())), 4))


# (search, insertion before it) in csrc/gemm.cu: the global timer's stamps.
_TRACE_MARKS = (
    ("  if (threadIdx.x == 0) {\n    for (int s = 0; s < C::ST; ++s) {", "  TR(0)\n"),
    ("    const uint32_t a_base = ring + s * C::STAGE", "    if (i == 0) TR(1)\n"),
    ("\n  // The K split's reduction.", "  TR(2)\n"),
    ("  named_sync(w8::SCALES_BAR, w8::THREADS);\n#pragma unroll", "  TR(3)\n"),
    ("  constexpr int CH = 16 / static_cast<int>(sizeof(OutT));", "  TR(4)\n"),
    ("}\n\n// ---------------------------------------------------------------------------\n"
     "// w4a8_kernel", "  TR(5)\n"),
)
TRACE_PHASES = ("fill", "main loop", "reduction", "output staged", "stored")


def _edited_libs(source: str, copies: dict, tag: str, failures: list) -> dict | None:
    """Build edited copies of csrc/<source>.cu, one nvcc each, all started
    together. ``copies`` maps a name to its edits, (search, replacement)
    pairs whose search must occur once; an empty search appends. The
    loaded libraries by name, or None with the fault added to
    ``failures``."""
    import ctypes
    import subprocess

    import chip_smoke
    from hydragen_torch.ops import cuda_lib

    src = (cuda_lib.CSRC / f"{source}.cu").read_text()
    out_dir = cuda_lib.build_dir() / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, edits in copies.items():
        text = src
        for old, new in edits:
            if not old:
                text += new
                continue
            if text.count(old) != 1:
                failures.append(f"{tag} {name}: edit not found once: {old!r}")
                return None
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        (out_dir / f"v{i}.cu").write_text(text)
        procs[name] = (out_dir / f"libv{i}.so", subprocess.Popen(
            [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC), "-o",
             str(out_dir / f"libv{i}.so"), str(out_dir / f"v{i}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: (so, proc.communicate()[0], proc.returncode)
            for name, (so, proc) in procs.items()}
    for name, (_, log, rc) in logs.items():
        if rc:
            failures.append(f"{tag} {name}: nvcc failed:\n{log}")
            return None
    chip_smoke.print_ptxas({f"{tag}/{name}": log for name, (_, log, _) in logs.items()})
    return {name: ctypes.CDLL(str(so)) for name, (so, _, _) in logs.items()}


@contextlib.contextmanager
def _gemm_lib(lib):
    """The GEMM wrappers launch from ``lib`` inside the block."""
    from hydragen_torch.ops import cuda_lib, gemm

    keep = cuda_lib._LIBS["gemm"]
    cuda_lib._LIBS["gemm"] = lib
    gemm._w8a8_fn.cache_clear()
    gemm._w4a8_fn.cache_clear()
    try:
        yield
    finally:
        cuda_lib._LIBS["gemm"] = keep
        gemm._w8a8_fn.cache_clear()
        gemm._w4a8_fn.cache_clear()


def gemm_trace(failures: list) -> dict:
    """Where a K1 block's time goes: a copy of csrc/gemm.cu whose block
    thread 0 stamps %globaltimer at six points, run once at a few plans;
    per phase the min / median / max over blocks (us), and the launch's
    span against its device time in a CUDA graph of 20 calls."""
    import ctypes

    import numpy as np

    import chip_smoke
    from hydragen_torch.ops import cuda_lib, gemm
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    head = "namespace {\n"
    edits = [(head, "__device__ unsigned long long g_trace[1 << 16][6];\n"
              "#define TR(i) if (threadIdx.x == 0) asm volatile(\"mov.u64 %0, "
              "%%globaltimer;\" : \"=l\"(g_trace[blockIdx.x][i]));\n" + head)]
    edits += [(mark, stamp + mark) for mark, stamp in _TRACE_MARKS]
    edits.append(("", '\nextern "C" int hydragen_k1_trace(void* dst, int n) {\n'
                  "  return (int)cudaMemcpyFromSymbol(dst, g_trace, (size_t)n * 48);\n}\n"))
    libs = _edited_libs("gemm", {"trace": edits}, "trace", failures)
    if libs is None:
        return {}
    lib = libs["trace"]
    lib.hydragen_k1_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(6)
    n_sm = cuda_lib.sm_count(torch.device("cuda"))
    out = {}
    with _gemm_lib(lib):
        for M, N, K in ((256, 4096, 4096), (256, 11264, 4096), (256, 4096, 11264),
                        (2048, 4096, 4096)):
            a_q, a_s, w, ws = _gemm_case(M, N, K, g)
            plan = gemm.gemm_plan(M, N, K, n_sm)

            def call(i):
                return gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws)
            ms = cuda_graph_time_ms(chip_smoke.Cycle(call, w.shape[0]))
            call(0)
            torch.cuda.synchronize()
            stamps = np.zeros((plan.blocks(M, N), 6), dtype=np.uint64)
            if lib.hydragen_k1_trace(stamps.ctypes.data, len(stamps)):
                failures.append("gemm trace: reading the stamps failed")
                return out
            t = (stamps.astype(np.int64) - int(stamps[:, 0].min())) / 1e3
            phases = {name: [float(np.min(d)), float(np.median(d)), float(np.max(d))]
                      for name, d in zip(TRACE_PHASES, np.diff(t, axis=1).T)}
            span = float(t[:, 5].max())
            print(f"[gemm trace] M={M} N={N} K={K} plan {list(plan)}: device {ms * 1e3:.2f} "
                  f"us a call (graph), span {span:.2f} us, block entry spread "
                  f"{float(t[:, 0].max()):.2f} us; min/median/max us: " + "; ".join(
                      f"{k} {v[0]:.2f}/{v[1]:.2f}/{v[2]:.2f}" for k, v in phases.items())
                  + f"; main loop a K step {phases['main loop'][1] / plan.split_steps:.3f}",
                  flush=True)
            out[f"M={M} N={N} K={K}"] = dict(plan=list(plan), device_us=ms * 1e3,
                                             span_us=span, phases_us=phases)
            del a_q, a_s, w, ws
    return out


# K6 variants: (name, [(search, replacement)]) applied to csrc/gemm.cu.
_K6_FLUSH_LO = ("          accf[j] = __fmaf_rn(static_cast<float>(acc_lo[j]), sc[h], "
                "accf[j]);\n")
_K6_FLUSH_HI = ("          accf[j] = __fmaf_rn(static_cast<float>(acc_hi[j]), sc[2 + h], "
                "accf[j]);\n")
K6_VARIANTS = {
    "no flush": [(_K6_FLUSH_LO, ""), (_K6_FLUSH_HI, "")],
    "low plane's flush only": [(_K6_FLUSH_HI, "")],
    "flush without cvt": [("static_cast<float>(acc_lo[j])", "__int_as_float(acc_lo[j])"),
                          ("static_cast<float>(acc_hi[j])", "__int_as_float(acc_hi[j])")],
    "two steps in flight": [("static constexpr int PIPE = NA == 64 ? 4 : 2;",
                             "static constexpr int PIPE = 2;")],
}
K6_LAYER = ((4096, 4096, 4), (11264, 4096, 2), (4096, 11264, 1))  # (N, K, calls a layer)
K6_REPS = 2


def k6_variants(failures: list) -> dict:
    """K6's device ms (CUDA graph) a 7B int4 layer: the kernel at each
    activation tile at M = 256 and 2,048 (the readings behind
    ops/gemm.py:w4a8_tile), and each of K6_VARIANTS (edited copies of
    csrc/gemm.cu, whose outputs are wrong by design) at M = 256 and the
    128-row tile, in K6_REPS interleaved rounds."""
    import chip_smoke
    from hydragen_torch.ops import cuda_lib, gemm
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    libs = _edited_libs("gemm", K6_VARIANTS, "k6_variants", failures)
    if libs is None:
        return {}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    NL = 6
    weights = []
    for N, K, n in K6_LAYER:
        qp = torch.randint(-128, 128, (NL, N, K // 2), dtype=torch.int8, device=dev, generator=g)
        gs = (torch.rand(NL, K // 128, N, device=dev, generator=g) * 2e-3 + 1e-4
              ).to(torch.bfloat16)
        weights.append((K, n, qp, gs))
    acts = {M: [gemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
                for K, *_ in weights] for M in (256, 2048)}

    def layer_ms(M, ba, check):
        ms = 0.0
        for (K, n, qp, gs), (a_q, a_s) in zip(weights, acts[M]):
            def call(i):
                return gemm._launch_w4a8("w4a8_matmul_cached", a_q, a_s, qp, gs, i,
                                         torch.float32, ba=ba)
            if check:
                ref = gemm.w4a8_cached_plain(1, a_q, a_s, qp, gs, torch.float32)
                _, rel = chip_smoke.rel_err(call(1), ref)
                if rel > chip_smoke.TOL_W4A8:
                    failures.append(f"k6 variants: the kernel's rel err {rel:.3g} at M={M} "
                                    f"ba={ba}")
            ms += n * cuda_graph_time_ms(chip_smoke.Cycle(call, NL))
        return ms

    runs = [(f"kernel M={M} ba={ba}", cuda_lib._LIBS["gemm"], M, ba)
            for M in (256, 2048) for ba in gemm.W4A8_TILES]
    runs += [(name, lib, 256, 128) for name, lib in libs.items()]
    out: dict = {key: [] for key, *_ in runs}
    for rep in range(K6_REPS):
        for key, lib, M, ba in runs:
            with _gemm_lib(lib):
                ms = layer_ms(M, ba, key.startswith("kernel") and rep == 0)
            out[key].append(ms)
            print(f"[k6 variants] rep {rep}: {key}: {ms:.4f} device ms a 7B int4 "
                  f"layer (M={M}, {ba}-row tile)", flush=True)
    return out


# K3 variants: (name, [(search, replacement)]) applied to csrc/decode.cu.
# The first five change the ring's depth or the warps a block, and "P V in
# one bf16 term" drops the second term of P (its rounding's remainder):
# whole kernels, each held to the plain version. The other two leave out
# work (wrong output by design): "copies only" keeps the ring and its waits
# and computes nothing, "no P V" computes the scores and the softmax but not
# the value product (its conversion goes with it).
_K3_FOLD = "    fold_tile<D, BITS, false>(stage, qa, valid, 0, ksc, o, m_run, l_run, g, t);\n"
_K3_FOLD_HI = ("        fold_tile<D, BITS, true>(stage, qa, valid, valid_hi, ksc, o, m_run, l_run, "
               "g, t);\n")
_K3_ST = "  static constexpr int ST = 2;\n"
_K3_WARPS = "  static constexpr int WARPS = 2;\n"
K3_VARIANTS = {
    "ST=3": [(_K3_ST, _K3_ST.replace("2", "3"))],
    "ST=4": [(_K3_ST, _K3_ST.replace("2", "4"))],
    "WARPS=1": [(_K3_WARPS, _K3_WARPS.replace("2", "1"))],
    "WARPS=4": [(_K3_WARPS, _K3_WARPS.replace("2", "4"))],
    "WARPS=8": [(_K3_WARPS, _K3_WARPS.replace("2", "8"))],
    "copies only": [(_K3_FOLD, "    (void)stage;\n"), (_K3_FOLD_HI, "        (void)stage;\n")],
    "no P V": [("        mma_bf16(o[j], pa[0][kk], b0, b1);\n", ""),
               ("        mma_bf16(o[j], pa[0][kk], lo0, lo1);\n", ""),
               ("        if constexpr (HIGH) mma_bf16(o[j], pa[P - 1][kk], hi0, hi1);\n", "")],
    "P V in one bf16 term": [
        ("      pa[pl][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x0 - hf.x, x1 - hf.y);\n",
         "      pa[pl][nt >> 1][(nt & 1) * 2 + 1] = 0u;\n")],
}
K3_WHOLE = ("ST=3", "ST=4", "WARPS=1", "WARPS=4", "WARPS=8", "P V in one bf16 term")
# (name, byte rows S, tokens written, kv bits): chip_smoke.py's three K3
# shapes; at int4 every 7th row holds S + 1 tokens.
K3_SHAPES = (("int8 63 of 64", 64, 63, 8), ("int8 191 of 192", 192, 191, 8),
             ("int4 190 of 192", 96, 190, 4))
K3_REPS = 2


@contextlib.contextmanager
def _decode_lib(lib):
    """The decode wrappers launch from ``lib`` inside the block."""
    from hydragen_torch.ops import cuda_lib

    keep = cuda_lib._LIBS["decode"]
    cuda_lib._LIBS["decode"] = lib
    try:
        yield
    finally:
        cuda_lib._LIBS["decode"] = keep


def k3_variants(failures: list) -> dict:
    """K3's device ms (CUDA graph) at its three shapes: the kernel and each
    of K3_VARIANTS (edited copies of csrc/decode.cu), in K3_REPS interleaved
    rounds; the kernel and the whole variants held to the plain version."""
    import re

    import chip_smoke
    from hydragen_torch.ops import cuda_lib, decode
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    libs = _edited_libs("decode", K3_VARIANTS, "k3_variants", failures)
    if libs is None:
        return {}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    NL, b, hq, hkv, d = 4, 256, 32, 32, 128
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    own = tuple(torch.randn(b, hkv, 1, d, device=dev, generator=g).to(torch.bfloat16)
                for _ in range(2))
    sh = (torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16),
          torch.randn(b, hq, 1, device=dev, generator=g) * 2)
    cases = {}
    for name, S, filled, bits in K3_SHAPES:
        planes = 2 if bits == 4 else 1
        ck, cv = (torch.randint(-128, 128, (NL, b, S, hkv, d), dtype=torch.int8, device=dev,
                                generator=g) for _ in range(2))
        cks, cvs = (torch.rand(NL, b, planes * S * hkv, device=dev, generator=g) * 0.02 + 1e-3
                    for _ in range(2))
        lens = torch.full((b,), filled, dtype=torch.int32, device=dev)
        if bits == 4:
            lens[::7] = S + 1
        kw = dict(kv_seq_lens=lens, k_scale_all=cks, v_scale_all=cvs, own_kv=own,
                  shared_partial=sh, kv_bits=bits)
        cases[name] = (ck, cv, kw, decode.decode_attention_cached_plain(NL - 1, q, ck, cv, **kw))
    src = (cuda_lib.CSRC / "decode.cu").read_text()
    cfg = " ".join(k + "=" + re.search(r"int %s = (\d+);" % k, src).group(1)
                   for k in ("ST", "WARPS"))
    runs = [(f"kernel ({cfg})", cuda_lib.library("decode")), *libs.items()]
    out: dict = {}
    for rep in range(K3_REPS):
        for key, lib in runs:
            with _decode_lib(lib):
                for shape, (ck, cv, kw, (ref, ref_lse)) in cases.items():
                    def call(i, ck=ck, cv=cv, kw=kw):
                        return decode.decode_attention_cached(i, q, ck, cv, **kw)
                    if rep == 0 and (key.startswith("kernel") or key in K3_WHOLE):
                        o, lse = call(NL - 1)
                        _, rel = chip_smoke.rel_err(o, ref)
                        lerr = float((lse - ref_lse).abs().max())
                        if rel > chip_smoke.TOL_REL or lerr > chip_smoke.TOL_LSE:
                            failures.append(f"k3 variants {key} {shape}: rel err {rel:.3g}, "
                                            f"lse err {lerr:.3g}")
                    ms = cuda_graph_time_ms(chip_smoke.Cycle(call, NL))
                    out.setdefault(key, {}).setdefault(shape, []).append(ms)
                    print(f"[k3 variants] rep {rep}: {key}: {shape}: {ms:.4f} device ms",
                          flush=True)
    return out


# K7 variants: (name, [(search, replacement)]) applied to csrc/decode.cu. The
# first four are whole kernels held to the plain version byte for byte: the
# old byte row read after the arithmetic (two dependent round trips at the
# high plane, as the parent's kernel had), the bf16 token read with 2-byte
# loads, and other block sizes. "x times 1/scale" replaces the IEEE division
# by a product (codes differ: wrong by design), to read what the divisions
# cost.
_K7_OLD_READ = "  if (live && hi) old = *reinterpret_cast<const uint2*>(dst);\n"
_K7_THREADS = "constexpr int WRITE_THREADS = 256;\n"
_K7_SHIFT = "  const int shift"
_K7_INV = "  const float inv = 1.0f / scale;\n" + _K7_SHIFT
K7_VARIANTS = {
    "old row read after the arithmetic": [
        (_K7_OLD_READ, ""),
        ("  if (!live) return;\n",
         "  if (!live) return;\n  if (hi) old = *reinterpret_cast<const uint2*>(dst);\n")],
    "2-byte loads": [
        ("  if (live) xw = __ldg(reinterpret_cast<const uint4*>(src));\n",
         "  if (live) {\n"
         "    const unsigned short* h = reinterpret_cast<const unsigned short*>(src);\n"
         "    uint32_t e[8];\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < 8; ++i) e[i] = __ldg(h + i);\n"
         "    xw = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,\n"
         "                    e[6] | e[7] << 16);\n"
         "  }\n")],
    "64 threads a block": [(_K7_THREADS, _K7_THREADS.replace("256", "64"))],
    "1024 threads a block": [(_K7_THREADS, _K7_THREADS.replace("256", "1024"))],
    "product, division near a half code": [
        ("    const int q = min(max(__float2int_rn(x[i] / scale), -7), 7);\n",
         "    float r = x[i] * inv;\n"
         "    if (fabsf(r - floorf(r) - 0.5f) <= 2e-6f) r = x[i] / scale;\n"
         "    const int q = min(max(__float2int_rn(r), -7), 7);\n"),
        (_K7_SHIFT, _K7_INV)],
    "x times 1/scale": [("__float2int_rn(x[i] / scale)", "__float2int_rn(x[i] * inv)"),
                        (_K7_SHIFT, _K7_INV)],
}
K7_WRONG = ("x times 1/scale",)
K7_REPS = 2


def k7_variants(failures: list) -> dict:
    """K7's device ms (CUDA graph) at chip_smoke.py's shape (b 256, 32 kv
    heads of 128, 96 byte rows, 4 layers cycled), at a low-plane and a
    high-plane slot: the kernel and each of K7_VARIANTS, in K7_REPS
    interleaved rounds, the whole ones held to the plain version byte for
    byte. Two yardsticks in the same rounds: a graph of one-element adds
    (a graph node's floor) and ``copy_`` of the bf16 K and V token into a
    buffer (4.19 MB read and written, L2-resident as K7's operands are)."""
    import chip_smoke
    from hydragen_torch.ops import cuda_lib, decode
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    libs = _edited_libs("decode", K7_VARIANTS, "k7_variants", failures)
    if libs is None:
        return {}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    NL, b, hkv, d, S = 4, 256, 32, 128, 96
    bufs = [torch.randint(-128, 128, (NL, b, S, hkv, d), dtype=torch.int8, device=dev,
                          generator=g) for _ in range(2)]
    bufs += [torch.rand(NL, b, 2 * S * hkv, device=dev, generator=g) for _ in range(2)]
    kv = [torch.randn(b, hkv, 1, d, device=dev, generator=g).mul(2).to(torch.bfloat16)
          for _ in range(2)]
    runs = [("kernel", cuda_lib.library("decode")), *libs.items()]
    out: dict = {}
    for rep in range(K7_REPS):
        for key, lib in runs:
            with _decode_lib(lib):
                for plane, slot in (("low", S // 2), ("high", S + 7)):
                    if rep == 0 and key not in K7_WRONG:
                        got, want = [t.clone() for t in bufs], [t.clone() for t in bufs]
                        decode.write_token_int4_cached(NL - 1, *kv, *got, slot)
                        decode.write_token_int4_cached_plain(NL - 1, *kv, *want, slot)
                        if not all(torch.equal(x, y) for x, y in zip(got, want)):
                            failures.append(f"k7 variants {key} {plane}: not bit-exact")
                        del got, want

                    def call(i, slot=slot):
                        decode.write_token_int4_cached(i, *kv, *bufs, slot)
                    ms = cuda_graph_time_ms(chip_smoke.Cycle(call, NL))
                    out.setdefault(key, {}).setdefault(plane, []).append(ms)
                    print(f"[k7 variants] rep {rep}: {key}: {plane} plane: {ms:.4f} device ms",
                          flush=True)
        tiny = torch.zeros(1, device=dev)
        token = torch.cat(kv)
        copies = torch.empty((NL, *token.shape), dtype=token.dtype, device=dev)
        for key, fn in (("graph node floor (one-element add)", lambda i: tiny.add_(1)),
                        ("copy_ of the bf16 K and V token", lambda i: copies[i].copy_(token))):
            ms = cuda_graph_time_ms(chip_smoke.Cycle(fn, NL))
            out.setdefault(key, []).append(ms)
            print(f"[k7 variants] rep {rep}: {key}: {ms:.4f} device ms", flush=True)
    return out


def k8_plans(failures: list) -> dict:
    """K8's device ms at each (threads, units a thread) its kernel takes, at
    each entry and shape of ``chip_smoke.check_k8``."""
    import chip_smoke
    from hydragen_torch.ops import act, gemm
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev, bf16, eps = torch.device("cuda"), torch.bfloat16, 1e-5
    g = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for K in chip_smoke.K8_WIDTHS:
        w = (1 + 0.1 * torch.randn(K, device=dev, generator=g)).to(bf16)
        plans = act.act_plans(K)
        for M in chip_smoke.K8_ROWS:
            x = torch.randn(M, K, device=dev, generator=g).to(bf16)
            d = (0.5 * torch.randn(M, K, device=dev, generator=g)).to(bf16)
            entries = {  # name: (op, kernel args, plain)
                "rms_norm_quant": ("rms_norm_add_quant", (x, d, w, eps),
                                   lambda: act.rms_norm_quant_plain(x, w, eps, d)),
                "rms_norm_quant no residual": ("rms_norm_quant", (x, None, w, eps),
                                               lambda: act.rms_norm_quant_plain(x, w, eps)),
                "silu_mul_quant": ("silu_mul_quant", (3 * x, d),
                                   lambda: act.silu_mul_quant_plain(3 * x, d)),
                "quantize_rows": ("quantize_rows", (x,), lambda: gemm.quantize_rows_plain(x)),
            }
            for name, (op, args, plain) in entries.items():
                args = tuple(a.contiguous() if torch.is_tensor(a) else a for a in args)
                want = plain()
                row = {}
                for plan in plans:
                    def run(plan=plan):
                        return act._launch(name.split()[0], op, *args, plan=plan)
                    res = run()
                    if op.startswith("rms_norm"):
                        pair, h = res if op == "rms_norm_add_quant" else (res, x)
                        ok = chip_smoke.k8_norm_match(x, w, eps, args[1], pair, h)["ok"]
                    else:
                        ok = torch.equal(res[0], want[0]) and torch.equal(res[1], want[1])
                    if not ok:
                        failures.append(f"k8 plan {plan} {name} M={M} K={K}")
                    row[f"{plan[0]}x{plan[1]}"] = cuda_graph_time_ms(run, iters=10)
                    del res
                best = min(row, key=row.get)
                chosen = "{}x{}".format(*act.act_plan(K, op))
                print(f"[k8 plans] {name} M={M} K={K}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
                      + f" ms; fastest {best}, act_plan {chosen}", flush=True)
                out[f"{name} M={M} K={K}"] = dict(device_ms=row, fastest=best, act_plan=chosen)
            del x, d
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split-policy", action="store_true",
                    help="also time K5's split shapes at each items-an-SM count")
    ap.add_argument("--gemm-plans", action="store_true",
                    help="also time K1 at every tile and split its kernel takes")
    ap.add_argument("--gemm-trace", action="store_true",
                    help="also stamp the phases of K1's blocks (an instrumented copy)")
    ap.add_argument("--k6-variants", action="store_true",
                    help="also time K6 beside copies that leave out parts of its flush")
    ap.add_argument("--k3-variants", action="store_true",
                    help="also time K3 beside copies with another ring depth or block, or "
                         "that leave out work")
    ap.add_argument("--k8-plans", action="store_true",
                    help="also time K8 at every block its kernel takes")
    ap.add_argument("--k7-variants", action="store_true",
                    help="also time K7 beside copies with the old row read late, 2-byte "
                         "loads, or other block sizes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import chip_smoke
        from hydragen_torch.ops import cuda_lib
        from hydragen_torch.utils.timing import cuda_time_ms
    except ModuleNotFoundError as e:
        print(f"kernel_times: {e}: run this script from the root of a checkout of the port",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    cuda_lib.build()
    chip_smoke.print_ptxas(cuda_lib.BUILD_LOG)
    report: dict = {}
    failures: list[str] = []
    chip_smoke.check_kernels(report, failures, cuda_time_ms)
    if args.split_policy:
        report["k5_split_policy"] = split_policy(failures)
    if args.gemm_plans:
        report["k1_plans"] = gemm_plans(failures)
    if args.gemm_trace:
        report["k1_trace"] = gemm_trace(failures)
    if args.k6_variants:
        report["k6_variants"] = k6_variants(failures)
    if args.k3_variants:
        report["k3_variants"] = k3_variants(failures)
    if args.k7_variants:
        report["k7_variants"] = k7_variants(failures)
    if args.k8_plans:
        report["k8_plans"] = k8_plans(failures)
    if failures:
        print("kernel_times FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernel_times": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
