#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: fails without a CUDA device; prints ``nvidia-smi``'s name and
   power limit of the card.
2. build: compiles every kernel under ``hydragen_torch/csrc/`` (one ``nvcc``
   per source, all started together) into ``build/kernels/``.
3. kernels: each kernel against its plain PyTorch version at the shapes the
   main path gives it, on the card, in bf16; its time (CUDA events), its bound
   (the larger of least bytes over 3.35 TB/s and least operations over the
   peak rate of their type) and, where one PyTorch call computes the same
   function, that call's time. K1 is timed at every decode and 2,048-row
   shape of both models and at request 2's 32,768-row gate/up, and each
   output must equal the scaled ``torch._int_mm`` product bit for bit. K2
   and K4 are also timed at the other shapes the paths give them (the 8B
   decode read, the 7B request-2 read, the 8B prefill, the 7B suffix
   prefill), nested under their entries. K6 is held to its f32 oracle at
   every decode and 2,048-row shape of the 7B int4 layer and at its 2-D
   entry. K1, K2, K4, K5 (at the gqa and no-sharing reads and two split
   shapes) and K6 (at each of its shapes) are also timed
   on the device's clock alone (``device_ms``: a CUDA graph of the calls, no
   host work between them), with SDPA's likewise, K2 on bf16 k/v and K4 at
   head_dim 64; where K5 splits the keys, torch.profiler times its kernel
   and ``split_combine`` apart.
4. main path: ``HydragenLlama`` at ``PRESETS["llama-2-7b"]`` full width,
   random weights from a seeded ``torch.Generator``, ``quantization="w8a8"``,
   ``kv_quant="int8"``; one request with a 2,048-token shared prompt and 256
   greedy completions (``shared_cache_op=WIPE``), then a second request of 256
   new 128-token suffixes over the kept prompt (``PRESERVE``). Every kernel's
   launch count must equal what the path implies. Then 8 decode steps of a
   third request run under ``torch.profiler``: device-busy share and device
   time by kernel (the full table goes to ``chiprun_out/profile_decode.txt``).
5. int4 path: the same two requests and profile at full 7B width with int4
   weights (``quantization="w4a8"``) and the token-planar int4 unique cache
   (``kv_quant="int4"``; the shared level int8). Request 1's decode writes
   the low nibble plane, request 2's the high plane over live low tokens.
6. gqa path: the same two requests and profile on ``PRESETS["llama-3-8b"]``
   (32 query heads over 8 kv heads) at full width and depth, w8a8 + int8
   KV. Its unique cache is BHSD, so every decode layer's unique read is the
   small-M read (K5) in place of K3. The profile fails on any copy of a
   unique-cache layer.
7. gqa no-sharing: the no-sharing baseline (``disable_hydragen=True``,
   ``bench.py``'s protocol: one 2,048-token prompt, 256 greedy completions,
   the prompt's KV in every unique row) against Hydragen on the same model
   and prompt in one engine: exact launch counts, tokens equal to
   Hydragen's (or, where a bf16 tie breaks the other way, the logits of a
   forced stream within ``TOL_NOSHARE``), both decode rates, a profile.
8. plain path: the w8a8 + int8-KV models (Llama-2-7B, and Llama-3-8B whose
   unique read is K5) at 2 layers of full width on one forced token stream,
   and the w4a8 + int4-KV model over two requests whose decode crosses into
   the high plane: the kernel path, and each kernel alone in the plain path,
   held against ``impl="torch"`` (every op's plain version), with the plain
   path in fp32 as the yardstick of all.

Prints one ``{"kernels": [...]}`` JSON line, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, and prints no result, if
any phase fails, no CUDA device is present or the package is not beside the
script. ``kernel_times.py`` runs the kernel phase alone.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}  # dense, per second

# Main-path sizes.
SHARED_LEN = 2048
BATCH = 256
SUFFIX_LEN = 128
NEW_TOKENS = 64  # per request; cut this, never the width or the batch
PROFILE_STEPS = 8

TOL_REL = 2e-2  # kernel vs plain: max |err| / max |plain|, bf16 outputs
TOL_LSE = 2e-2  # absolute, natural-log units
# w4a8 in fp32 against its f32 oracle: the group sums are exact, only their
# f32 summation order differs.
TOL_W4A8 = 1e-5
# 2-layer model: a kernel run's distance to the fp32 plain path against the
# plain bf16 path's, as a ratio (see check_plain_path). At seed 0 on an H100
# the RMS ratios read 1.000-1.013 and the largest-distance ratios 0.85-1.17.
TOL_RMS = 1.05
TOL_MAX = 1.25
# No-sharing against Hydragen at 32 layers of Llama-3-8B, both in bf16 on one
# forced token stream: the largest per-step RMS distance of row 0's logits,
# relative to Hydragen's. The two compute one function and differ only in
# rounding (which partials are merged, bf16 P), amplified layer by layer by
# the per-row int8 re-quantization; a missing or misplaced prefix copy gives
# a distance near 1.
TOL_NOSHARE = 0.2


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def rel_err(out, ref) -> tuple[float, float]:
    out, ref = out.float(), ref.float()
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-6)


class Cycle:
    """Calls ``fn(i)`` with i = 0, 1, ... mod n: timing loops walk over n
    layers of weights or caches, as the model does, so L2 does not hold the
    operands between calls."""

    def __init__(self, fn, n):
        self.fn, self.n, self.i = fn, n, 0

    def __call__(self):
        self.i = (self.i + 1) % self.n
        return self.fn(self.i)


def int_mm_oracle(a_q, a_s, wt, ws, out_dtype=torch.bfloat16):
    """K1's function in the kernel's order from the exact i32 product of
    ``torch._int_mm`` (``wt`` the weight transposed, [K, N]): the kernel's
    output must equal it bit for bit. A yardstick only; the port never
    calls ``torch._int_mm``."""
    return (torch._int_mm(a_q, wt).float() * a_s * ws.float()[None, :]).to(out_dtype)


def gemm_plan_of(gemm, M, N, K):
    """K1's launch plan at this shape, as a list (None for a tree whose
    K1 has no plan)."""
    plan = getattr(gemm, "gemm_plan", None)
    if plan is None:
        return None
    return list(plan(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count))


def print_ptxas(build_log: dict) -> None:
    """ptxas' registers, barriers and spills of each kernel built in this
    process (``cuda_lib.BUILD_LOG``), one ``[ptxas]`` line each."""
    import re

    for name, log in build_log.items():
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '_ZN\w+?_cu_[0-9a-f]{8}\d+(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and ("Used" in line or "spill" in line):
                print(f"[ptxas] {name}.cu {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)


def check_kernels(report: dict, failures: list, time_ms) -> None:
    from hydragen_torch.ops import decode, flash, gemm
    from hydragen_torch.ops.quant import dequantize_kv
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    F = torch.nn.functional
    H, I_PAD, hq, hkv, d = 4096, 11264, 32, 32, 128

    def record(name, ok, msg):
        print(f"[kernel] {name}: {msg} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"kernel {name}: {msg}")

    # K1: the seven projections of one layer, at decode (M = 256) and at the
    # shared prefill (M = 2,048), then the gate/up projection of request 2's
    # unique prefill (M = 32,768). The JSON reports one decode layer's sum;
    # each shape's own readings are nested under "shapes". Each output must
    # also equal the exact i32 product scaled in the kernel's order bit for
    # bit (torch._int_mm as the oracle). device_ms: a CUDA graph of the
    # calls (no host work between them); ms: host-paced.
    NL = 6
    shapes = {"qkvo": (H, H), "gate_up": (I_PAD, H), "down": (H, I_PAD)}
    per_layer = {"qkvo": 4, "gate_up": 2, "down": 1}
    weights = {}
    for key, (N, K) in shapes.items():
        w = torch.randint(-127, 128, (NL, N, K), dtype=torch.int8, device=dev, generator=g)
        ws = (torch.rand(NL, N, device=dev, generator=g) * 2e-3 + 1e-4).to(torch.bfloat16)
        weights[key] = (w, ws, w.transpose(1, 2).contiguous())
    k1 = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, int_mm_device_ms=0.0,
              err=0.0, bytes=0, ops=0)
    k1_shapes = {}
    runs = [(M, key) for M in (BATCH, SHARED_LEN) for key in shapes]
    runs.append((BATCH * SUFFIX_LEN, "gate_up"))
    for M, key in runs:
        N, K = shapes[key]
        w, ws, wt = weights[key]
        a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
        out = gemm.w8a8_matmul_cached(NL - 1, a_q, a_s, w, ws)
        ref = gemm.w8a8_cached_plain(NL - 1, a_q, a_s, w, ws, out_dtype=torch.float32)
        err, rel = rel_err(out, ref)
        exact = torch.equal(out, int_mm_oracle(a_q, a_s, wt[NL - 1], ws[NL - 1]))
        del ref
        ms = time_ms(Cycle(lambda i: gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws), NL))
        dms = cuda_graph_time_ms(Cycle(lambda i: gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws),
                                       NL))
        pms = time_ms(Cycle(lambda i: gemm.w8a8_cached_plain(i, a_q, a_s, w, ws), NL),
                      iters=2 if M > SHARED_LEN else 5, warmup=1)
        lms = time_ms(Cycle(lambda i: torch._int_mm(a_q, wt[i]), NL))
        ldms = cuda_graph_time_ms(Cycle(lambda i: torch._int_mm(a_q, wt[i]), NL))
        nbytes = M * K + M * 4 + N * K + N * 2 + M * N * 2
        ops = 2 * M * N * K
        bms, by = bound_ms(nbytes, ops, "int8")
        plan = gemm_plan_of(gemm, M, N, K)
        record(
            f"w8a8_matmul_cached M={M} N={N} K={K}", rel <= TOL_REL and exact,
            f"max_abs_err {err:.4g} rel {rel:.3g} (tol {TOL_REL}) bit-exact vs int_mm {exact} "
            f"ms {ms:.4f} device_ms {dms:.4f} plain_ms {pms:.4f} int_mm_ms {lms:.4f} "
            f"int_mm_device_ms {ldms:.4f} bound_ms {bms:.4f} ({by}) device TOP/s "
            f"{ops / dms / 1e9:.1f} plan {plan}",
        )
        k1_shapes[f"M={M} N={N} K={K}"] = dict(
            max_abs_err=err, bit_exact=exact, ms=ms, device_ms=dms, plain_ms=pms,
            library_ms=lms, int_mm_device_ms=ldms, bound_ms=bms, bound_by=by,
            device_top_s=ops / dms / 1e9, plan=plan)
        if M == BATCH:
            n = per_layer[key]
            for field, v in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                             ("library_ms", lms), ("int_mm_device_ms", ldms),
                             ("bytes", nbytes), ("ops", ops)):
                k1[field] += n * v
            k1["err"] = max(k1["err"], err)
        del a_q, a_s, out
    bms, by = bound_ms(k1["bytes"], k1["ops"], "int8")
    report["w8a8_matmul_cached"] = dict(
        max_abs_err=k1["err"], ms=k1["ms"], device_ms=k1["device_ms"], plain_ms=k1["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=k1["library_ms"],
        int_mm_device_ms=k1["int_mm_device_ms"], shapes=k1_shapes,
        at="sum of one decode layer's 7 projections, M=256 (library: torch._int_mm, "
           "no scale epilogue; device_ms: from a CUDA graph of the calls)",
    )

    # K1': the 2-D entry of K1's kernel (layer stride 0), through qmatmul,
    # at the q projection's decode shape.
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.ops.quant import QuantizedTensor, qmatmul

    w, ws, wt = weights["qkvo"]
    x = torch.randn(BATCH, 1, H, device=dev, generator=g).to(torch.bfloat16)
    a_q, a_s = gemm.quantize_rows(x.reshape(BATCH, H))
    before = cuda_lib.LAUNCHES["w8a8_matmul"]
    out = qmatmul(x, QuantizedTensor(w[0], ws[0]), "bth,hd->btd", impl="w8a8")
    launched = cuda_lib.LAUNCHES["w8a8_matmul"] - before
    ref = gemm.w8a8_reference(a_q, a_s, w[0], ws[0], out_dtype=torch.float32)
    err, rel = rel_err(out.reshape(BATCH, H), ref)
    exact = torch.equal(out.reshape(BATCH, H), int_mm_oracle(a_q, a_s, wt[0], ws[0]))
    ms = time_ms(Cycle(lambda i: gemm.w8a8_matmul(a_q, a_s, w[i], ws[i]), NL))
    dms = cuda_graph_time_ms(Cycle(lambda i: gemm.w8a8_matmul(a_q, a_s, w[i], ws[i]), NL))
    pms = time_ms(Cycle(lambda i: gemm.w8a8_reference(a_q, a_s, w[i], ws[i]), NL), iters=5)
    lms = time_ms(Cycle(lambda i: torch._int_mm(a_q, wt[i]), NL))
    ldms = cuda_graph_time_ms(Cycle(lambda i: torch._int_mm(a_q, wt[i]), NL))
    nbytes = BATCH * H + BATCH * 4 + H * H + H * 2 + BATCH * H * 2
    bms, by = bound_ms(nbytes, 2 * BATCH * H * H, "int8")
    record(f"w8a8_matmul (2-D entry via qmatmul) M={BATCH} N={H} K={H}",
           rel <= TOL_REL and exact and launched == 1,
           f"launches {launched} max_abs_err {err:.4g} rel {rel:.3g} bit-exact vs int_mm "
           f"{exact} ms {ms:.4f} device_ms {dms:.4f} plain_ms {pms:.4f} int_mm_ms {lms:.4f} "
           f"int_mm_device_ms {ldms:.4f} bound_ms {bms:.4f}")
    report["w8a8_matmul"] = dict(
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=lms, int_mm_device_ms=ldms,
        at="2-D weight through qmatmul(impl='w8a8'), M=256 N=4096 K=4096 (library: "
           "torch._int_mm, no scale epilogue); off both paths, whose LM head is "
           "weight-only",
    )
    del weights

    # K6: the int4 projections of one layer (group 128), at decode and at the
    # shared prefill, then the gate/up projection of request 2's unique
    # prefill (M = 32,768: more M tiles than one raster group, and a short
    # last group), then the 2-D entry. The JSON reports one decode layer's
    # sum; each shape's own readings are nested under "shapes". device_ms: a
    # CUDA graph of the calls (no host work between them); ms: host-paced.
    weights4 = {}
    for key, (N, K) in shapes.items():
        qp = torch.randint(-128, 128, (NL, N, K // 2), dtype=torch.int8, device=dev,
                           generator=g)
        gs = (torch.rand(NL, K // 128, N, device=dev, generator=g) * 2e-3 + 1e-4
              ).to(torch.bfloat16)
        weights4[key] = (qp, gs)
    k6 = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, err=0.0, bytes=0, ops=0)
    k6_shapes = {}
    for M, key in runs:
        N, K = shapes[key]
        qp, gs = weights4[key]
        a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
        out = gemm.w4a8_matmul_cached(NL - 1, a_q, a_s, qp, gs, out_dtype=torch.float32)
        ref = gemm.w4a8_cached_plain(NL - 1, a_q, a_s, qp, gs, out_dtype=torch.float32)
        err, rel = rel_err(out, ref)
        del out, ref
        ms = time_ms(Cycle(lambda i: gemm.w4a8_matmul_cached(i, a_q, a_s, qp, gs), NL))
        dms = cuda_graph_time_ms(
            Cycle(lambda i: gemm.w4a8_matmul_cached(i, a_q, a_s, qp, gs), NL))
        pms = time_ms(Cycle(lambda i: gemm.w4a8_cached_plain(i, a_q, a_s, qp, gs), NL),
                      iters=2 if M > SHARED_LEN else 5, warmup=1)
        nbytes = M * K + M * 4 + N * K // 2 + (K // 128) * N * 2 + M * N * 2
        ops = 2 * M * N * K
        bms, by = bound_ms(nbytes, ops, "int8")
        record(
            f"w4a8_matmul_cached M={M} N={N} K={K}", rel <= TOL_W4A8,
            f"max_abs_err {err:.4g} rel {rel:.3g} (fp32 out, tol {TOL_W4A8}) ms {ms:.4f} "
            f"device_ms {dms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}) device "
            f"TOP/s {ops / dms / 1e9:.1f}",
        )
        k6_shapes[f"M={M} N={N} K={K}"] = dict(
            max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
            bound_by=by, device_top_s=ops / dms / 1e9)
        if M == BATCH:
            n = per_layer[key]
            for field, v in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                             ("bytes", nbytes), ("ops", ops)):
                k6[field] += n * v
            k6["err"] = max(k6["err"], err)
        del a_q, a_s
    from hydragen_torch.ops.quant import Quantized4Tensor

    # The 2-D entry: one launch through qmatmul (bf16 out), and fp32 out
    # against the oracle at the f32 tolerance.
    qp, gs = weights4["qkvo"]
    x = torch.randn(BATCH, 1, H, device=dev, generator=g).to(torch.bfloat16)
    a_q, a_s = gemm.quantize_rows(x.reshape(BATCH, H))
    before = cuda_lib.LAUNCHES["w4a8_matmul"]
    out = qmatmul(x, Quantized4Tensor(qp[0], gs[0]), "bth,hd->btd", impl="w4a8")
    launched = cuda_lib.LAUNCHES["w4a8_matmul"] - before
    ref = gemm.w4a8_reference(a_q, a_s, qp[0], gs[0], out_dtype=torch.float32)
    _, rel = rel_err(out.reshape(BATCH, H), ref)
    err32, rel32 = rel_err(gemm.w4a8_matmul(a_q, a_s, qp[0], gs[0], torch.float32), ref)
    ms2 = time_ms(Cycle(lambda i: gemm.w4a8_matmul(a_q, a_s, qp[i], gs[i]), NL))
    dms2 = cuda_graph_time_ms(Cycle(lambda i: gemm.w4a8_matmul(a_q, a_s, qp[i], gs[i]), NL))
    record(f"w4a8_matmul (2-D entry via qmatmul) M={BATCH} N={H} K={H}",
           rel <= TOL_REL and rel32 <= TOL_W4A8 and launched == 1,
           f"launches {launched} rel {rel:.3g} (bf16 out); fp32 out max_abs_err {err32:.4g} "
           f"rel {rel32:.3g} (tol {TOL_W4A8}) ms {ms2:.4f} device_ms {dms2:.4f}")
    bms, by = bound_ms(k6["bytes"], k6["ops"], "int8")
    print(f"[kernel] w4a8_matmul_cached, one decode layer (7 projections, M={BATCH}): "
          f"device_ms {k6['device_ms']:.4f} ms {k6['ms']:.4f} bound_ms {bms:.4f} ({by})",
          flush=True)
    report["w4a8_matmul_cached"] = dict(
        max_abs_err=k6["err"], ms=k6["ms"], device_ms=k6["device_ms"], plain_ms=k6["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=None, shapes=k6_shapes,
        entry_2d=dict(max_abs_err=err32, ms=ms2, device_ms=dms2),
        at="sum of one decode layer's 7 int4 projections, M=256, group 128; the 2-D "
           "entry (w4a8_matmul, hydragen_tpu/ops/gemm.py:377) under entry_2d, at N=K=4096 "
           "(library: none, no PyTorch call multiplies packed int4 weights with group "
           "scales; device_ms: from a CUDA graph of the calls)",
    )
    del weights4

    # K2: the shared-level read of one decode layer: sb=1, 256 folded rows,
    # 2,048 int8 keys with per-token scales.
    NLV = 6
    shape = (NLV, 1, hkv, SHARED_LEN, d)
    lk = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
    lv = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
    lks = torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
    lvs = torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
    lens = torch.full((1,), SHARED_LEN, dtype=torch.int32, device=dev)
    q = torch.randn(1, hq, BATCH, d, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(kv_seq_lens=lens, k_scale_all=lks, v_scale_all=lvs)
    o, lse = flash.flash_attention_cached_bhsd(NLV - 1, q, lk, lv, **kw)
    po, plse = flash.flash_attention_cached_plain(NLV - 1, q, lk, lv, **kw)
    err, rel = rel_err(o, po)
    lerr = float((lse - plse).abs().max())
    ms = time_ms(Cycle(lambda i: flash.flash_attention_cached_bhsd(i, q, lk, lv, **kw), NLV))
    pms = time_ms(Cycle(lambda i: flash.flash_attention_cached_plain(i, q, lk, lv, **kw), NLV),
                  iters=5)
    kdq = dequantize_kv(lk[:, 0], lks[:, 0])[:, None]
    vdq = dequantize_kv(lv[:, 0], lvs[:, 0])[:, None]
    lms = time_ms(Cycle(lambda i: F.scaled_dot_product_attention(q, kdq[i], vdq[i]), NLV))
    # Device time with no host work between calls (the wrapper's host time is
    # about the kernel's here), and the same read of the dequantized bf16 k/v,
    # which K2 takes by TMA straight into its ring: int8 against bf16 prices
    # the int8 -> bf16 conversion and the scales.
    dms = cuda_graph_time_ms(Cycle(
        lambda i: flash.flash_attention_cached_bhsd(i, q, lk, lv, **kw), NLV))
    lk16, lv16 = kdq.contiguous(), vdq.contiguous()
    o16, lse16 = flash.flash_attention_cached_bhsd(NLV - 1, q, lk16, lv16, kv_seq_lens=lens)
    po16, plse16 = flash.flash_attention_cached_plain(NLV - 1, q, lk16, lv16, kv_seq_lens=lens)
    err16, rel16 = rel_err(o16, po16)
    lerr16 = float((lse16 - plse16).abs().max())
    dms16 = cuda_graph_time_ms(Cycle(lambda i: flash.flash_attention_cached_bhsd(
        i, q, lk16, lv16, kv_seq_lens=lens), NLV))
    ldms = cuda_graph_time_ms(Cycle(
        lambda i: F.scaled_dot_product_attention(q, kdq[i], vdq[i]), NLV))
    nbytes = 2 * q.numel() * 2 + 2 * hkv * SHARED_LEN * d + 2 * hkv * SHARED_LEN * 4 \
        + hq * BATCH * 4
    ops = 4 * hq * BATCH * SHARED_LEN * d
    bms, by = bound_ms(nbytes, ops, "bf16")
    record("flash_attention_cached_bhsd", rel <= TOL_REL and lerr <= TOL_LSE,
           f"max_abs_err {err:.4g} rel {rel:.3g} lse_err {lerr:.3g} ms {ms:.4f} "
           f"plain_ms {pms:.4f} sdpa_ms {lms:.4f} bound_ms {bms:.4f}; device (graph): int8 "
           f"{dms:.4f} bf16 {dms16:.4f} sdpa {ldms:.4f} ms")
    record("flash_attention_cached_bhsd bf16 k/v", rel16 <= TOL_REL and lerr16 <= TOL_LSE,
           f"max_abs_err {err16:.4g} rel {rel16:.3g} lse_err {lerr16:.3g}")
    report["flash_attention_cached_bhsd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms,
        device_ms=dms, bf16_device_ms=dms16, library_device_ms=ldms,
        at="sb=1, 256 folded rows, S=2048 int8 (library: SDPA on bf16 dequantized k/v; "
           "device_ms: from a CUDA graph of the calls; bf16_device_ms: K2 on those bf16 k/v)",
    )
    del lk16, lv16, kdq, vdq

    # K4: causal attention of the shared prefill, one layer at 2,048 tokens.
    qp, kp, vp = (torch.randn(1, hq, SHARED_LEN, d, device=dev, generator=g)
                  .to(torch.bfloat16) for _ in range(3))
    o, lse = flash.flash_attention_bhsd(qp, kp, vp, causal=True)
    po, plse = flash.flash_attention_bhsd_plain(qp, kp, vp, causal=True)
    err, rel = rel_err(o, po)
    lerr = float((lse - plse).abs().max())
    ms = time_ms(lambda: flash.flash_attention_bhsd(qp, kp, vp, causal=True))
    pms = time_ms(lambda: flash.flash_attention_bhsd_plain(qp, kp, vp, causal=True), iters=5)
    lms = time_ms(lambda: F.scaled_dot_product_attention(qp, kp, vp, is_causal=True))
    dms = cuda_graph_time_ms(lambda: flash.flash_attention_bhsd(qp, kp, vp, causal=True))
    ldms = cuda_graph_time_ms(
        lambda: F.scaled_dot_product_attention(qp, kp, vp, is_causal=True))
    # The same prefill at head_dim 64: half the products and bytes, the same
    # number of scores, so the share of the time that does not fall with D is
    # the per-score work (softmax, masks, a tile's synchronisation).
    q64, k64, v64 = (x[..., :64].contiguous() for x in (qp, kp, vp))
    o64, lse64 = flash.flash_attention_bhsd(q64, k64, v64, causal=True)
    po64, plse64 = flash.flash_attention_bhsd_plain(q64, k64, v64, causal=True)
    err64, rel64 = rel_err(o64, po64)
    lerr64 = float((lse64 - plse64).abs().max())
    dms64 = cuda_graph_time_ms(lambda: flash.flash_attention_bhsd(q64, k64, v64, causal=True))
    nbytes = 4 * qp.numel() * 2 + hq * SHARED_LEN * 4
    ops = 4 * hq * d * SHARED_LEN * (SHARED_LEN + 1) // 2
    bms, by = bound_ms(nbytes, ops, "bf16")
    record("flash_attention_bhsd causal", rel <= TOL_REL and lerr <= TOL_LSE,
           f"max_abs_err {err:.4g} rel {rel:.3g} lse_err {lerr:.3g} ms {ms:.4f} "
           f"plain_ms {pms:.4f} sdpa_ms {lms:.4f} bound_ms {bms:.4f}; device (graph): "
           f"{dms:.4f}, at d=64 {dms64:.4f}, sdpa {ldms:.4f} ms")
    record("flash_attention_bhsd causal d=64", rel64 <= TOL_REL and lerr64 <= TOL_LSE,
           f"max_abs_err {err64:.4g} rel {rel64:.3g} lse_err {lerr64:.3g}")
    report["flash_attention_bhsd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms,
        device_ms=dms, d64_device_ms=dms64, library_device_ms=ldms,
        at="causal, 1x32 heads x 2048 x 128 bf16 (library: SDPA is_causal; device_ms: "
           "from a CUDA graph of the calls; d64_device_ms: K4 at head_dim 64)",
    )
    del q64, k64, v64
    del qp, kp, vp, lk, lv

    check_decode_kernels(report, time_ms, g, record)
    check_gqa_kernels(report, failures, time_ms, g, record)
    check_flash_shapes(report, time_ms, g, record)


def check_decode_kernels(report: dict, time_ms, g, record) -> None:
    """K3 at the three unique reads of the 7B paths' decode steps, and K7 at
    the int4 path's write. Each K3 shape: 256 rows, 32 kv heads of 128, own
    token and shared partial merged, against its plain version; ``ms``
    host-paced, ``device_ms`` from a CUDA graph of the calls, and SDPA over
    bf16 copies of the same keys (every row at the shape's length) as a
    yardstick of another function: no LSE, no own token, no merge."""
    from hydragen_torch.ops import decode
    from hydragen_torch.ops.quant import unpack4
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    F = torch.nn.functional
    NL, hq, hkv, d = 4, 32, 32, 128
    qd = torch.randn(BATCH, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    own = tuple(torch.randn(BATCH, hkv, 1, d, device=dev, generator=g).to(torch.bfloat16)
                for _ in range(2))
    sh = (torch.randn(BATCH, hq, 1, d, device=dev, generator=g).to(torch.bfloat16),
          torch.randn(BATCH, hq, 1, device=dev, generator=g) * 2)

    def k3_case(name, S, filled, bits, lens=None):
        """K3 over [NL, 256, S, 32, 128] caches (S byte rows; int4 holds 2S
        tokens), ``filled`` tokens a row unless ``lens`` says otherwise.
        Returns its readings and the cache buffers."""
        planes = 2 if bits == 4 else 1
        shape = (NL, BATCH, S, hkv, d)
        ck, cv = (torch.randint(-128 if bits == 4 else -127, 128, shape, dtype=torch.int8,
                                device=dev, generator=g) for _ in range(2))
        lo_s, span = (1e-2, 0.2) if bits == 4 else (1e-3, 0.02)
        cks, cvs = (torch.rand(NL, BATCH, planes * S * hkv, device=dev, generator=g) * span
                    + lo_s for _ in range(2))
        ulens = torch.full((BATCH,), filled, dtype=torch.int32, device=dev) if lens is None \
            else lens
        kw = dict(kv_seq_lens=ulens, k_scale_all=cks, v_scale_all=cvs, own_kv=own,
                  shared_partial=sh, kv_bits=bits)

        def call(i):
            return decode.decode_attention_cached(i, qd, ck, cv, **kw)

        o, lse = call(NL - 1)
        po, plse = decode.decode_attention_cached_plain(NL - 1, qd, ck, cv, **kw)
        err, rel = rel_err(o, po)
        lerr = float((lse - plse).abs().max())
        ms = time_ms(Cycle(call, NL))
        dms = cuda_graph_time_ms(Cycle(call, NL))
        pms = time_ms(Cycle(lambda i: decode.decode_attention_cached_plain(
            i, qd, ck, cv, **kw), NL), iters=5)

        def bf16_copy(buf, scales, i):  # [b, hkv, filled, d], dequantized
            x = buf[i]
            if bits == 4:
                x = torch.cat(unpack4(x), dim=1)
            sc = scales[i].reshape(BATCH, planes * S, hkv)[:, :filled, :, None]
            return (x[:, :filled].float() * sc).to(torch.bfloat16).transpose(1, 2).contiguous()

        kb = [bf16_copy(ck, cks, i) for i in range(NL)]
        vb = [bf16_copy(cv, cvs, i) for i in range(NL)]

        def sdpa(i):
            return F.scaled_dot_product_attention(qd, kb[i], vb[i])

        lms = time_ms(Cycle(sdpa, NL))
        ldms = cuda_graph_time_ms(Cycle(sdpa, NL))
        del kb, vb
        tokens = int(torch.clamp(ulens, max=planes * S).sum())
        rows_read = int(torch.clamp(ulens, max=S).sum())
        nbytes = (qd.numel() * 2 * 2 + 2 * rows_read * hkv * d + 2 * tokens * hkv * 4
                  + 2 * own[0].numel() * 2 + sh[0].numel() * 2 + 2 * BATCH * hq * 4)
        ops = 4 * hq * d * (tokens + BATCH)
        bms, by = bound_ms(nbytes, ops, "bf16")
        record(name, rel <= TOL_REL and lerr <= TOL_LSE,
               f"max_abs_err {err:.4g} rel {rel:.3g} lse_err {lerr:.3g} ms {ms:.4f} "
               f"plain_ms {pms:.4f} sdpa_ms {lms:.4f} bound_ms {bms:.4f}; device (graph) "
               f"{dms:.4f}, sdpa {ldms:.4f} ms")
        return dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=lms, library_device_ms=ldms), (ck, cv, cks, cvs)

    yardstick = ("library: SDPA over bf16 copies of the written keys, every row at {n}, "
                 "not the same function: no LSE, no own token, no merge; device_ms: from a "
                 "CUDA graph of the calls, SDPA's likewise")
    # int8, request 1's last step: 63 of a 64-slot window.
    r1, bufs = k3_case("decode_attention_cached", 64, 63, 8)
    # int8, request 2's last step: the window the engine allocates for the
    # main path (128 suffix + 64 new tokens), 128 + 63 written.
    window = SUFFIX_LEN + NEW_TOKENS
    del bufs
    r2, bufs = k3_case("decode_attention_cached request 2", window, window - 1, 8)
    report["decode_attention_cached"] = dict(
        **r1, at="b=256, 63 of 64 int8 slots, own token + shared partial ("
                 + yardstick.format(n=63) + ")",
        request2=dict(r2, at=f"b=256, {window - 1} of {window} int8 slots ("
                             + yardstick.format(n=window - 1) + ")"),
    )
    del bufs
    # int4, request 2's last step: a 192-token window (S = 96 byte rows),
    # 190 tokens written, so every row reads the high plane; every 7th row
    # one token past the plane boundary.
    S4, filled4 = window // 2, window - 2
    ulens = torch.full((BATCH,), filled4, dtype=torch.int32, device=dev)
    ulens[::7] = S4 + 1
    r4, (ck, cv, cks, cvs) = k3_case(
        f"decode_attention_cached kv_bits=4 (S={S4} byte rows, lengths {S4 + 1} and "
        f"{filled4})", S4, filled4, 4, ulens)
    report["decode_attention_cached_int4"] = dict(
        **r4, at=f"b=256, int4 window of {2 * S4} tokens ({S4} byte rows), {filled4} written "
                 f"(every 7th row {S4 + 1}), own token + shared partial ("
                 + yardstick.format(n=filled4) + ")",
    )

    # K7: the int4 decode write of one layer at the path's shapes, bit-exact
    # against its plain version at a low-plane slot and a high-plane slot.
    from_slot = {}
    for slot in (S4 // 2, S4 + 7):
        kv = [torch.randn(BATCH, hkv, 1, d, device=dev, generator=g).mul(2).to(torch.bfloat16)
              for _ in range(2)]
        bufs = [ck, cv, cks, cvs]
        plain = [t.clone() for t in bufs]
        decode.write_token_int4_cached(NL - 1, *kv, *bufs, slot)
        decode.write_token_int4_cached_plain(NL - 1, *kv, *plain, slot)
        exact = all(torch.equal(a, b) for a, b in zip(bufs, plain))

        def write(i):
            decode.write_token_int4_cached(i, *kv, *bufs, slot)

        ms = time_ms(Cycle(write, NL))
        dms = cuda_graph_time_ms(Cycle(write, NL))
        pms = time_ms(Cycle(lambda i: decode.write_token_int4_cached_plain(
            i, *kv, *plain, slot), NL), iters=5)
        plane = "high" if slot >= S4 else "low"
        from_slot[plane] = dict(exact=exact, ms=ms, device_ms=dms, plain_ms=pms)
        record(f"write_token_int4_cached slot {slot} ({plane} plane)", exact,
               f"bit-exact {exact} ms {ms:.4f} plain_ms {pms:.4f} device (graph) {dms:.4f}")
        del plain
    nbytes = 2 * kv[0].numel() * 2 + 2 * 2 * BATCH * hkv * d + 2 * BATCH * hkv * 4
    bms, by = bound_ms(nbytes, 0, "fp32")
    slots = from_slot.values()
    report["write_token_int4_cached"] = dict(
        max_abs_err=0.0 if all(r["exact"] for r in slots) else float("nan"),
        ms=max(r["ms"] for r in slots), device_ms=max(r["device_ms"] for r in slots),
        plain_ms=max(r["plain_ms"] for r in slots), bound_ms=bms, bound_by=by,
        library_ms=None, by_plane=from_slot,
        at="one layer's K and V token, b=256, 32 heads x 128, into 96 byte rows; the "
           "slower of a low-plane and a high-plane slot (device_ms: from a CUDA graph of "
           "the calls; library: none, no PyTorch call quantizes to int4 and merges nibbles)",
    )


def device_ms_by_kernel(fn, names, calls: int = 10) -> dict:
    """Device ms a ``fn()`` call spends in the kernels whose names contain
    each of ``names``, from torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(names, 0.0)
    for e in prof.events():
        key = next((k for k in names if k in e.name), None)
        if key and e.device_type == DeviceType.CUDA:
            ms[key] += e.time_range.elapsed_us() / 1e3 / calls
    return ms


def check_flash_shapes(report: dict, time_ms, g, record) -> None:
    """K2 and K4 at the other shapes the paths give them, each against its
    plain version (one kv head at a time where the plain scores would not
    fit), beside SDPA on the same bf16 work (``enable_gqa`` where grouped):
    K2 at the 8B decode read and at the 7B request-2 read, K4 at the 8B
    prefill and at the 7B suffix prefill. Nested under the 7B entries."""
    from hydragen_torch.ops import flash
    from hydragen_torch.ops.quant import dequantize_kv
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    F = torch.nn.functional
    d = 128

    def compare(name, o, lse, po, plse):
        err, rel = rel_err(o, po)
        fin = torch.isfinite(plse)
        lerr = float((lse[fin] - plse[fin]).abs().max()) if bool(fin.any()) else 0.0
        return err, rel, lerr, rel <= TOL_REL and lerr <= TOL_LSE

    def by_head(fn, q, hkv):
        """fn(q_h, h) over kv heads h (q_h the query heads of h), stacked."""
        group = q.shape[1] // hkv
        outs = [fn(q[:, h * group:(h + 1) * group], h) for h in range(hkv)]
        return torch.cat([o for o, _ in outs], 1), torch.cat([lse for _, lse in outs], 1)

    # K2: one layer of an int8 level, S = 2,048, read in place.
    for key, hq, hkv, m in (("llama_3_8b_decode", 32, 8, BATCH),
                            ("request2_read", 32, 32, BATCH * SUFFIX_LEN)):
        NL = 3
        shape = (NL, 1, hkv, SHARED_LEN, d)
        lk, lv = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
                  for _ in range(2))
        lks, lvs = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
                    for _ in range(2))
        lens = torch.full((1,), SHARED_LEN, dtype=torch.int32, device=dev)
        q = torch.randn(1, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
        kw = dict(kv_seq_lens=lens, k_scale_all=lks, v_scale_all=lvs)
        o, lse = flash.flash_attention_cached_bhsd(NL - 1, q, lk, lv, **kw)

        def plain(i):
            return by_head(lambda qh, h: flash.flash_attention_cached_plain(
                i, qh, lk[:, :, h:h + 1], lv[:, :, h:h + 1], kv_seq_lens=lens,
                k_scale_all=lks[:, :, h:h + 1], v_scale_all=lvs[:, :, h:h + 1]), q, hkv)
        err, rel, lerr, ok = compare(key, o, lse, *plain(NL - 1))
        ms = time_ms(Cycle(lambda i: flash.flash_attention_cached_bhsd(i, q, lk, lv, **kw), NL))
        pms = time_ms(Cycle(plain, NL), iters=2, warmup=1)
        kdq = dequantize_kv(lk[:, 0], lks[:, 0]).to(torch.bfloat16)[:, None]
        vdq = dequantize_kv(lv[:, 0], lvs[:, 0]).to(torch.bfloat16)[:, None]
        lms = time_ms(Cycle(lambda i: F.scaled_dot_product_attention(
            q, kdq[i], vdq[i], enable_gqa=hq != hkv), NL))
        dms = cuda_graph_time_ms(Cycle(
            lambda i: flash.flash_attention_cached_bhsd(i, q, lk, lv, **kw), NL))
        ldms = cuda_graph_time_ms(Cycle(lambda i: F.scaled_dot_product_attention(
            q, kdq[i], vdq[i], enable_gqa=hq != hkv), NL))
        nbytes = 2 * q.numel() * 2 + 2 * hkv * SHARED_LEN * (d + 4) + hq * m * 4
        bms, by = bound_ms(nbytes, 4 * hq * m * SHARED_LEN * d, "bf16")
        splits, chunk = flash.flash_plan(
            hkv, hq // hkv * m, SHARED_LEN,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        record(f"flash_attention_cached_bhsd {key}: hkv={hkv} M={hq // hkv * m} S={SHARED_LEN} "
               f"int8, {splits} KV splits of {chunk}", ok,
               f"max_abs_err {err:.4g} rel {rel:.3g} lse_err {lerr:.3g} ms {ms:.4f} plain_ms "
               f"{pms:.4f} sdpa_ms {lms:.4f} bound_ms {bms:.4f}; device (graph) {dms:.4f}, "
               f"sdpa {ldms:.4f} ms")
        report["flash_attention_cached_bhsd"][key] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms,
            device_ms=dms, library_device_ms=ldms,
            at=f"hkv={hkv}, {hq // hkv * m} folded rows, S={SHARED_LEN} int8, KV splits "
               f"{splits} (library: SDPA on bf16 dequantized k/v"
               f"{', enable_gqa' if hq != hkv else ''}; plain: one kv head at a time)")
        del lk, lv, lks, lvs, q, o, lse, kdq, vdq

    # K4: causal bf16 prefills.
    for key, b, hq, hkv, m in (("llama_3_8b_prefill", 1, 32, 8, SHARED_LEN),
                               ("suffix_prefill", BATCH, 32, 32, SUFFIX_LEN)):
        q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, m, d, device=dev, generator=g).to(torch.bfloat16)
                for _ in range(2))
        o, lse = flash.flash_attention_bhsd(q, k, v, causal=True)

        def plain():
            return by_head(lambda qh, h: flash.flash_attention_bhsd_plain(
                qh, k[:, h:h + 1], v[:, h:h + 1], causal=True), q, hkv)
        err, rel, lerr, ok = compare(key, o, lse, *plain())
        ms = time_ms(lambda: flash.flash_attention_bhsd(q, k, v, causal=True))
        pms = time_ms(plain, iters=2, warmup=1)
        lms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=hq != hkv))
        dms = cuda_graph_time_ms(lambda: flash.flash_attention_bhsd(q, k, v, causal=True))
        ldms = cuda_graph_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=hq != hkv))
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + b * hq * m * 4
        bms, by = bound_ms(nbytes, 4 * b * hq * d * m * (m + 1) // 2, "bf16")
        record(f"flash_attention_bhsd causal {key}: b={b} hq={hq} hkv={hkv} q_len=S={m}", ok,
               f"max_abs_err {err:.4g} rel {rel:.3g} lse_err {lerr:.3g} ms {ms:.4f} plain_ms "
               f"{pms:.4f} sdpa_ms {lms:.4f} bound_ms {bms:.4f}; device (graph) {dms:.4f}, "
               f"sdpa {ldms:.4f} ms")
        report["flash_attention_bhsd"][key] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms,
            device_ms=dms, library_device_ms=ldms,
            at=f"causal, b={b}, {hq} query heads over {hkv} kv heads, q_len=S={m}, bf16 "
               f"(library: SDPA is_causal{', enable_gqa' if hq != hkv else ''}; plain: one kv "
               "head at a time)")
        del q, k, v, o, lse


def check_gqa_kernels(report: dict, failures: list, time_ms, g, record) -> None:
    """K5 at the GQA phases' shapes, and K1 at Llama-3-8B's decode shapes."""
    from hydragen_torch.ops import flash, gemm
    from hydragen_torch.ops.quant import dequantize_kv
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    F = torch.nn.functional
    hq, hkv, d = 32, 8, 128

    def k5_case(tag, b, window, alloc, filled, int8, NL, zero_row=None, split=False):
        """K5 on one layer's view [:, :, :window] of an [NL, b, hkv, alloc, d]
        buffer (strided when alloc > window), ``filled`` keys a row; ``split``:
        a shape whose keys split, timed kernel by kernel too."""
        shape = (NL, b, hkv, alloc, d)
        if int8:
            kc, vc = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
                      for _ in range(2))
            ksc, vsc = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
                        for _ in range(2))
        else:
            kc, vc = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                      for _ in range(2))
        q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
        lens = torch.full((b,), filled, dtype=torch.int32, device=dev)
        if zero_row is not None:
            lens[zero_row] = 0

        def args(i):
            kw = dict(kv_seq_lens=lens)
            if int8:
                kw.update(k_scale=ksc[i, :, :, :window], v_scale=vsc[i, :, :, :window])
            return (q, kc[i, :, :, :window], vc[i, :, :, :window]), kw

        a, kw = args(NL - 1)
        o, lse = flash.flash_attention_bhsd(*a, **kw)
        po, plse = flash.flash_attention_bhsd_plain(*a, **kw)
        err, rel = rel_err(o, po)
        fin = torch.isfinite(plse)
        lerr = float((lse[fin] - plse[fin]).abs().max())
        empty_ok = bool(torch.isneginf(lse[~fin]).all()) and bool((o[~fin] == 0).all())
        ms = time_ms(Cycle(lambda i: flash.flash_attention_bhsd(*args(i)[0], **args(i)[1]), NL))
        pms = time_ms(Cycle(lambda i: flash.flash_attention_bhsd_plain(*args(i)[0],
                                                                       **args(i)[1]), NL),
                      iters=5)
        # Library: SDPA with enable_gqa on the same bf16 work (the written
        # keys, dequantized), which returns no LSE.
        if int8:
            kdq = [dequantize_kv(kc[i, :, :, :filled], ksc[i, :, :, :filled]).to(torch.bfloat16)
                   for i in range(NL)]
            vdq = [dequantize_kv(vc[i, :, :, :filled], vsc[i, :, :, :filled]).to(torch.bfloat16)
                   for i in range(NL)]
        else:
            kdq = [kc[i, :, :, :filled].contiguous() for i in range(NL)]
            vdq = [vc[i, :, :, :filled].contiguous() for i in range(NL)]
        lms = time_ms(Cycle(lambda i: F.scaled_dot_product_attention(q, kdq[i], vdq[i],
                                                                     enable_gqa=True), NL))
        # Device time with no host work between calls (a CUDA graph of them):
        # at these shapes the wrapper's host time is about the kernel's.
        dms = cuda_graph_time_ms(Cycle(
            lambda i: flash.flash_attention_bhsd(*args(i)[0], **args(i)[1]), NL))
        ldms = cuda_graph_time_ms(Cycle(lambda i: F.scaled_dot_product_attention(
            q, kdq[i], vdq[i], enable_gqa=True), NL))
        # Where the keys split, the device time of each of the two kernels.
        parts = {}
        if split:
            parts = device_ms_by_kernel(Cycle(
                lambda i: flash.flash_attention_bhsd(*args(i)[0], **args(i)[1]), NL),
                ("flash_decode_kernel", "split_combine"))
        tokens = int(lens.sum())
        per_key = d + 4 if int8 else 2 * d
        nbytes = 2 * q.numel() * 2 + b * hq * 4 + 2 * tokens * hkv * per_key
        bms, by = bound_ms(nbytes, 4 * hq * d * tokens, "bf16")
        ok = rel <= TOL_REL and lerr <= TOL_LSE and empty_ok
        record(f"flash_decode_bhsd {tag}: b={b} hkv={hkv} M=4 {'int8' if int8 else 'bf16'} "
               f"{filled} of {window} keys{' (strided)' if alloc > window else ''}", ok,
               f"max_abs_err {err:.4g} rel {rel:.3g} lse_err {lerr:.3g} empty rows ok "
               f"{empty_ok} ms {ms:.4f} plain_ms {pms:.4f} sdpa_ms {lms:.4f} bound_ms {bms:.4f}; "
               f"device (graph) {dms:.4f}, sdpa {ldms:.4f} ms"
               + "".join(f"; {k} {v:.4f} ms (profiler)" for k, v in parts.items()))
        return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                    library_ms=lms, device_ms=dms, library_device_ms=ldms,
                    **{f"{k}_device_ms": v for k, v in parts.items()})

    window = SUFFIX_LEN + NEW_TOKENS  # 192 slots, 191 written at the last step
    path = k5_case("gqa", BATCH, window, window + 8, window - 1, True, 4, zero_row=5)
    nosh_window = -(-(NEW_TOKENS + SHARED_LEN + 8) // 16) * 16
    nosh = k5_case("no-sharing", BATCH, nosh_window, nosh_window,
                   SHARED_LEN + NEW_TOKENS - 1, True, 2)
    split8 = k5_case("split", 1, 32768, 32768, 32768, True, 2, split=True)
    split16 = k5_case("split", 1, 32768, 32768, 32768 - 100, False, 2, split=True)
    report["flash_decode_bhsd"] = dict(
        **path,
        at=f"the gqa path's unique read of one decode layer: b=256, hkv 8, M=4, {window - 1} "
           f"of a {window}-slot int8 window, strided views, one row of length 0 (library: "
           "SDPA enable_gqa on the written keys dequantized to bf16, no LSE; device_ms: "
           "from a CUDA graph of the calls, SDPA's likewise)",
        no_sharing=dict(nosh, at=f"b=256, hkv 8, {SHARED_LEN + NEW_TOKENS - 1} of "
                                 f"{nosh_window} int8 keys"),
        split=dict(split8, at="b=1, hkv 8, 32,768 int8 keys, 64 splits of 512 (*_device_ms "
                              "by kernel: torch.profiler)"),
        split_bf16=dict(split16, at="b=1, hkv 8, 32,668 of 32,768 bf16 keys, 32 splits of "
                                    "1,024"),
    )

    # K1 at Llama-3-8B's decode shapes (one layer's 7 projections, M = 256)
    # and its shared prefill's (M = 2,048), each also bit-exact against the
    # scaled torch._int_mm product.
    NL, I8 = 4, 14336
    shapes = {"q_o": (4096, 4096, 2), "k_v": (hkv * d, 4096, 2), "gate_up": (I8, 4096, 2),
              "down": (4096, I8, 1)}
    layer = dict(ms=0.0, device_ms=0.0, int_mm_device_ms=0.0, bytes=0, ops=0)
    k1_shapes = {}
    for key, (N, K, n) in shapes.items():
        w = torch.randint(-127, 128, (NL, N, K), dtype=torch.int8, device=dev, generator=g)
        ws = (torch.rand(NL, N, device=dev, generator=g) * 2e-3 + 1e-4).to(torch.bfloat16)
        wt = w.transpose(1, 2).contiguous()
        for M in (BATCH, SHARED_LEN):
            a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
            out = gemm.w8a8_matmul_cached(NL - 1, a_q, a_s, w, ws)
            ref = gemm.w8a8_cached_plain(NL - 1, a_q, a_s, w, ws, out_dtype=torch.float32)
            err, rel = rel_err(out, ref)
            exact = torch.equal(out, int_mm_oracle(a_q, a_s, wt[NL - 1], ws[NL - 1]))
            ms = time_ms(Cycle(lambda i: gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws), NL))
            dms = cuda_graph_time_ms(Cycle(
                lambda i: gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws), NL))
            ldms = cuda_graph_time_ms(Cycle(lambda i: torch._int_mm(a_q, wt[i]), NL))
            nbytes = M * K + M * 4 + N * K + N * 2 + M * N * 2
            ops = 2 * M * N * K
            bms, by = bound_ms(nbytes, ops, "int8")
            plan = gemm_plan_of(gemm, M, N, K)
            record(f"w8a8_matmul_cached llama-3-8b {key} M={M} N={N} K={K}",
                   rel <= TOL_REL and exact,
                   f"max_abs_err {err:.4g} rel {rel:.3g} (tol {TOL_REL}) bit-exact vs int_mm "
                   f"{exact} ms {ms:.4f} device_ms {dms:.4f} int_mm_device_ms {ldms:.4f} "
                   f"bound_ms {bms:.4f} ({by}) device TOP/s {ops / dms / 1e9:.1f} plan {plan}")
            k1_shapes[f"M={M} N={N} K={K}"] = dict(
                max_abs_err=err, bit_exact=exact, ms=ms, device_ms=dms, int_mm_device_ms=ldms,
                bound_ms=bms, bound_by=by, device_top_s=ops / dms / 1e9, plan=plan)
            if M == BATCH:
                for field, v in (("ms", ms), ("device_ms", dms), ("int_mm_device_ms", ldms),
                                 ("bytes", nbytes), ("ops", ops)):
                    layer[field] += n * v
            del a_q, a_s, out, ref
        del w, ws, wt
    bms, by = bound_ms(layer["bytes"], layer["ops"], "int8")
    report["w8a8_matmul_cached"]["llama_3_8b"] = dict(
        ms=layer["ms"], device_ms=layer["device_ms"],
        int_mm_device_ms=layer["int_mm_device_ms"], bound_ms=bms, bound_by=by,
        shapes=k1_shapes, at="sum of one Llama-3-8B decode layer's 7 projections, M=256")


def expected_launches(L: int, T: int) -> dict:
    """Launches the two main-path requests imply, for L layers and T new
    tokens each (the first token of a request comes from its prefill):
    - request 1: a shared prefill (7L GEMMs, L causal flash) and T-1 decode
      steps (7L GEMMs, L level reads, L unique reads each);
    - request 2: a unique prefill over the kept level (7L GEMMs, L level
      reads, L causal flash over the suffixes) and T-1 decode steps."""
    return {
        "w8a8_matmul_cached": 2 * 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1) + L * T,
        "decode_attention_cached": 2 * L * (T - 1),
        "flash_attention_bhsd": 2 * L,
    }


def expected_launches_int4(L: int, T: int) -> dict:
    """The same two requests on the int4 path: every projection on the w4a8
    GEMM (the LM head stays weight-only int8), the int8 shared level read by
    K2, the unique read by K3 at kv_bits=4, and each decode layer's K and V
    token written by one int4 write launch (the in-place decode path writes
    each layer right after its read), T-1 steps a request."""
    return {
        "w4a8_matmul_cached": 2 * 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1) + L * T,
        "decode_attention_cached_int4": 2 * L * (T - 1),
        "write_token_int4_cached": 2 * L * (T - 1),
        "flash_attention_bhsd": 2 * L,
    }


def expected_launches_gqa(L: int, T: int) -> dict:
    """The same two requests on Llama-3-8B (GQA, w8a8 + int8 KV). Its unique
    cache is BHSD, which the decode kernel does not read, so each decode
    layer's unique read is the small-M read (K5, M = 4 folded rows) in place
    of K3: 2L(T-1) launches, one a layer a step, and 0 of K3. The prefills
    are as on the main path: the causal flash calls have M = 4 x 2,048 and
    4 x 128 folded rows, so they stay on K2's kernel (K4)."""
    return {
        "w8a8_matmul_cached": 2 * 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1) + L * T,
        "flash_decode_bhsd": 2 * L * (T - 1),
        "flash_attention_bhsd": 2 * L,
    }


def expected_launches_no_sharing(L: int, T: int) -> dict:
    """The no-sharing baseline's one request (``bench.py:70-96``): the
    prompt is the unique rows' prefill (7L GEMMs, L causal flash at 2,048
    tokens), repeated into every row; then T-1 decode steps, each layer
    reading its row's whole history (prompt copy and decoded tokens) with
    one small-M read and no level read."""
    return {
        "w8a8_matmul_cached": 7 * L * T,
        "flash_decode_bhsd": L * (T - 1),
        "flash_attention_bhsd": L,
    }


# name: (tag, preset, quantization, kv_quant, expected launches, profile groups)
PATHS = {
    "main": ("main", "llama-2-7b", "w8a8", "int8", expected_launches,
             ("w8a8_kernel", "flash_kernel", "split_combine", "decode_kernel")),
    "int4": ("int4", "llama-2-7b", "w4a8", "int4", expected_launches_int4,
             ("w4a8_kernel", "flash_kernel", "split_combine", "decode_kernel",
              "write_int4_kernel")),
    "gqa": ("gqa", "llama-3-8b", "w8a8", "int8", expected_launches_gqa,
            ("w8a8_kernel", "flash_decode_kernel", "flash_kernel", "split_combine")),
}


def time_decode_loop(eng):
    """Time the engine's decode loop apart from the prefills: each call of
    ``eng._decode_steps``, fenced by synchronizes, adds its seconds to the
    returned one-element list. Returns (the unwrapped loop, that list)."""
    decode_steps, decode_s = eng._decode_steps, [0.0]

    def timed_decode(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_steps(*a, **kw)
        torch.cuda.synchronize()
        decode_s[0] += time.perf_counter() - t
        return out

    eng._decode_steps = timed_decode
    return decode_steps, decode_s


def drive_path(args, failures: list, path: str) -> dict:
    """Drive one configuration's two requests at full width and depth with
    the counts set to 0 just before and read just after; then profile 8
    decode steps. Returns the launch counts of the two requests."""
    from hydragen_torch import HydragenLlama, SharedCacheOp
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params
    from hydragen_torch.ops import cuda_lib, gemm

    tag, preset, quant, kv_quant, expected, groups = PATHS[path]
    cfg = PRESETS[preset]
    T = NEW_TOKENS
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    params = init_params(cfg, g, quantized=quant, device="cuda")
    eng = HydragenLlama(cfg, params, quantization=quant)
    eng.setup_caches(BATCH, SUFFIX_LEN + T, [1], [SHARED_LEN], kv_quant=kv_quant)
    prompt = torch.randint(1, cfg.vocab_size, (1, SHARED_LEN), generator=g, device="cuda")
    suffixes = torch.randint(1, cfg.vocab_size, (BATCH, SUFFIX_LEN), generator=g,
                             device="cuda")
    torch.cuda.synchronize()
    print(f"[{tag}] {preset} width, {cfg.num_hidden_layers} layers, {quant} + {kv_quant} "
          f"KV: set-up {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)

    decode_steps, decode_s = time_decode_loop(eng)
    stats = {}
    encodes = gemm.map_encodes()
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks1, logits1 = eng.generate(
        input_ids=[prompt], num_return_sequences=BATCH, max_new_tokens=T, temperature=0.0,
        shared_cache_op=SharedCacheOp.WIPE, return_logits=True, seed=args.seed,
    )
    torch.cuda.synchronize()
    stats["request1_s"] = time.perf_counter() - t
    stats["request1_decode_s"] = decode_s[0]
    t = time.perf_counter()
    toks2 = eng.generate(
        input_ids=[suffixes], num_return_sequences=1, max_new_tokens=T, temperature=0.0,
        shared_cache_op=SharedCacheOp.PRESERVE, seed=args.seed,
    )
    torch.cuda.synchronize()
    stats["request2_s"] = time.perf_counter() - t
    stats["request2_decode_s"] = decode_s[0] - stats["request1_decode_s"]
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    stats["k1_map_encodes"] = gemm.map_encodes() - encodes

    decoded = BATCH * (T - 1)
    stats["decode_tok_s_request1"] = decoded / stats["request1_decode_s"]
    stats["decode_tok_s_request2"] = decoded / stats["request2_decode_s"]
    stats["decode_ms_per_step"] = 1e3 * decode_s[0] / (2 * (T - 1))
    print(f"[{tag}] {json.dumps(stats)}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    want = expected(cfg.num_hidden_layers, T)
    if launches != want:
        failures.append(f"{tag} path launches {launches} != expected {want}")
    for name, toks in (("request 1", toks1), ("request 2", toks2)):
        ok = (tuple(toks.shape) == (BATCH, T) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size)
        print(f"[{tag}] {name} tokens {tuple(toks.shape)} in range: {ok}", flush=True)
        if not ok:
            failures.append(f"{tag} path {name}: tokens {tuple(toks.shape)} out of range")
    finite = all(bool(torch.isfinite(x).all()) for x in logits1)
    if not finite or len(logits1) != T:
        failures.append(f"{tag} path: {len(logits1)} logit steps, finite={finite}")
    print(f"[{tag}] request 1: {len(logits1)} logit steps, all finite: {finite}", flush=True)
    del logits1
    profile_decode(eng, decode_steps, lambda: eng.generate(
        input_ids=[suffixes], num_return_sequences=1, max_new_tokens=PROFILE_STEPS + 1,
        temperature=0.0, shared_cache_op=SharedCacheOp.PRESERVE), tag, groups, failures)
    return launches


def profile_decode(eng, decode_steps, request, tag: str, names, failures: list) -> None:
    """One more request (``request()``, PROFILE_STEPS decode steps), its
    decode loop under torch.profiler: device-busy share of the loop's wall
    time and the kernels by device time, grouped by the kernel ``names``
    (the rest is "other"). The profiler's own host cost lengthens the wall
    time, so the idle share read here is an upper bound. Fails if any copy
    op in the loop reads half a layer of the unique cache or more: every
    kernel reads the cache in place. The full table goes to
    chiprun_out/profile_decode.txt (main path) or profile_decode_<tag>.txt."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = PROFILE_STEPS
    window = {}

    def profiled(*a, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t = time.perf_counter()
            out = decode_steps(*a, **kw)
            torch.cuda.synchronize()
            window["wall_us"] = (time.perf_counter() - t) * 1e6
        window["prof"] = prof
        return out

    eng._decode_steps = profiled
    request()
    prof, wall = window["prof"], window["wall_us"]
    layer = eng.cache.unique_k[0]
    copies = [e for e in prof.events()
              if e.name in ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy")
              and any(len(s) >= 3 and tuple(s[-3:]) == layer.shape[-3:]
                      and math.prod(s) * 2 >= layer.numel() for s in e.input_shapes)]
    print(f"[profile {tag}] copies of half a unique-cache layer (a view of "
          f"{tuple(layer.shape)}) or more in {steps} decode steps: {len(copies)}", flush=True)
    if copies:
        failures.append(f"{tag} decode copies the unique cache: "
                        f"{[(e.name, e.input_shapes) for e in copies[:4]]}")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    groups = defaultdict(float)
    for name, (us, _) in by_name.items():
        key = next((k for k in names if k in name), "other")
        groups[key] += us
    print(f"[profile {tag}] {steps} decode steps: wall {wall / steps / 1e3:.3f} ms/step, device "
          f"busy {busy / steps / 1e3:.3f} ms/step, idle share {1 - busy / wall:.4f}, "
          f"{len(kernels) / steps:.0f} kernels/step", flush=True)
    print(f"[profile {tag}] device ms/step by kernel: " + json.dumps(
        {k: round(v / steps / 1e3, 4) for k, v in sorted(groups.items(), key=lambda x: -x[1])}),
        flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:12]:
        print(f"[profile {tag}]   {us / steps / 1e3:8.4f} ms/step {n / steps:6.1f}x  "
              f"{name[:90]}",
              flush=True)
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    (out / ("profile_decode.txt" if tag == "main" else f"profile_decode_{tag}.txt")
     ).write_text(table)


def drive_no_sharing(args, failures: list) -> dict:
    """The no-sharing baseline against Hydragen on Llama-3-8B, one engine,
    ``bench.py:70-96``'s protocol: Hydragen first (``setup_caches(256, 64,
    [1], [2048])``), then the baseline (``setup_caches(256, 64 + 2,048 + 8,
    [1], [2048])``, ``disable_hydragen=True``), each one request of a
    2,048-token prompt with 256 greedy completions of 64 tokens (WIPE). The
    baseline's launches are counted; its tokens must equal Hydragen's. Where
    a bf16 tie breaks the other way, the baseline is run again on Hydragen's
    tokens (``token_overrides``) and its logits must stay within TOL_NOSHARE
    of Hydragen's at every step. Then 8 decode steps of the baseline are
    profiled. Returns the baseline request's launch counts."""
    from hydragen_torch import HydragenLlama, SharedCacheOp
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.utils.capacity import kv_cache_bytes

    tag, cfg, T = "gqa no-sharing", PRESETS["llama-3-8b"], NEW_TOKENS
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    eng = HydragenLlama(cfg, init_params(cfg, g, quantized="w8a8", device="cuda"),
                        quantization="w8a8")
    prompt = torch.randint(1, cfg.vocab_size, (1, SHARED_LEN), generator=g, device="cuda")
    decode_steps, decode_s = time_decode_loop(eng)
    kw = dict(input_ids=[prompt], num_return_sequences=BATCH, max_new_tokens=T,
              temperature=0.0, shared_cache_op=SharedCacheOp.WIPE, seed=args.seed)
    stats = {}
    runs = {}
    for name, unique_len, nohydra in (("hydragen", T, False),
                                      ("no-sharing", T + SHARED_LEN + 8, True)):
        eng.cache = None
        gc.collect()
        torch.cuda.empty_cache()
        eng.setup_caches(BATCH, unique_len, [1], [SHARED_LEN], kv_quant="int8")
        torch.cuda.synchronize()
        print(f"[{tag}] {name}: cache {kv_cache_bytes(cfg, BATCH, unique_len, [1], [SHARED_LEN], 'int8') / 1e9:.3f} GB, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
        decode_s[0] = 0.0
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        toks = eng.generate(disable_hydragen=nohydra, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[name] = (toks, {k: v for k, v in cuda_lib.LAUNCHES.items() if v})
        stats[name] = dict(request_s=wall, decode_s=decode_s[0],
                           decode_tok_s=BATCH * (T - 1) / decode_s[0],
                           peak_GiB=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[{tag}] {json.dumps(stats)}", flush=True)
    print(f"[{tag}] hydragen / no-sharing decode rate: "
          f"{stats['hydragen']['decode_tok_s'] / stats['no-sharing']['decode_tok_s']:.3f}",
          flush=True)
    launches = runs["no-sharing"][1]
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    want = expected_launches_no_sharing(cfg.num_hidden_layers, T)
    if launches != want:
        failures.append(f"{tag} launches {launches} != expected {want}")
    th, tn = runs["hydragen"][0], runs["no-sharing"][0]
    ok = tuple(tn.shape) == (BATCH, T) and bool((tn == tn[:1]).all())
    same = bool(torch.equal(th, tn))
    print(f"[{tag}] tokens {tuple(tn.shape)}, rows alike {ok}, equal to Hydragen's: {same}",
          flush=True)
    if not ok:
        failures.append(f"{tag}: tokens {tuple(tn.shape)}, rows differ")
    if not same:
        # Both runs on Hydragen's tokens: the logits of row 0 (rows alike).
        logits = {}
        for name, unique_len, nohydra in (("hydragen", T, False),
                                          ("no-sharing", T + SHARED_LEN + 8, True)):
            eng.cache = None
            gc.collect()
            torch.cuda.empty_cache()
            eng.setup_caches(BATCH, unique_len, [1], [SHARED_LEN], kv_quant="int8")
            _, lg = eng.generate(disable_hydragen=nohydra, token_overrides=th,
                                 return_logits=True, **kw)
            logits[name] = [x[0].float() for x in lg]
            del lg
        worst = 0.0
        for step, (a, b) in enumerate(zip(logits["no-sharing"], logits["hydragen"])):
            r = rms_rel(a, b)
            worst = max(worst, r)
            print(f"[{tag}]   forced step {step}: rms distance {r:.4g}, argmax equal "
                  f"{bool(a.argmax() == b.argmax())}", flush=True)
        print(f"[{tag}] forced stream: largest rms distance {worst:.4g} (tol {TOL_NOSHARE})",
              flush=True)
        if worst > TOL_NOSHARE:
            failures.append(f"{tag}: forced-stream logits {worst:.4g} from Hydragen's > "
                            f"{TOL_NOSHARE}")
    eng._decode_steps = decode_steps  # the last set-up is the baseline's cache
    profile_decode(eng, decode_steps, lambda: eng.generate(
        disable_hydragen=True, **dict(kw, max_new_tokens=PROFILE_STEPS + 1)), "gqa_nosharing",
        ("flash_decode_kernel", "w8a8_kernel", "flash_kernel"), failures)
    return launches


@contextlib.contextmanager
def only_kernel(keep: str | None):
    """Within the block, every kernel wrapper but ``keep`` is replaced by its
    plain version (module attributes, which the model reads at call time);
    ``keep=None`` leaves them all on the kernel."""
    from hydragen_torch.ops import decode, flash, gemm

    # launch key: (module, the attribute the model calls, its plain version);
    # flash_attention_bhsd routes to K2's kernel or to K5 by the two private
    # launchers, swapped apart.
    swaps = {
        "w8a8_matmul_cached": (gemm, "w8a8_matmul_cached", gemm.w8a8_cached_plain),
        "w4a8_matmul_cached": (gemm, "w4a8_matmul_cached", gemm.w4a8_cached_plain),
        "flash_attention_cached_bhsd": (flash, "flash_attention_cached_bhsd",
                                        flash.flash_attention_cached_plain),
        "decode_attention_cached": (decode, "decode_attention_cached",
                                    decode.decode_attention_cached_plain),
        "flash_attention_bhsd": (flash, "_flash_bhsd", flash.flash_attention_bhsd_plain),
        "flash_decode_bhsd": (flash, "_flash_decode_bhsd", flash.flash_attention_bhsd_plain),
        "write_token_int4_cached": (decode, "write_token_int4_cached",
                                    decode.write_token_int4_cached_plain),
    }
    saved = []
    for name, (mod, attr, plain) in swaps.items():
        if keep is not None and name != keep:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def rms_rel(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).norm() / ref.norm().clamp_min(1e-6))


# The configurations of the plain-path check: preset, quantization, kv_quant
# and the kernels run alone (K3 reads int4 in the int4 configuration; the GQA
# configuration's unique read is K5).
PLAIN_PATHS = {
    "w8a8": ("llama-2-7b", "w8a8", "int8",
             ("w8a8_matmul_cached", "flash_attention_cached_bhsd", "decode_attention_cached",
              "flash_attention_bhsd")),
    "int4": ("llama-2-7b", "w4a8", "int4", ("w4a8_matmul_cached", "decode_attention_cached",
                                            "write_token_int4_cached")),
    "gqa": ("llama-3-8b", "w8a8", "int8", ("w8a8_matmul_cached", "flash_attention_cached_bhsd",
                                           "flash_decode_bhsd", "flash_attention_bhsd")),
}


def check_plain_path(args, failures: list, path: str) -> None:
    """The kernel path against impl="torch" at 2 layers of full width, on
    one forced token stream, so all runs read the same tokens.

    "w8a8" (Llama-2-7B) and "gqa" (Llama-3-8B, whose BHSD unique cache is
    read by K5): one request, a 2,048-token shared prompt and 256 rows, 3
    forced steps. "int4": the same prompt prefilled by a first request, then 256
    7-token suffixes over it and 4 forced steps: the 16-token unique window
    has S = 8 byte rows, the suffix prefill (padded to the window) packs
    both planes, and decode writes slot 7 (low plane) then 8 and 9 (high
    plane) and reads lengths 7, 8 and 9, on both sides of S.

    The bf16 runs drift from one another by more than any one kernel's
    rounding: each per-row int8 quantization of an activation turns a
    last-bit difference upstream into a whole code. The yardstick is
    therefore the plain path in fp32 over the same quantized weights and KV.
    Each bf16 kernel run (all kernels, and each kernel alone with the others
    on their plain versions) must come as close to it as the plain bf16 run
    does: its RMS distance within TOL_RMS times the plain run's, its largest
    distance within TOL_MAX times. A wrong kernel shows in its own swap
    run."""
    from hydragen_torch import HydragenLlama, SharedCacheOp
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params

    preset, quant, kv_quant, kernels = PLAIN_PATHS[path]
    tag = f"plain {path}"
    cfg = dataclasses.replace(PRESETS[preset], num_hidden_layers=2)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    params = init_params(cfg, g, quantized=quant, device="cuda")
    prompt = torch.randint(1, cfg.vocab_size, (1, SHARED_LEN), generator=g, device="cuda")
    suffixes = torch.randint(1, cfg.vocab_size, (BATCH, 7), generator=g, device="cuda")
    steps = 4 if path == "int4" else 3
    forced = torch.randint(1, cfg.vocab_size, (BATCH, steps), generator=g, device="cuda")

    def fp32(tree):  # quantized payloads and their bf16 scales stay as they are
        if isinstance(tree, dict):
            return {k: fp32(v) for k, v in tree.items()}
        return tree if isinstance(tree, tuple) else tree.float()

    runs = {
        "fp32": (dataclasses.replace(cfg, dtype="float32"), fp32(params), "torch", None),
        "plain": (cfg, params, "torch", None),
        "kernel": (cfg, params, None, None),
        **{f"only {k}": (cfg, params, None, k) for k in kernels},
    }
    kw = dict(temperature=0.0, return_logits=True, token_overrides=forced)
    logits = {}
    for name, (c, p, impl, keep) in runs.items():
        eng = HydragenLlama(c, p, impl=impl, quantization=quant)
        eng.setup_caches(BATCH, 16, [1], [SHARED_LEN], kv_quant=kv_quant)
        with only_kernel(keep):
            if path != "int4":
                _, lg = eng.generate(input_ids=[prompt], num_return_sequences=BATCH,
                                     max_new_tokens=steps,
                                     shared_cache_op=SharedCacheOp.WIPE, **kw)
            else:
                eng.generate(input_ids=[prompt], num_return_sequences=BATCH,
                             max_new_tokens=1, temperature=0.0,
                             shared_cache_op=SharedCacheOp.WIPE)
                _, lg = eng.generate(input_ids=[suffixes], max_new_tokens=steps,
                                     shared_cache_op=SharedCacheOp.PRESERVE, **kw)
        logits[name] = [x.float() for x in lg]
        del eng, lg
    for step in range(steps):
        ref = logits["fp32"][step]
        p_rms, (_, p_max) = rms_rel(logits["plain"][step], ref), rel_err(
            logits["plain"][step], ref)
        print(f"[{tag}] 2-layer logits step {step}: plain bf16 vs fp32 rms {p_rms:.4g} "
              f"max {p_max:.4g}", flush=True)
        for name in ("kernel", *(f"only {k}" for k in kernels)):
            out = logits[name][step]
            k_rms, (_, k_max) = rms_rel(out, ref), rel_err(out, ref)
            agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
            ok = (k_rms <= TOL_RMS * p_rms and k_max <= TOL_MAX * p_max
                  and bool(torch.isfinite(out).all()))
            print(f"[{tag}]   {name} vs fp32: rms {k_rms:.4g} ({k_rms / p_rms:.3f} x plain, "
                  f"tol {TOL_RMS}) max {k_max:.4g} ({k_max / p_max:.3f} x, tol {TOL_MAX}) "
                  f"argmax agreement {agree:.4f} -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"{tag} logits step {step}, {name}: rms {k_rms:.4g} / "
                                f"max {k_max:.4g} against plain bf16's {p_rms:.4g} / "
                                f"{p_max:.4g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and prompts")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    # Run from anywhere: the package is the checkout this script sits in.
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from hydragen_torch.ops import cuda_lib
        from hydragen_torch.utils.timing import cuda_time_ms
    except ModuleNotFoundError as e:
        print(f"chip_smoke: {e}: run this script from the root of a checkout of the port",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)

    failures: list[str] = []
    t = time.perf_counter()
    seconds = cuda_lib.build()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"wall {time.perf_counter() - t:.2f} s into {cuda_lib.build_dir()}", flush=True)
    print_ptxas(cuda_lib.BUILD_LOG)

    report: dict = {}
    launches: dict = {"main": {}, "int4": {}, "gqa": {}, "gqa no-sharing": {}}
    phases = (
        ("kernels", lambda: check_kernels(report, failures, cuda_time_ms)),
        ("main path", lambda: launches["main"].update(drive_path(args, failures, "main"))),
        ("int4 path", lambda: launches["int4"].update(drive_path(args, failures, "int4"))),
        ("gqa path", lambda: launches["gqa"].update(drive_path(args, failures, "gqa"))),
        ("gqa no-sharing", lambda: launches["gqa no-sharing"].update(
            drive_no_sharing(args, failures))),
        ("plain path", lambda: check_plain_path(args, failures, "w8a8")),
        ("plain path int4", lambda: check_plain_path(args, failures, "int4")),
        ("plain path gqa", lambda: check_plain_path(args, failures, "gqa")),
    )
    for name, phase in phases:
        t = time.perf_counter()
        try:
            phase()
        except Exception:  # a failed phase fails the run; the others still report
            traceback.print_exc()
            failures.append(f"phase {name} raised")
        # A phase's engine is freed before the next one starts: its timing
        # wrappers make a reference cycle that only the collector breaks.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[phase] {name}: {time.perf_counter() - t:.1f} s", flush=True)

    # name: (source, TPU call site, the path whose launches it reports: None
    # for an entry neither path reaches)
    sources = {
        "w8a8_matmul_cached": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:222", "main"),
        "w8a8_matmul": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:118", None),
        "flash_attention_cached_bhsd": ("csrc/flash.cu", "hydragen_tpu/ops/flash.py:924",
                                        "main"),
        "decode_attention_cached": ("csrc/decode.cu", "hydragen_tpu/ops/decode.py:616",
                                    "main"),
        "decode_attention_cached_int4": ("csrc/decode.cu",
                                         "hydragen_tpu/ops/decode.py:616", "int4"),
        "flash_attention_bhsd": ("csrc/flash.cu", "hydragen_tpu/ops/flash.py:608", "main"),
        "w4a8_matmul_cached": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:495", "int4"),
        "write_token_int4_cached": ("csrc/decode.cu", "hydragen_tpu/ops/decode.py:729",
                                    "int4"),
        "flash_decode_bhsd": ("csrc/flash.cu", "hydragen_tpu/ops/flash.py:715", "gqa"),
    }
    kernels = []
    for name, (src, replaces, path) in sources.items():
        r = report.get(name)
        if r is None:
            failures.append(f"no measurement for {name}")
            continue
        n = launches[path].get(name, 0) if path else 0
        if path and n < 1:
            failures.append(f"{name} never launched on the {path} path")
        by_path = {p: launches[p].get(name, 0) for p in launches}
        kernels.append(dict(name=name, route="cuda", source=f"hydragen_torch/{src}",
                            replaces=replaces, launches=n, launches_by_path=by_path, **r))
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
