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
   output must equal the scaled ``torch._int_mm`` product bit for bit; its
   f32-scale instantiation likewise at all 9 shapes the load path gives it
   (the 7 unpadded projections at M = 256, 1,024 and 2,048), beside the
   bf16-scale K1; and at a tp=2 rank's shapes (q/k/v N=2,048, o K=2,048,
   gate/up N=5,632, down K=5,632; M = 256 and 2,048), nested under "tp2".
   K2 and K4 are also timed at the other shapes the paths give them (the 8B
   decode read, the 7B request-2 read, the 8B prefill, the 7B suffix
   prefill, a tp=2 rank's 16-head read and prefill, an sp=2 rank's
   1,024-token read), and K3 at a tp=2 rank's 16 heads, nested under their
   entries. K6 is held to its f32 oracle at
   every decode and 2,048-row shape of the 7B int4 layer and at its 2-D
   entry, and at a tp=2 rank's column shapes (q/k/v N=2,048, gate/up
   N=5,632, K=4,096; M = 256 and 2,048: its own entry,
   "w4a8_matmul_cached_tp2"). K7 must equal its plain version byte for byte at a low-plane and
   a high-plane slot, each with its own bound (the low plane reads no old
   byte row); its row reports the slower plane. K1, K2, K4, K5 (at the gqa
   and no-sharing reads and two split shapes) and K6 (at each of its
   shapes) are also timed
   on the device's clock alone (``device_ms``: a CUDA graph of the calls, no
   host work between them), with SDPA's likewise, K2 on bf16 k/v and K4 at
   head_dim 64; where K5 splits the keys, torch.profiler times its kernel
   and ``split_combine`` apart. K8's three entries at M = 256, 32,768 and
   65,536 by K = 4,096 and 11,008 (``check_k8``): ``quantize_rows`` and
   ``silu_mul_quant`` equal their plain chains bit for bit,
   ``rms_norm_quant`` (with its residual add and without) equals its plain
   chain at a mean of squares a few f32 steps from ``torch.mean``'s
   (``k8_norm_match``); device ms of each beside the plain chain's and the
   bytes bound. Every launch gate below counts K8 too (``expected_k8``).
   K9 at the cells' shapes (``check_k9``: the docs cell's unique prefill and
   decode step, Yi's 32,768-token prompt, suffixes and decode step, a tp=4
   rank of the 67B's prompt and decode step): its rotated q, k, v and every
   byte of the cache equal the plain chain's, a decode step's slot read from
   device memory; device ms beside the plain chain's and the bytes bound.
   Every launch gate below counts K9 too, one a layer in each forward that
   writes an int8 cache through it (not the batcher's).
4. main path: ``HydragenLlama`` at ``PRESETS["llama-2-7b"]`` full width,
   random weights from a seeded ``torch.Generator``, ``quantization="w8a8"``,
   ``kv_quant="int8"``; one request with a 2,048-token shared prompt and 256
   greedy completions (``shared_cache_op=WIPE``), then a second request of 256
   new 128-token suffixes over the kept prompt (``PRESERVE``), both decoding
   through the engine's CUDA graphs (one captured step, replayed a step).
   Every kernel's launch count must equal what the path implies (a replay
   counts its graph's launches). Request 1 also runs first through the eager
   loop (``graph(False)``): the graph's tokens must equal it and its logits
   equal it bit for bit. Request 2 runs once more eagerly and once more
   through its graph: the two decode rates. Then 8 decode steps of a third
   request run under ``torch.profiler``, eagerly (the copy gate) and through
   the graph (its table with a ``_graph`` suffix): device-busy share and device
   time by kernel (the full table goes to ``chiprun_out/profile_decode.txt``).
   A line a path sets the graph beside the eager loop, with kernels a step,
   capture time and pool memory.
5. load: the main path's model (Llama-2-7B width, ``LOAD_LAYERS`` layers)
   as a HF checkpoint: bf16 weights drawn from ``--seed`` as ``init_params``
   draws them, written under ``build/`` as safetensors shards with an index,
   loaded by ``HydragenLlama.from_pretrained(dir, quantization="w8a8")``
   (host quantization: f32 weight scales, the MLP unpadded). Gates: the
   loaded params equal the host quantizers' output on the in-memory dict bit
   for bit; the device's peak during the load at most 1.05 times the params'
   bytes; request 1 of the main path through the graphs with exact launches
   (K1 on its f32-scale instantiation), equal to the eager loop bit for bit;
   ``save_checkpoint`` and ``load_checkpoint`` into a new engine, the same
   request bit for bit; the hierarchy ablation (``disable_hierarchy``) with
   tokens equal, or forced-stream logits within ``TOL_NOSHARE``. Prints the
   load, host quantization, save and reload seconds, the bytes and both
   decode rates. Then (e) ``tp2-load``: two gloo ranks sharing the card
   load the same directory with ``from_pretrained_tp(tp=2,
   quantization="w8a8")``, which keeps only a rank's slices: each rank's
   parameters bit-equal to ``shard_params`` of the meshless load's (by
   digest), its parameter bytes the sharding rules', its host's peak
   resident bytes over the load at most its parameter bytes + 2 x the largest
   f32 tensor quantized whole + 1 GiB (printed beside the meshless load's),
   and 8 decode steps of request 1 on the meshless engine's tokens with K1
   on f32 scales at the rank's shapes: exact launches and collectives, row
   0's logits within ``TOL_NOSHARE``. The directory is deleted at the end.
6. int4 path: the same at full 7B width with int4 weights
   (``quantization="w4a8"``) and the token-planar int4 unique cache
   (``kv_quant="int4"``; the shared level int8). Request 1's decode writes
   the low nibble plane, request 2's the high plane over live low tokens.
7. gqa path: the same on ``PRESETS["llama-3-8b"]`` (32 query heads over 8 kv
   heads) at full width and depth, w8a8 + int8 KV. Its unique cache is
   BHSD, so every decode layer's unique read is the small-M read (K5) in
   place of K3. The profile fails on any copy of a unique-cache layer.
8. gqa no-sharing: the no-sharing baseline (``disable_hydragen=True``,
   ``bench.py``'s protocol: one 2,048-token prompt, 256 greedy completions,
   the prompt's KV in every unique row) against Hydragen on the same model
   and prompt in one engine, three rounds of the two arms in turn through
   their graphs (the three ratios of the decode rates are printed): exact
   launch counts, tokens equal to Hydragen's (or, where a bf16 tie breaks
   the other way, the logits of a forced stream within ``TOL_NOSHARE``), the
   baseline's graph equal to its eager loop, profiles.
9. serving: ``ContinuousBatcher`` over the main path's configuration at
   full width and depth (one 2,048-token shared prompt, a pool of 256 rows
   of 200 ring slots): a stream of 640 requests, suffixes of 16-128 tokens
   and budgets of 8-64 from ``--seed``, admitted longest budget first,
   decoded in chunks of 8 graph replays with a lookahead of 1; then the
   same stream through the eager loop. Gates: every request back within
   its budget, tokens in range, the eager stream's tokens equal for every
   request, launches exactly what the dispatch log implies (per admission
   224 K1, 32 K2, 32 K4; per decode step 224 K1, 32 K2; no K3 or K5: the
   masked ring read is the plain path, as in the JAX package), one capture
   a key. Prints requests/s, new tokens/s, decode ms a step through the
   graph and eagerly, admission seconds, capture seconds and pool MiB, and
   a profile of 8 replayed steps split into K1, K2, the plain ring read,
   the int8 write (both timed alone) and the rest. Then a short stream at 4
   layers of full width over a level of two prefixes, first in first out,
   a lookahead of 2, stop 2-grams on every third request: the same gates.
10. plain path: the w8a8 + int8-KV models (Llama-2-7B, and Llama-3-8B whose
   unique read is K5) at 2 layers of full width on one forced token stream,
   and the w4a8 + int4-KV model over two requests whose decode crosses into
   the high plane: the kernel path, and each kernel alone in the plain path,
   held against ``impl="torch"`` (every op's plain version), with the plain
   path in fp32 as the yardstick of all.

11. parallel: ``hydragen_torch.parallel`` at the main path's configuration
   (w8a8, int8 KV, random weights from ``--seed``, each rank's global draw
   sliced and freed before its request), request 1 alone: (a) tp=2, two
   ranks sharing the one card over gloo, ``PAR_TP2_LAYERS`` layers, eager;
   (b) sp=2, the same at ``PAR_SP_LAYERS`` layers, the level split 1,024 +
   1,024; gates on
   each rank: exact launches at the sharded shapes, exact collectives, the
   parameter bytes the sharding rules give, both ranks' tokens equal, and
   the logits of the ranks' token stream within ``TOL_NOSHARE`` of the
   meshless engine's (run here after the ranks); decode tok/s and ms a
   step split into the collectives' host time and the rest. (c) a one-rank
   NCCL mesh (``keep_trivial``) through the decode graphs: graph = eager =
   meshless bit for bit, the captured step's 64 all-reduces and one
   all-gather counted. (d) ``tp2-int4``: (a) with int4 weights
   (``init_params(quantized="w4a8")``, group 128, ``quantization="w4a8"``,
   int8 KV) at full width, ``PAR_TP2_LAYERS`` layers: K6 on each rank's
   column slices, o and
   down on the weight-only product of the rank's repacked K slice and the
   sum all-reduce, no K1; the same gates against the meshless w4a8 engine.
   (e) ``tp2-noshare``: the gqa no-sharing configuration (Llama-3-8B, w8a8
   + int8 KV, full width, ``NOSHARE_LAYERS`` layers), Hydragen and
   ``disable_hydragen=True`` in turn under one tp=2 gloo mesh, eagerly:
   exact launches (K5 on a rank's 4 kv heads, no K2 in the baseline) and
   collectives, tokens equal between the arms (or a forced stream within
   ``TOL_NOSHARE``), the baseline's logits within ``TOL_NOSHARE`` of the
   meshless baseline's on the same tokens; both decode rates and their
   ratio. ``--tp4`` runs only tp=4 over NCCL on four cards
   (eager, then graphs: bit for bit), which the default run never takes.
12. serving mesh: ``ContinuousBatcher`` over a mesh, one stream of 128
   requests (suffixes 16-128, budgets 8-64 from ``--seed``, longest budget
   first, chunk 8, bucket 32, lookahead 1, greedy) over a pool of 64 rows x
   200 ring slots at full Llama-2-7B width, w8a8 + int8 KV, one 2,048-token
   level: (a) tp=2 and (b) dp=2 (32 rows a rank) as two gloo ranks sharing
   the card at ``SERVE_MESH_LAYERS`` layers, eagerly, then the meshless
   batcher on the same weights, stream and depth; (c) a one-rank NCCL mesh
   (``keep_trivial``) at full depth through the decode graphs, then eagerly,
   then the meshless batcher through its graphs. Gates on every rank: the
   ranks' tokens and stats equal, the stats the meshless batcher's; exact
   launches from the rank's own dispatches (per admission prefill 7L K1, L
   K2, L K4; per step 7L K1, L K2; no K3 or K5) and exact collectives; every
   request within its budget, tokens in range; (a), (b): 8 finished
   requests' tokens forced through the meshless engine, each token within
   ``SERVE_MESH_MARGIN`` logit RMS of its step's top logit; (c): graph =
   eager = meshless bit for bit, one capture a key. Prints requests/s, new
   tokens/s, ms a step split into the collectives' host time and the rest,
   admission seconds and each rank's device peak.
13. scripts: each entry point of ``hydragen_torch.scripts`` through its
   ``main(argv)``, in this process, on the card, outputs under
   ``build/scripts_phase/``: synth at the main path's shape (``--mode all``,
   two iterations): the hydragen point's launches exactly 4 times request
   1's, noattention launching no K2 or K3, the no-sharing point (142 GB of
   unique KV) skipped by ``fits_hbm`` and never run; needles on
   ``yi-6b-200k`` in bf16 over a 16,384-token haystack, 2 to 64 questions: a
   YAML a count, K2 and K4 launched; the microbenchmark at its defaults,
   Hydragen's output within ``TOL_REL`` of the baseline's, and their time
   ratio; serving_bench at its defaults: every request back within its
   budget; run.py over a 2-layer Llama-2-7B-width HF directory with a
   WordLevel tokenizer (w8a8, int8 KV): a block a row, tokens in range;
   profile_decode over 8 steps: K1, K2 and K3 in its table; quality at its
   defaults (``sheared-llama-1.3b``, 512 tokens x 4) in 7 modes, gated by
   ``tests/test_quality.py``'s bounds where it asserts them (int8, w8a8 and
   per-channel under outliers pass, per-tensor under outliers fails, the
   int8 KV cache passes) with every w8a8 / w4a8 family on K1 / K6 (exact
   launches); ubench_gemm at its defaults, K1's 2-D entry (K1') and K6's
   within ``TOL_REL`` of their oracles; ubench_unique at its defaults, K3
   at both widths within ``TOL_REL`` of the plain read.

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
import hashlib
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# Main-path sizes.
SHARED_LEN = 2048
BATCH = 256
SUFFIX_LEN = 128
NEW_TOKENS = 64  # per request; cut this, never the width or the batch
# The kernel phase's GEMMs cycle over this many layers of weights, and sum
# one layer's projections: q, k, v, o share a shape, as do gate and up.
GEMM_LAYERS = 6
PER_LAYER = {"qkvo": 4, "gate_up": 2, "down": 1, "qkv": 3, "o": 1}
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
    from hydragen_torch.utils.timing import bound_ms

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

    # K1 on bf16 column scales (``quantize_params``, the MLP padded): the seven
    # projections of one layer, at decode (M = 256) and at the shared prefill
    # (M = 2,048), then the gate/up projection of request 2's unique prefill
    # (M = 32,768).
    NL = GEMM_LAYERS
    shapes = {"qkvo": (H, H), "gate_up": (I_PAD, H), "down": (H, I_PAD)}
    runs = [(M, key) for M in (BATCH, SHARED_LEN) for key in shapes]
    runs.append((BATCH * SUFFIX_LEN, "gate_up"))
    weights = check_k1(report, time_ms, g, record, torch.bfloat16, shapes, runs)

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
    # K1 on f32 column scales (the HF loader's, the MLP unpadded) at every
    # shape the load path gives it: the seven projections at decode, at the
    # ablation's 1,024-token prompt and at the 2,048-token prefills.
    I_HF = 11008
    shapes_hf = {"qkvo": (H, H), "gate_up": (I_HF, H), "down": (H, I_HF)}
    check_k1(report, time_ms, g, record, torch.float32, shapes_hf,
             [(M, key) for M in (BATCH, ABLATION_PROMPT, SHARED_LEN) for key in shapes_hf])
    # K1 at a tp=2 rank's shapes (phase parallel, nested under "tp2"): q/k/v
    # and gate/up on their column slices, o and down on their row slices.
    H2, I2 = H // 2, I_PAD // 2
    shapes_tp2 = {"qkv": (H2, H), "o": (H, H2), "gate_up": (I2, H), "down": (H, I2)}
    check_k1(report, time_ms, g, record, torch.bfloat16, shapes_tp2,
             [(M, key) for M in (BATCH, SHARED_LEN) for key in shapes_tp2], nest="tp2")

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
            n = PER_LAYER[key]
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
    check_k6_tp2(report, time_ms, g, record)

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
    check_k8(report, g, record)
    check_k9(report, g, record)


# K8's shapes in the kernel phase: M of a decode step, of request 2's unique
# prefill and of the docs cell's (128 documents of 512 tokens); K of the
# hidden width (both norms, o's input) and of the MLP (the SiLU product).
K8_ROWS = (BATCH, BATCH * SUFFIX_LEN, 65536)
K8_WIDTHS = (4096, 11008)
# The most f32 steps by which K8's mean of squares may lie from torch.mean's
# (the two sum the squares in other orders): the tie rule's cap on float
# noise (tests/test_torch_ties.py, NOISE_CAP_ULPS).
K8_MEAN_ULPS = 64


def k8_norm_match(x, weight, eps: float, delta, pair, h) -> dict:
    """Hold ``rms_norm_quant``'s result (``pair``, ``h``) to its plain chain.
    ``h`` must equal ``x + delta`` (``x`` with no ``delta``) bit for bit. A
    row's codes and scale must equal the plain chain's, or the plain chain's
    at a mean of squares at most ``K8_MEAN_ULPS`` f32 steps from
    ``torch.mean``'s: the kernel sums the squares in another order, and
    where that moves the row's factor by a step, rounding the normed row to
    bf16 can move an element by a bf16 step, which no rule on the f32
    quotients alone can tell from a fault. Returns ``ok``, the rows, the rows
    that needed a step, the rows no step reproduced, the widest step, and
    the codes apart from the plain chain's at its own mean (and their
    widest gap)."""
    from hydragen_torch.ops import gemm

    hp = x if delta is None else x + delta
    K = x.shape[-1]
    hf = hp.reshape(-1, K).float()
    wf = weight.float()
    var = (hf * hf).mean(dim=-1, keepdim=True)

    def chain(rows, v):
        return gemm.quantize_rows_plain((hf[rows] * torch.rsqrt(v + eps) * wf).to(x.dtype))

    q, s = pair
    qp, sp = chain(slice(None), var)
    apart = qp != q
    codes_apart = int(apart.sum())
    gap = int((qp.int() - q.int()).abs().max()) if codes_apart else 0
    left = (apart.any(-1) | (sp != s).squeeze(-1)).nonzero().squeeze(-1)
    moved, widest = int(left.numel()), 0
    bits = var.view(torch.int32)
    for step in range(1, K8_MEAN_ULPS + 1):
        for sign in (1, -1):
            if not left.numel():
                break
            qs, ss = chain(left, (bits[left] + sign * step).view(torch.float32))
            hit = (qs == q[left]).all(-1) & (ss == s[left]).squeeze(-1)
            if bool(hit.any()):
                widest = step
            left = left[~hit]
    return dict(ok=torch.equal(h, hp) and not left.numel(), rows=hf.shape[0],
                rows_moved=moved, rows_unmatched=int(left.numel()), widest_ulps=widest,
                codes_apart=codes_apart, code_gap=gap)


def check_k8(report: dict, g, record) -> None:
    """K8 (``csrc/act.cu``) at each M x K of ``K8_ROWS`` x ``K8_WIDTHS``,
    each entry held to its plain version: ``quantize_rows`` and
    ``silu_mul_quant`` bit for bit, ``rms_norm_quant`` (with its residual
    add and without) by ``k8_norm_match``; one launch a call under its
    count. device_ms: a CUDA graph of the calls; plain_ms the same of the
    plain chain; beside the bytes bound (each input read once, each output
    written once). The report's figures are at M = 65,536 (the docs cell's
    unique prefill), at the width the model gives each entry; every shape's
    are under "shapes"."""
    from hydragen_torch.ops import act, cuda_lib, gemm
    from hydragen_torch.utils.timing import bound_ms, cuda_graph_time_ms

    dev = torch.device("cuda")
    bf16, eps = torch.bfloat16, 1e-5
    shapes = {"rms_norm_quant": {}, "silu_mul_quant": {}, "quantize_rows": {}}
    for K in K8_WIDTHS:
        w = (1 + 0.1 * torch.randn(K, device=dev, generator=g)).to(bf16)
        for M in K8_ROWS:
            x = torch.randn(M, K, device=dev, generator=g).to(bf16)
            d = (0.5 * torch.randn(M, K, device=dev, generator=g)).to(bf16)
            gate = (3 * torch.randn(M, K, device=dev, generator=g)).to(bf16)
            cases = {  # label: (counter, kernel, plain, delta, bytes)
                "rms_norm_quant": ("rms_norm_quant", lambda: act.rms_norm_quant(x, w, eps, d),
                                   lambda: act.rms_norm_quant_plain(x, w, eps, d), d,
                                   7 * M * K + 2 * K + 4 * M),
                "rms_norm_quant no residual": (
                    "rms_norm_quant", lambda: act.rms_norm_quant(x, w, eps),
                    lambda: act.rms_norm_quant_plain(x, w, eps), None, 3 * M * K + 2 * K + 4 * M),
                "silu_mul_quant": ("silu_mul_quant", lambda: act.silu_mul_quant(gate, d),
                                   lambda: act.silu_mul_quant_plain(gate, d), None,
                                   5 * M * K + 4 * M),
                "quantize_rows": ("quantize_rows", lambda: gemm.quantize_rows(x),
                                  lambda: gemm.quantize_rows_plain(x), None, 3 * M * K + 4 * M),
            }
            for label, (counter, kernel, plain, delta, nbytes) in cases.items():
                before = cuda_lib.LAUNCHES[counter]
                res = kernel()
                launched = cuda_lib.LAUNCHES[counter] - before
                if counter == "rms_norm_quant":
                    m = k8_norm_match(x, w, eps, delta, *res)
                    ok, detail = m.pop("ok"), json.dumps(m)
                else:
                    pq, ps = plain()
                    ok = torch.equal(res[0], pq) and torch.equal(res[1], ps)
                    detail = f"bit-equal {ok}"
                    del pq, ps
                del res
                r = dict(
                    device_ms=cuda_graph_time_ms(kernel, iters=10),
                    plain_ms=cuda_graph_time_ms(plain, iters=3 if M > BATCH else 10, warmup=1))
                r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 0, "bf16")
                r["bound_share"] = r["bound_ms"] / r["device_ms"]
                record(f"{label} M={M} K={K}", ok and launched == 1,
                       f"launches {launched} {detail} device_ms {r['device_ms']:.4f} plain_ms "
                       f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, "
                       f"{nbytes / 1e9:.3f} GB) share of the bound {100 * r['bound_share']:.1f} %")
                shapes[counter][f"{label} M={M} K={K}"] = r
            del x, d, gate
    at = {"rms_norm_quant": "rms_norm_quant M=65536 K=4096",
          "silu_mul_quant": "silu_mul_quant M=65536 K=11008",
          "quantize_rows": "quantize_rows M=65536 K=4096"}
    for name, key in at.items():
        report[name] = dict(**shapes[name][key], shapes=shapes[name],
                            at=f"{key.split(' ', 1)[1]}, bf16 in (device_ms and plain_ms: "
                               f"from CUDA graphs of the calls)")


# K9's shapes in the kernel phase, the cells' (``portbench/``): label ->
# (rows, new tokens, q heads, kv heads, destination). DeepSeek-7B's docs
# cell (32 kv heads, a BSHD unique cache with flat scales), Yi-6B's few-shot
# cell (4 kv heads, a BHSD unique cache; its 32,768-token prompt into the
# level) and a tp=4 rank of DeepSeek-67B (16 q and 2 kv heads).
K9_SHAPES = {
    "docs unique prefill": (128, 512, 32, 32, "bshd"),
    "docs decode": (128, 1, 32, 32, "bshd"),
    "yi shared prefill": (1, 32768, 32, 4, "level"),
    "yi unique prefill": (256, 64, 32, 4, "bhsd"),
    "yi decode": (256, 1, 32, 4, "bhsd"),
    "tp4 rank shared prefill": (1, 3584, 16, 2, "level"),
    "tp4 rank decode": (256, 1, 16, 2, "bhsd"),
}


def check_k9(report: dict, g, record) -> None:
    """K9 (``csrc/rope.cu``) at each of ``K9_SHAPES``, head dim 128, bf16,
    held to its plain chain bit for bit (the rotated q, k and v, and every
    byte of the destination: codes, scales, the tokens and rows it must
    not touch), one launch a call; a decode step writes at a slot read from
    device memory. device_ms: a CUDA graph of the calls; plain_ms the same
    of the plain chain; beside the bytes bound (q, k, v and the cos/sin
    rows read once; q and k, v where the prefill's attention reads it, the
    codes and the scales written once). The report's figures are at the
    docs cell's unique prefill; every shape's are under "shapes"."""
    from hydragen_torch.core import cache as kvcache
    from hydragen_torch.ops import cuda_lib, rope
    from hydragen_torch.utils.timing import bound_ms, cuda_graph_time_ms

    dev, bf16, hd = torch.device("cuda"), torch.bfloat16, 128
    shapes = {}
    for label, (b, t, nh, nkv, kind) in K9_SHAPES.items():
        U = t + NEW_TOKENS  # the unique cache holds the new tokens after these

        def cache():  # the same random codes each time
            gc = torch.Generator(device=dev).manual_seed(7)
            if kind == "level":
                c = kvcache.allocate_cache(1, 1, 16, [b], [t], nkv, hd, quantized=True,
                                           device=dev)
            else:
                c = kvcache.allocate_cache(1, b, U, [], [], nkv, hd, quantized=True,
                                           unique_bshd=kind == "bshd", device=dev)
            for x in buffers(c):
                if x.dtype == torch.int8:
                    x.copy_(torch.randint(-127, 128, x.shape, generator=gc, device=dev,
                                          dtype=torch.int8))
            return c

        def buffers(c):
            return [c.unique_k, c.unique_v, c.unique_k_scale, c.unique_v_scale,
                    *[y for lv in c.shared for y in (lv.k, lv.v, lv.k_scale, lv.v_scale)]]

        def dest(c, slot):
            if kind == "level":
                return kvcache.level_kv_dest(c.shared[0], 0, b, t)
            return kvcache.unique_kv_dest(c, 0, b, slot, t)

        q = (2 * torch.randn(b, t, nh * hd, device=dev, generator=g)).to(bf16)
        k = (2 * torch.randn(b, t, nkv * hd, device=dev, generator=g)).to(bf16)
        v = torch.randn(b, t, nkv * hd, device=dev, generator=g).to(bf16)
        ang = torch.rand(b, t, hd // 2, device=dev, generator=g) * 6.2832
        cos = torch.cat([ang.cos()] * 2, -1).to(bf16)
        sin = torch.cat([ang.sin()] * 2, -1).to(bf16)
        slot = torch.tensor(U - 1, dtype=torch.int32, device=dev) if t == 1 else 0
        kc, pc = cache(), cache()
        kd, pd = dest(kc, slot), dest(pc, slot)
        before = cuda_lib.LAUNCHES["rope_kv_quant"]
        got = rope.rope_kv_quant(q, k, v, cos, sin, kd, nh, nkv, hd)
        launched = cuda_lib.LAUNCHES["rope_kv_quant"] - before
        want = rope.rope_kv_quant_plain(q, k, v, cos, sin, pd, nh, nkv, hd)
        torch.cuda.synchronize()
        outs = all(torch.equal(x, y) for x, y in zip(got, want))
        bufs = all(torch.equal(x, y) for x, y in zip(buffers(kc), buffers(pc)))
        del got, want
        nbytes = (2 * b * t * (nh + 2 * nkv) * hd + 2 * 2 * b * t * hd  # q, k, v; cos, sin
                  + 2 * b * t * (nh + nkv + (nkv if t > 1 else 0)) * hd  # q', k' (v)
                  + 2 * b * t * nkv * (hd + 4))  # codes and scales
        r = dict(device_ms=cuda_graph_time_ms(
                     lambda: rope.rope_kv_quant(q, k, v, cos, sin, kd, nh, nkv, hd), iters=10),
                 plain_ms=cuda_graph_time_ms(
                     lambda: rope.rope_kv_quant_plain(q, k, v, cos, sin, pd, nh, nkv, hd),
                     iters=3 if t > 1 else 10, warmup=1))
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 0, "bf16")
        r["bound_share"] = r["bound_ms"] / r["device_ms"]
        ok = outs and bufs and launched == 1
        record(f"rope_kv_quant {label}", ok,
               f"b={b} t={t} heads {nh}/{nkv} {kind}: launches {launched} outputs bit-equal "
               f"{outs} cache bit-equal {bufs} device_ms {r['device_ms']:.4f} plain_ms "
               f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, "
               f"{nbytes / 1e9:.4f} GB) share of the bound {100 * r['bound_share']:.1f} %")
        shapes[label] = dict(r, rows=b, tokens=t, heads=[nh, nkv], dest=kind, bit_equal=ok)
        del q, k, v, cos, sin, kc, pc, kd, pd
    key = "docs unique prefill"
    report["rope_kv_quant"] = dict(
        **shapes[key], shapes=shapes,
        at=f"{key}: 128 rows x 512 tokens, 32 q / 32 kv heads of 128, into a BSHD unique "
           f"cache with flat scales, bf16 in (device_ms and plain_ms: from CUDA graphs of "
           f"the calls)")


def check_k6_tp2(report: dict, time_ms, g, record) -> None:
    """K6 at a tp=2 rank's column shapes of the 7B int4 layer (phase
    parallel's case (d)): q/k/v at N = 2,048 and gate/up at N = 5,632 of the
    padded MLP, K = 4,096, group 128, at decode (M = 256) and at the shared
    prefill (M = 2,048), each held to the f32 oracle under ``TOL_W4A8`` and
    timed host-paced, on the device's clock (a CUDA graph of the calls) and
    beside its bound. The report ("w4a8_matmul_cached_tp2") sums one decode
    layer's five column projections of a rank; each shape's own readings
    are nested under "shapes". The row-parallel o/down run the weight-only
    product, not K6."""
    from hydragen_torch.utils.timing import bound_ms

    from hydragen_torch.ops import gemm
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    NL, H = GEMM_LAYERS, 4096
    shapes = {"qkv": (H // 2, H), "gate_up": (11264 // 2, H)}
    acc = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, err=0.0, bytes=0, ops=0)
    per_shape = {}
    for key, (N, K) in shapes.items():
        qp = torch.randint(-128, 128, (NL, N, K // 2), dtype=torch.int8, device=dev,
                           generator=g)
        gs = (torch.rand(NL, K // 128, N, device=dev, generator=g) * 2e-3 + 1e-4
              ).to(torch.bfloat16)
        for M in (BATCH, SHARED_LEN):
            a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
            out = gemm.w4a8_matmul_cached(NL - 1, a_q, a_s, qp, gs, out_dtype=torch.float32)
            ref = gemm.w4a8_reference(a_q, a_s, qp[NL - 1], gs[NL - 1], out_dtype=torch.float32)
            err, rel = rel_err(out, ref)
            del out, ref
            ms = time_ms(Cycle(lambda i: gemm.w4a8_matmul_cached(i, a_q, a_s, qp, gs), NL))
            dms = cuda_graph_time_ms(
                Cycle(lambda i: gemm.w4a8_matmul_cached(i, a_q, a_s, qp, gs), NL))
            pms = time_ms(Cycle(lambda i: gemm.w4a8_cached_plain(i, a_q, a_s, qp, gs), NL),
                          iters=5, warmup=1)
            nbytes = M * K + M * 4 + N * K // 2 + (K // 128) * N * 2 + M * N * 2
            ops = 2 * M * N * K
            bms, by = bound_ms(nbytes, ops, "int8")
            record(f"w4a8_matmul_cached tp=2 rank M={M} N={N} K={K}", rel <= TOL_W4A8,
                   f"max_abs_err {err:.4g} rel {rel:.3g} (fp32 out, tol {TOL_W4A8}) ms {ms:.4f} "
                   f"device_ms {dms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}) device "
                   f"TOP/s {ops / dms / 1e9:.1f}")
            per_shape[f"M={M} N={N} K={K}"] = dict(
                max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                bound_by=by, device_top_s=ops / dms / 1e9)
            if M == BATCH:
                n = PER_LAYER[key]
                for field, v in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                                 ("bytes", nbytes), ("ops", ops)):
                    acc[field] += n * v
                acc["err"] = max(acc["err"], err)
            del a_q, a_s
        del qp, gs
    bms, by = bound_ms(acc["bytes"], acc["ops"], "int8")
    print(f"[kernel] w4a8_matmul_cached, one tp=2 rank's decode layer (5 column projections, "
          f"M={BATCH}): device_ms {acc['device_ms']:.4f} ms {acc['ms']:.4f} bound_ms {bms:.4f} "
          f"({by})", flush=True)
    report["w4a8_matmul_cached_tp2"] = dict(
        max_abs_err=acc["err"], ms=acc["ms"], device_ms=acc["device_ms"],
        plain_ms=acc["plain_ms"], bound_ms=bms, bound_by=by, library_ms=None, shapes=per_shape,
        at="sum of one tp=2 rank's decode layer of int4 column projections (q/k/v N=2048, "
           "gate/up N=5632, K=4096, group 128), M=256 (library: none, no PyTorch call "
           "multiplies packed int4 weights with group scales; device_ms: from a CUDA graph of "
           "the calls)",
    )


def check_k1(report: dict, time_ms, g, record, scale_dtype, shapes: dict, runs: list,
             nest: str | None = None) -> dict:
    """K1 (``w8a8_matmul_cached``) on column scales of ``scale_dtype`` at each
    (M, projection) of ``runs``, the projections' (N, K) in ``shapes``. Each
    output is held to the plain version, to the exact i32 product scaled in
    the kernel's order bit for bit (``torch._int_mm`` as the oracle), and to
    one launch under the dtype's count. f32 scales are also held to the
    bf16-scale K1 at bf16 scales cast to f32 (the epilogue takes f32 either
    way), whose device time stands beside theirs. device_ms: a CUDA graph of
    the calls (no host work between them); ms: host-paced. The report sums
    one decode layer's 7 projections (M = BATCH); each shape's own readings
    are nested under "shapes". With ``nest`` the report goes under that key of
    the kernel's entry (its sharded shapes). Returns ``{projection: (w, ws, w
    transposed)}``."""
    from hydragen_torch.utils.timing import bound_ms

    from hydragen_torch.ops import cuda_lib, gemm
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    NL = GEMM_LAYERS
    f32 = scale_dtype == torch.float32
    name = "w8a8_matmul_cached" + ("_f32_scales" if f32 else "")
    label = "w8a8_matmul_cached" + (" f32 column scales" if f32 else "")
    weights = {}
    for key, (N, K) in shapes.items():
        w = torch.randint(-127, 128, (NL, N, K), dtype=torch.int8, device=dev, generator=g)
        ws = (torch.rand(NL, N, device=dev, generator=g) * 2e-3 + 1e-4).to(scale_dtype)
        weights[key] = (w, ws, w.transpose(1, 2).contiguous())
    summed = ["ms", "device_ms", "plain_ms", "library_ms", "int_mm_device_ms"]
    summed += ["bf16_scales_device_ms"] if f32 else []
    acc = dict.fromkeys(summed + ["bytes", "ops", "err"], 0.0)
    per_shape = {}
    for M, key in runs:
        N, K = shapes[key]
        w, ws, wt = weights[key]
        a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
        before = cuda_lib.LAUNCHES[name]
        out = gemm.w8a8_matmul_cached(NL - 1, a_q, a_s, w, ws)
        launched = cuda_lib.LAUNCHES[name] - before
        ref = gemm.w8a8_cached_plain(NL - 1, a_q, a_s, w, ws, out_dtype=torch.float32)
        err, rel = rel_err(out, ref)
        exact = torch.equal(out, int_mm_oracle(a_q, a_s, wt[NL - 1], ws[NL - 1]))
        del ref
        r = dict(
            max_abs_err=err, bit_exact=exact,
            ms=time_ms(Cycle(lambda i: gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws), NL)),
            device_ms=cuda_graph_time_ms(
                Cycle(lambda i: gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws), NL)),
            plain_ms=time_ms(Cycle(lambda i: gemm.w8a8_cached_plain(i, a_q, a_s, w, ws), NL),
                             iters=2 if M > SHARED_LEN else 5, warmup=1),
            library_ms=time_ms(Cycle(lambda i: torch._int_mm(a_q, wt[i]), NL)),
            int_mm_device_ms=cuda_graph_time_ms(Cycle(lambda i: torch._int_mm(a_q, wt[i]), NL)),
        )
        ok = rel <= TOL_REL and exact and launched == 1
        extra = ""
        if f32:
            ws16 = ws.to(torch.bfloat16)
            cast = torch.equal(gemm.w8a8_matmul_cached(NL - 1, a_q, a_s, w, ws16.float()),
                               gemm.w8a8_matmul_cached(NL - 1, a_q, a_s, w, ws16))
            r["bf16_scales_device_ms"] = cuda_graph_time_ms(
                Cycle(lambda i: gemm.w8a8_matmul_cached(i, a_q, a_s, w, ws16), NL))
            r["equal_to_bf16_scale_k1"] = cast
            ok = ok and cast
            extra = (f", equal to the bf16-scale K1 at cast scales {cast}; bf16 scales "
                     f"device_ms {r['bf16_scales_device_ms']:.4f}")
        nbytes = M * K + M * 4 + N * K + N * ws.element_size() + M * N * 2
        ops = 2 * M * N * K
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, ops, "int8")
        r["device_top_s"] = ops / r["device_ms"] / 1e9
        r["plan"] = gemm_plan_of(gemm, M, N, K)
        record(
            f"{label} M={M} N={N} K={K}", ok,
            f"launches {launched} max_abs_err {err:.4g} rel {rel:.3g} (tol {TOL_REL}) bit-exact "
            f"vs int_mm {exact}{extra} ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} int_mm_ms {r['library_ms']:.4f} int_mm_device_ms "
            f"{r['int_mm_device_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) device "
            f"TOP/s {r['device_top_s']:.1f} plan {r['plan']}",
        )
        per_shape[f"M={M} N={N} K={K}"] = r
        if M == BATCH:
            for field, v in [(f, r[f]) for f in summed] + [("bytes", nbytes), ("ops", ops)]:
                acc[field] += PER_LAYER[key] * v
            acc["err"] = max(acc["err"], err)
        del a_q, a_s, out
    bms, by = bound_ms(acc.pop("bytes"), acc.pop("ops"), "int8")
    projections = "; ".join(f"{key}: N={N} K={K}" for key, (N, K) in shapes.items())
    entry = dict(
        max_abs_err=acc.pop("err"), **acc, bound_ms=bms, bound_by=by, shapes=per_shape,
        at=f"sum of one decode layer's 7 projections ({projections}) with "
           f"{'f32' if f32 else 'bf16'} column scales, M={BATCH} "
           f"(library: torch._int_mm, no scale epilogue; device_ms: from a CUDA graph of the "
           f"calls" + ("; bf16_scales_device_ms: the bf16-scale K1 at the same shapes" if f32
                       else "") + ")",
    )
    if nest is None:
        report[name] = entry
    else:
        report[name][nest] = entry
    return weights


def check_decode_kernels(report: dict, time_ms, g, record) -> None:
    """K3 at the three unique reads of the 7B paths' decode steps, and K7 at
    the int4 path's write. Each K3 shape: 256 rows, 32 kv heads of 128, own
    token and shared partial merged, against its plain version; ``ms``
    host-paced, ``device_ms`` from a CUDA graph of the calls, and SDPA over
    bf16 copies of the same keys (every row at the shape's length) as a
    yardstick of another function: no LSE, no own token, no merge."""
    from hydragen_torch.utils.timing import bound_ms

    from hydragen_torch.ops import decode
    from hydragen_torch.ops.quant import unpack4
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    F = torch.nn.functional
    NL, hq, hkv, d = 4, 32, 32, 128
    qd_all = torch.randn(BATCH, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    own_all = tuple(torch.randn(BATCH, hkv, 1, d, device=dev, generator=g).to(torch.bfloat16)
                    for _ in range(2))
    sh_all = (torch.randn(BATCH, hq, 1, d, device=dev, generator=g).to(torch.bfloat16),
              torch.randn(BATCH, hq, 1, device=dev, generator=g) * 2)

    def k3_case(name, S, filled, bits, lens=None, heads=hkv):
        """K3 over [NL, 256, S, heads, 128] caches (S byte rows; int4 holds
        2S tokens; ``heads`` query and kv heads, 32 unless a tp rank's 16),
        ``filled`` tokens a row unless ``lens`` says otherwise. Returns its
        readings and the cache buffers."""
        hq = hkv = heads
        qd = qd_all[:, :hq].contiguous()
        own = tuple(x[:, :hkv].contiguous() for x in own_all)
        sh = tuple(x[:, :hq].contiguous() for x in sh_all)
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
    del bufs
    # A tp=2 rank's read of request 1's last step: 16 query and kv heads.
    r_tp2, bufs = k3_case("decode_attention_cached tp=2 rank (16 heads)", 64, 63, 8,
                          heads=hkv // 2)
    report["decode_attention_cached"] = dict(
        **r1, at="b=256, 63 of 64 int8 slots, own token + shared partial ("
                 + yardstick.format(n=63) + ")",
        request2=dict(r2, at=f"b=256, {window - 1} of {window} int8 slots ("
                             + yardstick.format(n=window - 1) + ")"),
        tp2=dict(r_tp2, at="a tp=2 rank: b=256, 16 kv heads, 63 of 64 int8 slots, flat "
                           "local scales (" + yardstick.format(n=63) + ")"),
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
    # against its plain version at a low-plane slot and a high-plane slot,
    # with the slot given as a host int and as a device int32 (the decode
    # graph's: the kernel reads it from device memory); device_ms with the
    # host int (as kernel_times.py times it), slot_device_ms with the device
    # slot. Bytes: K and V in bf16, the written byte rows and scales, and at
    # the high plane the old byte rows read (the low plane reads none).
    from_slot = {}
    for slot in (S4 // 2, S4 + 7):
        kv = [torch.randn(BATCH, hkv, 1, d, device=dev, generator=g).mul(2).to(torch.bfloat16)
              for _ in range(2)]
        bufs = [ck, cv, cks, cvs]
        plain = [t.clone() for t in bufs]
        decode.write_token_int4_cached(NL - 1, *kv, *bufs, slot)
        decode.write_token_int4_cached_plain(NL - 1, *kv, *plain, slot)
        exact = all(torch.equal(a, b) for a, b in zip(bufs, plain))
        dslot = torch.tensor([slot], dtype=torch.int32, device=dev)
        kv2 = [torch.randn_like(x.float()).to(torch.bfloat16) for x in kv]
        decode.write_token_int4_cached(NL - 1, *kv2, *bufs, dslot)
        decode.write_token_int4_cached_plain(NL - 1, *kv2, *plain, slot)
        exact = exact and all(torch.equal(a, b) for a, b in zip(bufs, plain))

        def write(i):
            decode.write_token_int4_cached(i, *kv, *bufs, slot)

        ms = time_ms(Cycle(write, NL))
        dms = cuda_graph_time_ms(Cycle(write, NL))
        sdms = cuda_graph_time_ms(Cycle(
            lambda i: decode.write_token_int4_cached(i, *kv, *bufs, dslot), NL))
        pms = time_ms(Cycle(lambda i: decode.write_token_int4_cached_plain(
            i, *kv, *plain, slot), NL), iters=5)
        plane = "high" if slot >= S4 else "low"
        rows = 2 * BATCH * hkv * d
        nbytes = 2 * rows + rows * (2 if plane == "high" else 1) + 2 * BATCH * hkv * 4
        bms, by = bound_ms(nbytes, 0, "fp32")
        from_slot[plane] = dict(exact=exact, ms=ms, device_ms=dms, slot_device_ms=sdms,
                                plain_ms=pms, bound_ms=bms, bound_by=by)
        record(f"write_token_int4_cached slot {slot} ({plane} plane)", exact,
               f"bit-exact {exact} (host and device slot) ms {ms:.4f} plain_ms {pms:.4f} "
               f"device (graph) {dms:.4f}, device slot {sdms:.4f} bound_ms {bms:.4f}")
        del plain
    slots = from_slot.values()
    slower = max(slots, key=lambda r: r["device_ms"])
    report["write_token_int4_cached"] = dict(
        max_abs_err=0.0 if all(r["exact"] for r in slots) else float("nan"),
        ms=max(r["ms"] for r in slots), device_ms=slower["device_ms"],
        plain_ms=max(r["plain_ms"] for r in slots), bound_ms=slower["bound_ms"],
        bound_by=slower["bound_by"], library_ms=None, by_plane=from_slot,
        at="one layer's K and V token, b=256, 32 heads x 128, into 96 byte rows; the "
           "slower of a low-plane and a high-plane slot, with that plane's bound (the low "
           "plane reads no old byte row; device_ms: from a CUDA graph of the calls, the "
           "slot a host int; by_plane's slot_device_ms: the slot read from device memory; "
           "library: none, no PyTorch call quantizes to int4 and merges nibbles)",
    )


def device_ms_by_kernel(fn, names, calls: int = 10) -> dict:
    """Device ms a ``fn()`` call spends in the kernels whose names contain
    each of ``names``, from torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from hydragen_torch.utils.profiling import group_ms, kernel_table

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return group_ms(kernel_table(prof), names, per=calls, other=None)


def check_flash_shapes(report: dict, time_ms, g, record) -> None:
    """K2 and K4 at the other shapes the paths give them, each against its
    plain version (one kv head at a time where the plain scores would not
    fit), beside SDPA on the same bf16 work (``enable_gqa`` where grouped):
    K2 at the 8B decode read and at the 7B request-2 read, K4 at the 8B
    prefill and at the 7B suffix prefill. Nested under the 7B entries."""
    from hydragen_torch.utils.timing import bound_ms

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

    # K2: one layer of an int8 level read in place, S = 2,048, and at the
    # sharded reads of phase parallel: a tp=2 rank's 16 heads, an sp=2
    # rank's 1,024-token slice.
    for key, hq, hkv, m, S in (("llama_3_8b_decode", 32, 8, BATCH, SHARED_LEN),
                               ("request2_read", 32, 32, BATCH * SUFFIX_LEN, SHARED_LEN),
                               ("tp2_decode", 16, 16, BATCH, SHARED_LEN),
                               ("sp2_decode", 32, 32, BATCH, SHARED_LEN // 2)):
        NL = 3
        shape = (NL, 1, hkv, S, d)
        lk, lv = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
                  for _ in range(2))
        lks, lvs = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
                    for _ in range(2))
        lens = torch.full((1,), S, dtype=torch.int32, device=dev)
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
        nbytes = 2 * q.numel() * 2 + 2 * hkv * S * (d + 4) + hq * m * 4
        bms, by = bound_ms(nbytes, 4 * hq * m * S * d, "bf16")
        splits, chunk = flash.flash_plan(
            hkv, hq // hkv * m, S,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        record(f"flash_attention_cached_bhsd {key}: hkv={hkv} M={hq // hkv * m} S={S} "
               f"int8, {splits} KV splits of {chunk}", ok,
               f"max_abs_err {err:.4g} rel {rel:.3g} lse_err {lerr:.3g} ms {ms:.4f} plain_ms "
               f"{pms:.4f} sdpa_ms {lms:.4f} bound_ms {bms:.4f}; device (graph) {dms:.4f}, "
               f"sdpa {ldms:.4f} ms")
        report["flash_attention_cached_bhsd"][key] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms,
            device_ms=dms, library_device_ms=ldms,
            at=f"hkv={hkv}, {hq // hkv * m} folded rows, S={S} int8, KV splits "
               f"{splits} (library: SDPA on bf16 dequantized k/v"
               f"{', enable_gqa' if hq != hkv else ''}; plain: one kv head at a time)")
        del lk, lv, lks, lvs, q, o, lse, kdq, vdq

    # K4: causal bf16 prefills.
    for key, b, hq, hkv, m in (("llama_3_8b_prefill", 1, 32, 8, SHARED_LEN),
                               ("suffix_prefill", BATCH, 32, 32, SUFFIX_LEN),
                               ("tp2_prefill", 1, 16, 16, SHARED_LEN)):
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
    from hydragen_torch.utils.timing import bound_ms

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


def expected_k8(L: int, forwards: int, mesh: str = "") -> dict:
    """K8's launches in ``forwards`` w8a8 or w4a8 forwards of L layers: both
    norms of every layer (2L a forward) and, where o and down are not split
    over tp, the SiLU product and o's input (L each). Under tp (``mesh``
    "tp", the one-rank NCCL mesh's trivial tp too) o and down quantize their
    own K slices (2L ``quantize_rows``) and no SiLU product is fused; under
    "tp-int4" the int4 o and down take the weight-only product (no
    ``quantize_rows``)."""
    out = {"rms_norm_quant": 2 * L * forwards,
           "silu_mul_quant": 0 if mesh else L * forwards,
           "quantize_rows": {"": L, "tp": 2 * L, "tp-int4": 0}[mesh] * forwards}
    return {k: v for k, v in out.items() if v}


def expected_launches(L: int, T: int) -> dict:
    """Launches the two main-path requests imply, for L layers and T new
    tokens each (the first token of a request comes from its prefill):
    - request 1: a shared prefill (7L GEMMs, L causal flash) and T-1 decode
      steps (7L GEMMs, L level reads, L unique reads each);
    - request 2: a unique prefill over the kept level (7L GEMMs, L level
      reads, L causal flash over the suffixes) and T-1 decode steps;
    - in each of those 2T forwards, K8's launches (``expected_k8``) and K9 a
      layer (each writes its int8 KV: the level, the suffixes, the slot)."""
    return {
        "w8a8_matmul_cached": 2 * 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1) + L * T,
        "decode_attention_cached": 2 * L * (T - 1),
        "flash_attention_bhsd": 2 * L,
        **expected_k8(L, 2 * T),
        "rope_kv_quant": 2 * L * T,
    }


def expected_launches_int4(L: int, T: int) -> dict:
    """The same two requests on the int4 path: every projection on the w4a8
    GEMM (the LM head stays weight-only int8), the int8 shared level read by
    K2, the unique read by K3 at kv_bits=4, and each decode layer's K and V
    token written by one int4 write launch (the in-place decode path writes
    each layer right after its read), T-1 steps a request. K9 only in the
    shared prefill, whose level is int8; the int4 unique writes keep the
    chain."""
    return {
        "w4a8_matmul_cached": 2 * 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1) + L * T,
        "decode_attention_cached_int4": 2 * L * (T - 1),
        "write_token_int4_cached": 2 * L * (T - 1),
        "flash_attention_bhsd": 2 * L,
        **expected_k8(L, 2 * T),
        "rope_kv_quant": L,
    }


def expected_launches_gqa(L: int, T: int) -> dict:
    """The same two requests on Llama-3-8B (GQA, w8a8 + int8 KV). Its unique
    cache is BHSD, which the decode kernel does not read, so each decode
    layer's unique read is the small-M read (K5, M = 4 folded rows) in place
    of K3: 2L(T-1) launches, one a layer a step, and 0 of K3. The prefills
    are as on the main path: the causal flash calls have M = 4 x 2,048 and
    4 x 128 folded rows, so they stay on K2's kernel (K4). K9 as on the
    main path, a layer in each forward."""
    return {
        "w8a8_matmul_cached": 2 * 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1) + L * T,
        "flash_decode_bhsd": 2 * L * (T - 1),
        "flash_attention_bhsd": 2 * L,
        **expected_k8(L, 2 * T),
        "rope_kv_quant": 2 * L * T,
    }


def expected_launches_no_sharing(L: int, T: int, mesh: str = "") -> dict:
    """The no-sharing baseline's one request (``bench.py:70-96``): the
    prompt is the unique rows' prefill (7L GEMMs, L causal flash at 2,048
    tokens), repeated into every row; then T-1 decode steps, each layer
    reading its row's whole history (prompt copy and decoded tokens) with
    one small-M read and no level read. K8 in each of the T forwards, under
    ``mesh`` (``expected_k8``); K9 a layer in each (the prefill's rows and
    each step's slot)."""
    return {
        "w8a8_matmul_cached": 7 * L * T,
        "flash_decode_bhsd": L * (T - 1),
        "flash_attention_bhsd": L,
        **expected_k8(L, T, mesh),
        "rope_kv_quant": L * T,
    }


# name: (tag, preset, quantization, kv_quant, expected launches, profile groups)
PATHS = {
    "main": ("main", "llama-2-7b", "w8a8", "int8", expected_launches,
             ("w8a8_kernel", "flash_kernel", "split_combine", "decode_kernel",
              "act_quant_kernel")),
    "int4": ("int4", "llama-2-7b", "w4a8", "int4", expected_launches_int4,
             ("w4a8_kernel", "flash_kernel", "split_combine", "decode_kernel",
              "write_int4_kernel", "act_quant_kernel")),
    "gqa": ("gqa", "llama-3-8b", "w8a8", "int8", expected_launches_gqa,
            ("w8a8_kernel", "flash_decode_kernel", "flash_kernel", "split_combine",
             "act_quant_kernel")),
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


def graph_stats(eng) -> dict:
    """The engine's captured decode graphs: how many, their capture seconds
    and the memory of their one pool (the caching allocator's segments of
    that pool, from its snapshot; None where the snapshot names no pool)."""
    sts = [st for st in eng._decode.values() if st.graph is not None]
    pool_mib = None
    if eng._graph_pool is not None:
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" in segs[0]:
            pool_mib = sum(seg["total_size"] for seg in segs
                           if tuple(seg["segment_pool_id"]) == tuple(eng._graph_pool)) / 2**20
    return dict(graphs=len(sts), capture_s=sum(st.capture_s for st in sts), pool_MiB=pool_mib)


def eager_yardstick(eng, request: dict):
    """One request through the eager loop (``graph(False)``): its tokens and
    its logits, moved to the host so that the card holds one run's logits
    at a time. The engine goes back to its graphs."""
    eng.graph(False)
    try:
        toks, logits = eng.generate(return_logits=True, **request)
        return toks, [x.cpu() for x in logits]
    finally:
        eng.graph(True)


def compare_to_eager(tag: str, eager, toks, logits, failures: list) -> None:
    """Graph against eager on one request: tokens equal, and each step's
    logits equal bit for bit (the step runs the same kernels on the same
    inputs, replayed or launched one by one)."""
    toks_e, logits_e = eager
    same = bool(torch.equal(toks_e, toks))
    worst, unequal = 0.0, 0
    for a, b in zip(logits_e, logits):
        b = b.cpu()
        if not torch.equal(a, b):
            unequal += 1
            worst = max(worst, float((a - b).abs().max()))
    ok = same and unequal == 0 and len(logits_e) == len(logits)
    print(f"[{tag}] graph vs eager, request 1: tokens equal {same}, logit steps bit-equal "
          f"{len(logits) - unequal} of {len(logits)} (largest difference {worst:.4g}) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{tag}: graph decode differs from eager (tokens equal {same}, "
                        f"{unequal} logit steps unequal, largest {worst:.4g})")


def drive_path(args, failures: list, path: str, stats_out: dict | None = None) -> dict:
    """Drive one configuration's two requests at full width and depth
    through the decode graphs, with the counts set to 0 just before and read
    just after. Request 1 also runs through the eager loop first, the
    yardstick: tokens equal and logits bit-equal. Then request 2 once more
    eagerly and once more through its graph (captured by then), for the two
    decode rates; then 8 decode steps profiled eagerly (the copy gate) and
    through the graph. Returns the launch counts of the two requests; the
    rates and times go into ``stats_out``."""
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
    request1 = dict(input_ids=[prompt], num_return_sequences=BATCH, max_new_tokens=T,
                    temperature=0.0, shared_cache_op=SharedCacheOp.WIPE, seed=args.seed)
    request2 = dict(input_ids=[suffixes], num_return_sequences=1, max_new_tokens=T,
                    temperature=0.0, shared_cache_op=SharedCacheOp.PRESERVE, seed=args.seed)

    decode_steps, decode_s = time_decode_loop(eng)
    eager = eager_yardstick(eng, request1)
    stats = {"eager_request1_decode_s": decode_s[0]}
    decode_s[0] = 0.0
    encodes = gemm.map_encodes()
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks1, logits1 = eng.generate(return_logits=True, **request1)
    torch.cuda.synchronize()
    stats["request1_s"] = time.perf_counter() - t
    stats["request1_decode_s"] = decode_s[0]
    t = time.perf_counter()
    toks2 = eng.generate(**request2)
    torch.cuda.synchronize()
    stats["request2_s"] = time.perf_counter() - t
    stats["request2_decode_s"] = decode_s[0] - stats["request1_decode_s"]
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    stats["k1_map_encodes"] = gemm.map_encodes() - encodes

    decoded = BATCH * (T - 1)
    stats["decode_tok_s_request1"] = decoded / stats["request1_decode_s"]
    stats["decode_tok_s_request2"] = decoded / stats["request2_decode_s"]
    stats["decode_ms_per_step"] = 1e3 * decode_s[0] / (2 * (T - 1))
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
    compare_to_eager(tag, eager, toks1, logits1, failures)
    del logits1, eager

    # The decode rates, request 2 again: eager, then replays of its graph.
    for name, graphs in (("eager", False), ("graph", True)):
        eng.graph(graphs)
        decode_s[0] = 0.0
        eng.generate(**request2)
        stats[f"{name}_decode_s"] = decode_s[0]
        stats[f"{name}_decode_tok_s"] = decoded / decode_s[0]
        stats[f"{name}_wall_ms_per_step"] = 1e3 * decode_s[0] / (T - 1)
    stats.update(graph_stats(eng))
    print(f"[{tag}] {json.dumps(stats)}", flush=True)
    profile_request = lambda: eng.generate(  # noqa: E731
        **dict(request2, max_new_tokens=PROFILE_STEPS + 1))
    prof = {}
    for name, graphs in (("eager", False), ("graph", True)):
        eng.graph(graphs)
        prof[name] = profile_decode(eng, decode_steps, profile_request, tag, groups,
                                    failures, graphs=graphs)
    print_graph_summary(tag, stats, prof)
    if stats_out is not None:
        stats_out.update(stats)
    return launches


def print_graph_summary(tag: str, stats: dict, prof: dict) -> None:
    """One line a path: the eager loop against its graphs."""
    e, g = prof["eager"], prof["graph"]
    print(f"[graph {tag}] decode tok/s eager {stats['eager_decode_tok_s']:.1f} graph "
          f"{stats['graph_decode_tok_s']:.1f} ({stats['graph_decode_tok_s'] / stats['eager_decode_tok_s']:.3f}x); "
          f"wall ms/step (no profiler) eager {stats['eager_wall_ms_per_step']:.3f} graph "
          f"{stats['graph_wall_ms_per_step']:.3f}; device busy ms/step eager "
          f"{e['busy_ms_per_step']:.3f} graph {g['busy_ms_per_step']:.3f}; idle share "
          f"(profiled) eager {e['idle_share']:.4f} graph {g['idle_share']:.4f}; kernels/step "
          f"eager {e['kernels_per_step']:.0f} graph {g['kernels_per_step']:.0f}; "
          f"{stats['graphs']} graphs captured in {stats['capture_s']:.3f} s, pool "
          f"{stats['pool_MiB']} MiB", flush=True)


def profile_decode(eng, decode_steps, request, tag: str, names, failures: list,
                   graphs: bool) -> dict:
    """One more request (``request()``, PROFILE_STEPS decode steps), its
    decode loop under torch.profiler: device-busy share of the loop's wall
    time and the kernels by device time, grouped by the kernel ``names``
    (the rest is "other"). The profiler's own host cost lengthens the wall
    time, so the idle share read here is an upper bound. Through the eager
    loop (``graphs`` False) it fails if any copy op in the loop reads half a
    layer of the unique cache or more: every kernel reads the cache in
    place. A replayed graph records no aten ops, so that gate reads the
    eager profile of the same step; the graph profile gives the kernels the
    replays ran (its table's name ends in ``_graph``). Returns wall and busy
    ms a step, idle share and kernels a step. The full table goes to
    chiprun_out/profile_decode.txt (main path) or profile_decode_<tag>.txt."""
    from hydragen_torch.utils.profiling import group_ms, kernel_table, trace_decode

    steps = PROFILE_STEPS
    if graphs:
        request()  # captures the request's decode graph, if it is not yet
    tr = trace_decode(eng, request, decode_steps, record_shapes=True)
    eng._decode_steps = decode_steps
    prof, wall = tr.prof, tr.wall_ms * 1e3
    mode = "graph" if graphs else "eager"
    if not graphs:
        layer = eng.cache.unique_k[0]
        copies = [e for e in prof.events()
                  if e.name in ("aten::copy_", "aten::clone", "aten::contiguous",
                                "aten::_to_copy")
                  and any(len(s) >= 3 and tuple(s[-3:]) == layer.shape[-3:]
                          and math.prod(s) * 2 >= layer.numel() for s in e.input_shapes)]
        print(f"[profile {tag}] copies of half a unique-cache layer (a view of "
              f"{tuple(layer.shape)}) or more in {steps} eager decode steps: {len(copies)}",
              flush=True)
        if copies:
            failures.append(f"{tag} decode copies the unique cache: "
                            f"{[(e.name, e.input_shapes) for e in copies[:4]]}")
    by_name = kernel_table(prof)
    busy = sum(us for us, _ in by_name.values())
    launched = sum(n for _, n in by_name.values())
    if not launched:
        failures.append(f"{tag} {mode} profile saw no device work")
    groups = {k: v for k, v in group_ms(by_name, names, per=steps).items() if v}
    stats = dict(wall_ms_per_step=wall / steps / 1e3, busy_ms_per_step=busy / steps / 1e3,
                 idle_share=1 - busy / wall, kernels_per_step=launched / steps, groups=groups)
    print(f"[profile {tag} {mode}] {steps} decode steps: wall {stats['wall_ms_per_step']:.3f} "
          f"ms/step, device busy {stats['busy_ms_per_step']:.3f} ms/step, idle share "
          f"{stats['idle_share']:.4f}, {stats['kernels_per_step']:.0f} kernels/step", flush=True)
    print(f"[profile {tag} {mode}] device ms/step by kernel: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(groups.items(), key=lambda x: -x[1])}),
        flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:12]:
        print(f"[profile {tag} {mode}]   {us / steps / 1e3:8.4f} ms/step {n / steps:6.1f}x  "
              f"{name[:90]}", flush=True)
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    stem = "profile_decode" if tag == "main" else f"profile_decode_{tag}"
    (out / (stem + ("_graph" if graphs else "") + ".txt")).write_text(table)
    return stats


def drive_no_sharing(args, failures: list) -> dict:
    """The no-sharing baseline against Hydragen on Llama-3-8B, one engine,
    ``bench.py:70-96``'s protocol: each arm one request of a 2,048-token
    prompt with 256 greedy completions of 64 tokens (WIPE), Hydragen over
    ``setup_caches(256, 64, [1], [2048])``, the baseline over
    ``setup_caches(256, 64 + 2,048 + 8, [1], [2048])`` with
    ``disable_hydragen=True``. Three rounds, the arms in turn, each arm's
    request after a 3-token request of its own that captures its decode
    graph, so the timed decode is replays alone: the three ratios of the
    decode rates on the host clock. The first baseline request's launches
    are counted; its tokens must equal Hydragen's. Where a bf16 tie breaks
    the other way, both arms run again on Hydragen's tokens
    (``token_overrides``) and the baseline's logits must stay within
    TOL_NOSHARE of Hydragen's at every step. The baseline's request also
    runs through the eager loop, the yardstick of its graph (tokens equal,
    logits bit-equal), and once more eagerly without logits, for its eager
    decode rate. Then 8 decode steps of the baseline are profiled, eagerly
    and through the graph. Returns the counted launches."""
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
    arms = (("hydragen", T, False), ("no-sharing", T + SHARED_LEN + 8, True))

    def setup(name, unique_len):
        eng.cache = None
        gc.collect()
        torch.cuda.empty_cache()
        eng.setup_caches(BATCH, unique_len, [1], [SHARED_LEN], kv_quant="int8")
        torch.cuda.synchronize()
        return (f"cache {kv_cache_bytes(cfg, BATCH, unique_len, [1], [SHARED_LEN], 'int8') / 1e9:.3f} GB, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    runs = {name: [] for name, _, _ in arms}
    launches = toks_of = None
    for rnd in range(3):
        for name, unique_len, nohydra in arms:
            held = setup(name, unique_len)
            eng.generate(disable_hydragen=nohydra, **dict(kw, max_new_tokens=3))
            decode_s[0] = 0.0
            cuda_lib.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            toks = eng.generate(disable_hydragen=nohydra, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if rnd == 0:
                toks_of = dict(toks_of or {}, **{name: toks})
                if nohydra:
                    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            run = dict(request_s=wall, decode_s=decode_s[0],
                       decode_tok_s=BATCH * (T - 1) / decode_s[0],
                       peak_GiB=torch.cuda.max_memory_allocated() / 2**30, **graph_stats(eng))
            runs[name].append(run)
            print(f"[{tag}] round {rnd} {name}: {held}; {json.dumps(run)}", flush=True)
    ratios = [h["decode_tok_s"] / n["decode_tok_s"]
              for h, n in zip(runs["hydragen"], runs["no-sharing"])]
    print(f"[{tag}] hydragen / no-sharing decode rate through graphs, 3 interleaved rounds: "
          + ", ".join(f"{r:.4f}" for r in ratios), flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    want = expected_launches_no_sharing(cfg.num_hidden_layers, T)
    if launches != want:
        failures.append(f"{tag} launches {launches} != expected {want}")
    th, tn = toks_of["hydragen"], toks_of["no-sharing"]
    ok = tuple(tn.shape) == (BATCH, T) and bool((tn == tn[:1]).all())
    same = bool(torch.equal(th, tn))
    print(f"[{tag}] tokens {tuple(tn.shape)}, rows alike {ok}, equal to Hydragen's: {same}",
          flush=True)
    if not ok:
        failures.append(f"{tag}: tokens {tuple(tn.shape)}, rows differ")
    if not same:
        # Both runs on Hydragen's tokens: the logits of row 0 (rows alike).
        logits = {}
        for name, unique_len, nohydra in arms:
            setup(name, unique_len)
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
    # The baseline's graph against its eager loop (the cache is the baseline's).
    baseline = dict(kw, disable_hydragen=True)
    setup("no-sharing", T + SHARED_LEN + 8)
    eager = eager_yardstick(eng, baseline)
    toks, logits = eng.generate(return_logits=True, **baseline)
    compare_to_eager(tag, eager, toks, logits, failures)
    del eager, logits
    # The baseline's eager decode rate, on the request the rounds time.
    eng.graph(False)
    decode_s[0] = 0.0
    eng.generate(**baseline)
    eager_s = decode_s[0]
    eng.graph(True)
    profile_request = lambda: eng.generate(  # noqa: E731
        **dict(baseline, max_new_tokens=PROFILE_STEPS + 1))
    prof = {}
    groups = ("flash_decode_kernel", "w8a8_kernel", "flash_kernel")
    for name, graphs in (("eager", False), ("graph", True)):
        eng.graph(graphs)
        prof[name] = profile_decode(eng, decode_steps, profile_request, "gqa_nosharing",
                                    groups, failures, graphs=graphs)
    e, g = prof["eager"], prof["graph"]
    print(f"[graph {tag}] decode tok/s eager {BATCH * (T - 1) / eager_s:.1f} graph (3 rounds) "
          + ", ".join(f"{r['decode_tok_s']:.1f}" for r in runs["no-sharing"])
          + f"; wall ms/step (no profiler) eager {1e3 * eager_s / (T - 1):.3f} graph (3 rounds) "
          + ", ".join(f"{1e3 * r['decode_s'] / (T - 1):.3f}" for r in runs["no-sharing"])
          + f"; device busy ms/step eager {e['busy_ms_per_step']:.3f} graph "
          f"{g['busy_ms_per_step']:.3f}; idle share (profiled) eager {e['idle_share']:.4f} "
          f"graph {g['idle_share']:.4f}; kernels/step eager {e['kernels_per_step']:.0f} graph "
          f"{g['kernels_per_step']:.0f}; graphs {json.dumps(graph_stats(eng))}", flush=True)
    return launches


# The load phase: a HF-layout checkpoint of the main path's model, written
# here as safetensors shards and loaded through HydragenLlama.from_pretrained.
LOAD_LAYERS = 32  # depth of the written checkpoint: cut this, never the width
LOAD_SHARDS = 5
LOAD_PEAK_RATIO = 1.05  # device peak during the load over the loaded params' bytes
# The hierarchy ablation: one prompt, suffixes over it, samples of each.
ABLATION_PROMPT, ABLATION_SUFFIXES, ABLATION_SUFFIX_LEN = 1024, 16, 128
ABLATION_SAMPLES, ABLATION_NEW_TOKENS = 16, 32
_HF_PROJ = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
            "wo": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}
_SAFETENSORS_NAMES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def hf_state_dict(cfg, g) -> dict:
    """The float weights of ``cfg`` drawn on the card from ``g`` as
    ``init_params`` draws them, under HF Llama's names and in its ``[out,
    in]`` layout, on the host."""
    from hydragen_torch.models.llama import init_params

    p = init_params(cfg, g, device="cuda")
    lp = p["layers"]
    sd = {"model.embed_tokens.weight": p["embed_tokens"], "model.norm.weight": p["final_norm"],
          "lm_head.weight": p["lm_head"].t()}
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = lp["input_norm"][i]
        sd[pre + "post_attention_layernorm.weight"] = lp["post_attn_norm"][i]
        for k, name in _HF_PROJ.items():
            sd[f"{pre}{name}.weight"] = lp[k][i].t()
    return {k: v.contiguous().cpu() for k, v in sd.items()}


def write_hf_checkpoint(directory: Path, cfg, state: dict, shards: int) -> int:
    """HF's layout of a Llama checkpoint under ``directory``: ``config.json``
    and the tensors of ``state`` in order, as ``shards`` safetensors files of
    about equal size (an 8-byte little-endian header length, a JSON header
    padded to 8 bytes, the raw tensors) with ``model.safetensors.index.json``.
    Returns the bytes of the weight files."""
    import struct

    directory.mkdir(parents=True, exist_ok=True)
    sizes = {k: t.numel() * t.element_size() for k, t in state.items()}
    total = sum(sizes.values())
    groups, acc = [[]], 0
    for name in state:
        if acc >= len(groups) * total / shards and len(groups) < shards:
            groups.append([])
        groups[-1].append(name)
        acc += sizes[name]
    weight_map, written = {}, 0
    for s, group in enumerate(groups):
        fname = f"model-{s + 1:05d}-of-{len(groups):05d}.safetensors"
        header, off = {}, 0
        for name in group:
            t = state[name]
            header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                            "data_offsets": [off, off + sizes[name]]}
            off += sizes[name]
            weight_map[name] = fname
        head = json.dumps(header, separators=(",", ":")).encode()
        head += b" " * (-len(head) % 8)
        with open(directory / fname, "wb") as f:
            f.write(struct.pack("<Q", len(head)))
            f.write(head)
            for name in group:
                f.write(state[name].contiguous().reshape(-1).view(torch.uint8).numpy())
        written += 8 + len(head) + off
    (directory / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1))
    (directory / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings, "torch_dtype": cfg.dtype,
    }, indent=1))
    return written


def expected_launches_load(L: int, T: int, mesh: str = "") -> dict:
    """Request 1 of the main path on the HF-loaded model: a shared prefill
    (7L GEMMs, L causal flash) and T-1 decode steps (7L GEMMs, L level
    reads, L unique reads each), every GEMM on K1's f32-scale
    instantiation; K8 and K9 in each of the T forwards, K8 under ``mesh``."""
    return {
        "w8a8_matmul_cached_f32_scales": 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1),
        "decode_attention_cached": L * (T - 1),
        "flash_attention_bhsd": L,
        **expected_k8(L, T, mesh),
        "rope_kv_quant": L * T,
    }


# Step (e) of the load phase: two gloo ranks load the written checkpoint at
# tp=2 and decode request 1 on the meshless engine's tokens for this many.
TP2_LOAD_TOKENS = 8
# A rank's host peak over the load: at most its own parameter bytes, two f32
# copies of the largest tensor the loader quantizes whole (the transient of
# one layer: its f32 copy and its quotients) and this much more.
TP2_LOAD_SLACK = 2**30


def host_rss() -> int:
    """This process's resident bytes (``VmRSS`` of ``/proc/self/status``,
    which every kernel reports; ``RssAnon`` is not always there). The
    loader reads its checkpoint into fresh buffers, never through a memory
    map, so over a load this counts its heap: the kept slices and the
    transients."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS line")


class HostPeak:
    """Inside the block, a thread samples ``host_rss()`` every 5 ms: ``base``
    is its value on entry, ``peak`` the largest seen (``peak - base`` is what
    the block added at its worst)."""

    def __enter__(self):
        self.base = self.peak = host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, host_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss())
        return False


def param_digests(params) -> dict:
    """``{dotted name: dtype, shape and a BLAKE2b digest of the bytes}`` of a
    parameter dict, so that two processes compare parameters bit for bit
    without moving them."""
    from hydragen_torch.models.checkpoint import flatten

    out = {}
    for name, t in flatten(params).items():
        t = t.detach().contiguous()
        h = hashlib.blake2b(t.reshape(-1).view(torch.uint8).cpu().numpy(), digest_size=16)
        out[name] = f"{t.dtype} {tuple(t.shape)} {h.hexdigest()}"
    return out


def load_rank(rank: int, world: int, path: str, prompt, forced, seed: int) -> dict:
    """One of step (e)'s two gloo ranks on the card:
    ``HydragenLlama.from_pretrained_tp(path, tp=2, quantization="w8a8")``
    with its host's resident bytes sampled over the load, its parameters'
    digests and bytes, then request 1 through the eager loop on the tokens
    ``forced`` for ``TP2_LOAD_TOKENS`` steps: row 0's logits a step, the
    launches and the collectives."""
    from hydragen_torch import HydragenLlama
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.parallel import mesh as mesh_lib

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.empty(1, device="cuda")  # the CUDA context is not the load's
    t = time.perf_counter()
    with HostPeak() as rss:
        eng = HydragenLlama.from_pretrained_tp(path, tp=2, quantization="w8a8",
                                               device="cuda:0")
        torch.cuda.synchronize()
    out = dict(load_s=time.perf_counter() - t, host_peak_bytes=rss.peak - rss.base,
               host_param_bytes=eng.load_stats["host_param_bytes"],
               param_bytes=param_bytes(eng.params), digests=param_digests(eng.params))
    T = TP2_LOAD_TOKENS
    eng.setup_caches(BATCH, SUFFIX_LEN + T, [1], [SHARED_LEN], kv_quant="int8")
    cuda_lib.reset_launches()
    mesh_lib.reset_collectives()
    _, logits = eng.generate(return_logits=True,
                             token_overrides=torch.as_tensor(forced).cuda(),
                             **dict(request1(torch.as_tensor(prompt).cuda(), seed),
                                    max_new_tokens=T))
    out.update(launches={k: v for k, v in cuda_lib.LAUNCHES.items() if v},
               collectives=dict(mesh_lib.COLLECTIVES),
               logits0=torch.stack([x[0].float() for x in logits]))
    return out


def drive_tp2_load(args, failures: list, eng, hf_dir: Path, request: dict,
                   meshless_peak: int) -> dict:
    """Step (e) of the load phase, over the checkpoint before it is deleted:
    the meshless engine ``eng`` (the load's, bit-equal to it) decodes
    ``request`` for ``TP2_LOAD_TOKENS`` steps; two gloo ranks sharing the card
    load the directory at tp=2 and decode it on those tokens. Gates on each
    rank: its parameters' digests equal those of ``shard_params`` of the
    meshless parameters, its parameter bytes (and what the loader allocated
    to keep) the sharding rules' for a loaded model, its host's peak over the
    load at most its parameter bytes + 2 x the largest f32 tensor quantized
    whole + ``TP2_LOAD_SLACK``, exact launches (K1 on f32 scales at the
    rank's shapes) and collectives, and row 0's logits within TOL_NOSHARE of
    the meshless engine's at every step. Returns rank 0's launches."""
    from hydragen_torch.parallel import launch, shard_params
    from hydragen_torch.parallel.mesh import Mesh

    tag, cfg, T = "load tp2-load", eng.config, TP2_LOAD_TOKENS
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    eng.setup_caches(BATCH, SUFFIX_LEN + T, [1], [SHARED_LEN], kv_quant="int8")
    toks, logits = eng.generate(return_logits=True, **dict(request, max_new_tokens=T))
    ref = [x[0].float().cpu() for x in logits]
    del logits
    want = []
    for r in range(2):
        m = Mesh(tp=2, dp=1, sp=1, rank=r, coords=dict(dp=0, sp=0, tp=r), groups={},
                 device=torch.device("cuda"), backend="gloo")
        sliced = shard_params(eng.params, cfg, m, "cuda")
        want.append(param_digests(sliced))
        del sliced
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = launch(load_rank, 2, str(hf_dir), request["input_ids"][0].cpu(), toks.cpu(),
                   args.seed, backend="gloo", timeout=PAR_TIMEOUT)
    ranks_s = time.perf_counter() - t1
    want_l = expected_launches_load(L, T, "tp")
    want_c = expected_collectives_request1("tp2", L, T)
    want_b = expected_param_bytes(cfg, 2, loaded=True)
    largest_f32 = 4 * cfg.hidden_size * max(cfg.vocab_size, cfg.intermediate_size,
                                            cfg.num_attention_heads * cfg.head_dim)
    stats = dict(meshless_host_peak_GiB=meshless_peak / 2**30, ranks_s=ranks_s)
    for r, res in enumerate(ranks):
        unequal = sorted(k for k in want[r] if res["digests"].get(k) != want[r][k])
        same = not unequal and set(res["digests"]) == set(want[r])
        limit = res["param_bytes"] + 2 * largest_f32 + TP2_LOAD_SLACK
        worst = max(rms_rel(torch.as_tensor(a), b) for a, b in zip(res["logits0"], ref))
        ok = (same and res["param_bytes"] == want_b == res["host_param_bytes"]
              and res["host_peak_bytes"] <= limit and res["launches"] == want_l
              and res["collectives"] == want_c and len(res["logits0"]) == len(ref) == T
              and worst <= TOL_NOSHARE)
        print(f"[{tag}] rank {r}: from_pretrained_tp(tp=2, w8a8) {res['load_s']:.2f} s; params "
              f"bit-equal to shard_params of the meshless load's {same} ({len(want[r])} "
              f"tensors{', differ: ' + str(unequal[:4]) if unequal else ''}); param bytes "
              f"{res['param_bytes']}, the loader's {res['host_param_bytes']} (rules {want_b}); "
              f"host peak over the load {res['host_peak_bytes'] / 2**30:.3f} GiB (limit "
              f"{limit / 2**30:.3f}; the meshless load's "
              f"{meshless_peak / 2**30:.3f}); launches {json.dumps(res['launches'])} (want "
              f"{json.dumps(want_l)}), collectives {json.dumps(res['collectives'])} (want "
              f"{json.dumps(want_c)}); forced-stream logits {worst:.4g} from the meshless "
              f"engine's (tol {TOL_NOSHARE}) -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{tag} rank {r}: params equal {same}, bytes {res['param_bytes']} / "
                            f"{res['host_param_bytes']} (want {want_b}), host peak "
                            f"{res['host_peak_bytes']} (limit {limit}), launches "
                            f"{res['launches']}, collectives {res['collectives']}, rms {worst:.4g}")
        stats[f"rank{r}"] = dict(load_s=res["load_s"],
                                 host_peak_GiB=res["host_peak_bytes"] / 2**30,
                                 param_GiB=res["param_bytes"] / 2**30, forced_rms=worst)
    stats["step_s"] = time.perf_counter() - t0
    print(f"[{tag}] {json.dumps(stats)}", flush=True)
    return ranks[0]["launches"]


def drive_load(args, failures: list) -> dict:
    """Checkpoint loading at the main path's configuration (Llama-2-7B width,
    ``LOAD_LAYERS`` layers, w8a8 + int8 KV):

    1. the bf16 weights, drawn from ``--seed``, written as a HF checkpoint of
       ``LOAD_SHARDS`` safetensors shards with an index under ``build/``;
    2. ``HydragenLlama.from_pretrained(dir, quantization="w8a8")`` on the
       card. Gates: the loaded params equal the host quantizers' output on the
       in-memory dict bit for bit (f32 scales, the MLP unpadded), and the
       device's peak allocation during the load is at most LOAD_PEAK_RATIO
       times the params' bytes;
    3. request 1 of the main path through the graphs, K1 on f32 column
       scales at N = K = 11,008: exact launches, tokens in range, logits
       finite, graph equal to eager bit for bit;
    4. ``save_checkpoint``, then ``load_checkpoint`` into a new engine and the
       same request: tokens and every step's logits equal bit for bit;
    5. the hierarchy ablation on the loaded model (a 1,024-token prompt, 16
       suffixes of 128 tokens, 16 greedy samples each: 256 rows, 32 new
       tokens), with ``disable_hierarchy`` False, then True: tokens equal,
       or, where a bf16 tie breaks them, forced-stream logits within
       TOL_NOSHARE (RMS, relative) at every step;
    6. (e) ``tp2-load``: the directory over two ranks (``drive_tp2_load``).

    The directory is deleted at the end. Returns request 1's launches and
    step (e)'s rank 0's."""
    import shutil

    from hydragen_torch import HydragenLlama, SharedCacheOp
    from hydragen_torch.models import hf
    from hydragen_torch.models.checkpoint import flatten, load_checkpoint, save_checkpoint
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.ops import cuda_lib

    tag, T = "load", NEW_TOKENS
    cfg = dataclasses.replace(PRESETS["llama-2-7b"], num_hidden_layers=LOAD_LAYERS)
    L = cfg.num_hidden_layers
    g = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    root = Path(__file__).resolve().parent / "build" / "load_phase"
    shutil.rmtree(root, ignore_errors=True)
    stats = {}
    try:
        t = time.perf_counter()
        state = hf_state_dict(cfg, g)
        torch.cuda.empty_cache()
        stats["draw_s"] = time.perf_counter() - t
        t = time.perf_counter()
        stats["bytes_written"] = write_hf_checkpoint(root / "hf", cfg, state, LOAD_SHARDS)
        stats["write_s"] = time.perf_counter() - t

        # 2. The load, its conversion (the file reads and the
        # host quantization) timed apart.
        convert, quant_s = hf.params_from_hf_state_dict, [0.0]

        def timed_convert(*a, **kw):
            t0 = time.perf_counter()
            out = convert(*a, **kw)
            quant_s[0] += time.perf_counter() - t0
            return out

        hf.params_from_hf_state_dict = timed_convert
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            t = time.perf_counter()
            with HostPeak() as rss:
                eng = HydragenLlama.from_pretrained(root / "hf", quantization="w8a8")
                torch.cuda.synchronize()
            stats["load_s"] = time.perf_counter() - t
        finally:
            hf.params_from_hf_state_dict = convert
        stats["host_peak_bytes"] = rss.peak - rss.base
        stats["read_and_convert_s"] = quant_s[0]
        stats["bytes_read"] = hf.checkpoint_bytes(root / "hf")
        loaded = flatten(eng.params)
        stats["params_bytes"] = sum(x.numel() * x.element_size() for x in loaded.values())
        stats["device_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        ratio = stats["device_peak_bytes"] / stats["params_bytes"]
        ok = ratio <= LOAD_PEAK_RATIO and eng.config == cfg
        print(f"[{tag}] {cfg.num_hidden_layers} layers of llama-2-7b width: drawn in "
              f"{stats['draw_s']:.2f} s, {stats['bytes_written'] / 1e9:.3f} GB written as "
              f"{LOAD_SHARDS} safetensors shards in {stats['write_s']:.2f} s; from_pretrained "
              f"(w8a8) load_s {stats['load_s']:.2f}, bytes read {stats['bytes_read']}, of it the "
              f"reads and host quantization {stats['read_and_convert_s']:.2f} s; device peak "
              f"{stats['device_peak_bytes']} B = {ratio:.4f} x the params' "
              f"{stats['params_bytes']} B (tol {LOAD_PEAK_RATIO}); config as written "
              f"{eng.config == cfg} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{tag}: device peak {ratio:.4f} x the params, config "
                            f"{eng.config} (wrote {cfg})")
        # The host quantizers alone: the same conversion of the in-memory dict.
        t = time.perf_counter()
        ref = flatten(hf.params_from_hf_state_dict(state, cfg, "w8a8"))
        stats["host_quantize_s"] = time.perf_counter() - t
        del state
        t = time.perf_counter()
        unequal = sorted(k for k in ref if k not in loaded or loaded[k].dtype != ref[k].dtype
                         or not torch.equal(loaded[k].cpu(), ref[k]))
        scales = {str(loaded[k].dtype) for k in loaded if k.endswith(".scale")}
        ok = not unequal and set(loaded) == set(ref) and scales == {"torch.float32"} \
            and loaded["layers.gate.q"].shape[1] == cfg.intermediate_size
        print(f"[{tag}] loaded params against the host quantizers on the in-memory dict: "
              f"{len(ref) - len(unequal)} of {len(ref)} tensors bit-equal (host quantization of the "
              f"in-memory dict alone {stats['host_quantize_s']:.2f} s), weight scales "
              f"{sorted(scales)}, MLP width {loaded['layers.gate.q'].shape[1]} (unpadded); "
              f"checked in {time.perf_counter() - t:.2f} s -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"{tag}: loaded params differ from the host quantizers' "
                            f"{unequal[:6]}, scales {scales}")
        del ref, loaded
        gc.collect()

        # 3. Request 1 of the main path through the graphs, eager first.
        prompt = torch.randint(1, cfg.vocab_size, (1, SHARED_LEN), generator=g, device="cuda")
        request1 = dict(input_ids=[prompt], num_return_sequences=BATCH, max_new_tokens=T,
                        temperature=0.0, shared_cache_op=SharedCacheOp.WIPE, seed=args.seed)
        eng.setup_caches(BATCH, SUFFIX_LEN + T, [1], [SHARED_LEN], kv_quant="int8")
        _, decode_s = time_decode_loop(eng)
        eager = eager_yardstick(eng, request1)
        decode_s[0] = 0.0
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks1, logits1 = eng.generate(return_logits=True, **request1)
        torch.cuda.synchronize()
        stats["request1_s"] = time.perf_counter() - t
        stats["request1_decode_tok_s"] = BATCH * (T - 1) / decode_s[0]
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        want = expected_launches_load(L, T)
        print(f"[{tag}] request 1 launches {json.dumps(launches)} (expected "
              f"{json.dumps(want)}) -> {'ok' if launches == want else 'FAIL'}", flush=True)
        if launches != want:
            failures.append(f"{tag} launches {launches} != expected {want}")
        ok = (tuple(toks1.shape) == (BATCH, T) and int(toks1.min()) >= 0
              and int(toks1.max()) < cfg.vocab_size)
        finite = len(logits1) == T and all(bool(torch.isfinite(x).all()) for x in logits1)
        print(f"[{tag}] request 1 tokens {tuple(toks1.shape)} in range: {ok}; {len(logits1)} "
              f"logit steps, all finite: {finite}", flush=True)
        if not ok or not finite:
            failures.append(f"{tag} request 1: tokens {tuple(toks1.shape)} in range {ok}, "
                            f"logits finite {finite}")
        compare_to_eager(tag, eager, toks1, logits1, failures)
        logits1 = [x.cpu() for x in logits1]
        del eager

        # 4. The native checkpoint: save, reload into a new engine, the same request.
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_checkpoint(root / "native", eng.config, eng.params)
        stats["save_s"] = time.perf_counter() - t
        stats["native_bytes"] = sum(f.stat().st_size for f in (root / "native").iterdir())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        cfg2, params2 = load_checkpoint(root / "native")
        eng = HydragenLlama(cfg2, params2, quantization="w8a8")
        del params2
        torch.cuda.synchronize()
        stats["reload_s"] = time.perf_counter() - t
        eng.setup_caches(BATCH, SUFFIX_LEN + T, [1], [SHARED_LEN], kv_quant="int8")
        _, decode_s = time_decode_loop(eng)
        toks_r, logits_r = eng.generate(return_logits=True, **request1)
        same = bool(torch.equal(toks_r, toks1)) and cfg2 == cfg
        steps_equal = sum(bool(torch.equal(a.cpu(), b)) for a, b in zip(logits_r, logits1))
        ok = same and steps_equal == T == len(logits_r)
        print(f"[{tag}] native checkpoint: save_s {stats['save_s']:.2f}, "
              f"{stats['native_bytes']} B on disk, load_s {stats['reload_s']:.2f}; request 1 "
              f"again: tokens equal {same}, logit steps bit-equal {steps_equal} of {T} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{tag}: the reloaded native checkpoint differs (tokens equal "
                            f"{same}, {steps_equal} of {T} logit steps bit-equal)")
        del logits_r, logits1, toks_r

        # 5. The hierarchy ablation on the loaded model.
        aprompt = torch.randint(1, cfg.vocab_size, (1, ABLATION_PROMPT), generator=g,
                                device="cuda")
        asuffixes = torch.randint(1, cfg.vocab_size, (ABLATION_SUFFIXES, ABLATION_SUFFIX_LEN),
                                  generator=g, device="cuda")
        rows = ABLATION_SUFFIXES * ABLATION_SAMPLES
        eng.setup_caches(rows, ABLATION_SUFFIX_LEN + ABLATION_NEW_TOKENS, [1, ABLATION_SUFFIXES],
                         [ABLATION_PROMPT, ABLATION_SUFFIX_LEN], kv_quant="int8")
        kw = dict(input_ids=[aprompt, asuffixes], num_return_sequences=ABLATION_SAMPLES,
                  temperature=0.0, shared_cache_op=SharedCacheOp.WIPE, seed=args.seed)
        arms = {}
        for off in (False, True):
            eng.generate(disable_hierarchy=off, **dict(kw, max_new_tokens=3))  # captures
            decode_s[0] = 0.0
            cuda_lib.reset_launches()
            toks = eng.generate(disable_hierarchy=off, max_new_tokens=ABLATION_NEW_TOKENS, **kw)
            torch.cuda.synchronize()
            arms[off] = dict(toks=toks, decode_tok_s=rows * (ABLATION_NEW_TOKENS - 1) / decode_s[0],
                             launches={k: v for k, v in cuda_lib.LAUNCHES.items() if v})
        stats["hierarchy_decode_tok_s"] = arms[False]["decode_tok_s"]
        stats["no_hierarchy_decode_tok_s"] = arms[True]["decode_tok_s"]
        same = bool(torch.equal(arms[False]["toks"], arms[True]["toks"]))
        print(f"[{tag}] hierarchy ablation ({ABLATION_PROMPT}-token prompt, "
              f"{ABLATION_SUFFIXES} suffixes of {ABLATION_SUFFIX_LEN}, {ABLATION_SAMPLES} samples "
              f"each, {ABLATION_NEW_TOKENS} new tokens): decode tok/s through graphs, hierarchy "
              f"{stats['hierarchy_decode_tok_s']:.1f}, disable_hierarchy "
              f"{stats['no_hierarchy_decode_tok_s']:.1f}; launches hierarchy "
              f"{json.dumps(arms[False]['launches'])}, disable_hierarchy "
              f"{json.dumps(arms[True]['launches'])}; tokens equal {same}", flush=True)
        ok = tuple(arms[True]["toks"].shape) == (rows, ABLATION_NEW_TOKENS)
        if not same:
            # Both arms on the hierarchy run's tokens: every step's logits.
            forced = {}
            for off in (False, True):
                _, lg = eng.generate(disable_hierarchy=off, token_overrides=arms[False]["toks"],
                                     return_logits=True, max_new_tokens=ABLATION_NEW_TOKENS, **kw)
                forced[off] = [x.float() for x in lg]
            worst = max(rms_rel(a, b) for a, b in zip(forced[True], forced[False]))
            ok = ok and worst <= TOL_NOSHARE
            print(f"[{tag}] forced stream: largest rms distance {worst:.4g} (tol "
                  f"{TOL_NOSHARE})", flush=True)
        if not ok:
            failures.append(f"{tag}: disable_hierarchy differs from the hierarchy run")
        print(f"[{tag}] {json.dumps(stats)}", flush=True)
        # 6. (e) tp2-load, before the directory goes.
        tp2 = drive_tp2_load(args, failures, eng, root / "hf", request1,
                             stats["host_peak_bytes"])
        return launches, tp2
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The serving phase: a stream of requests through ContinuousBatcher over one
# shared prompt (scripts/serving_bench.py's traffic on the TPU side).
SERVE_REQUESTS = 640
SERVE_SUFFIX = (16, 128)  # uniform suffix lengths, inclusive
SERVE_BUDGET = (8, 64)  # uniform new-token budgets, inclusive
SERVE_CHUNK = 8
SERVE_BUCKET = 32
# The short grouped stream: 4 layers of full width, two prefixes.
GROUPED_LAYERS = 4
GROUPED_POOL = 64
GROUPED_REQUESTS = 96
GROUPED_SUFFIX = (16, 64)
GROUPED_BUDGET = (4, 24)


def expected_launches_serving(L: int, admissions: int, steps: int, mesh: str = "") -> dict:
    """Launches a stream implies, from its dispatch log: each admission
    dispatch prefills its requests' suffixes (7L s8 GEMMs, L level reads of
    the folded queries, L causal suffix reads); each decode step runs 7L
    GEMMs and L level reads, and its unique read is the plain masked ring
    read (no K3, no K5), as in the JAX package. K8 in every forward, under
    ``mesh``. No K9: an admission's KV goes to the ring by its scatter and a
    step's slot is written after its masked read, both by the chain."""
    return {
        "w8a8_matmul_cached": 7 * L * (admissions + steps),
        "flash_attention_cached_bhsd": L * (admissions + steps),
        "flash_attention_bhsd": L * admissions,
        **expected_k8(L, admissions + steps, mesh),
    }


def count_captures(eng) -> dict:
    """Wrap ``eng._capture``: the returned dict counts captures by key."""
    captures, capture = {}, eng._capture

    def counting(st, *a, **kw):
        captures[st.key] = captures.get(st.key, 0) + 1
        return capture(st, *a, **kw)

    eng._capture = counting
    return captures


def serve_stream(eng, requests, cb_kw, graphs: bool, timed: bool = False):
    """One stream through a new ``ContinuousBatcher`` over ``eng``, the
    launch counts set to 0 just before and read just after. ``timed``:
    admissions fenced by synchronizes and timed (that serializes the
    pipeline, so only the eager yardstick run times them). Returns (tokens
    by request, launches, the batcher's stats, wall s, admission s)."""
    from hydragen_torch import ContinuousBatcher
    from hydragen_torch.ops import cuda_lib

    eng.graph(graphs)
    cb = ContinuousBatcher(eng, **cb_kw)
    rids = [cb.submit(ids, max_new_tokens=n, group=grp, stop_sequences=stops)
            for ids, n, grp, stops in requests]
    admit_s = [0.0]
    if timed:
        admit = cb._admit_batch

        def timed_admit(pairs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            admit(pairs)
            torch.cuda.synchronize()
            admit_s[0] += time.perf_counter() - t

        cb._admit_batch = timed_admit
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t = time.perf_counter()
    out = cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    eng.graph(True)
    return [out.get(r) for r in rids], launches, dict(cb.stats), wall, admit_s[0], cb


def check_stream(tag: str, requests, toks, vocab: int, failures: list) -> int:
    """Every request back, with 1 to its budget tokens, all in range; a
    request with stop sequences ends at the first completed one or runs to
    its budget without one. Returns the new tokens."""
    bad = []
    for i, ((_, n, _, stops), t) in enumerate(zip(requests, toks)):
        if t is None or not 1 <= len(t) <= n or min(t) < 0 or max(t) >= vocab:
            bad.append((i, None if t is None else len(t)))
            continue
        for s in stops or ():
            s = list(s)
            ends = [j + len(s) for j in range(len(t) - len(s) + 1) if t[j:j + len(s)] == s]
            if (ends and ends[0] != len(t)) or (not ends and len(t) != n):
                bad.append((i, "stop", len(t), ends[:2]))
    ok = not bad
    print(f"[{tag}] {len(toks)} requests back, lengths within budgets, tokens in range, "
          f"stops honoured: {ok}", flush=True)
    if not ok:
        failures.append(f"{tag}: requests out of contract {bad[:6]}")
    return sum(len(t) for t in toks if t is not None)


def check_launches(tag: str, L: int, launches: dict, stats: dict, failures: list) -> None:
    want = expected_launches_serving(L, stats["admit_dispatches"], stats["decode_steps"])
    ok = launches == want
    print(f"[{tag}] dispatches {json.dumps(stats)}; launches {json.dumps(launches)} "
          f"(expected {json.dumps(want)}) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{tag} launches {launches} != expected {want}")


def check_captures(tag: str, captures: dict, keys, failures: list) -> None:
    """One capture a key: each graph stream's batcher (``keys``) captured its
    step once, and no step recaptured a graph it had."""
    ok = all(n == 1 for n in captures.values()) and all(captures.get(k) == 1 for k in keys)
    print(f"[{tag}] captures by key: {sorted(captures.values())} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failures.append(f"{tag}: a decode key captured more than once {sorted(captures.values())}")


def drive_serving(args, failures: list, card: str) -> dict:
    """``ContinuousBatcher`` at full Llama-2-7B width and depth, w8a8 +
    int8 KV, one shared level of a 2,048-token prompt, a pool of 256 rows of
    128 + 64 + 8 ring slots: a stream of 640 requests (suffixes and budgets
    uniform from ``--seed``), admitted longest budget first, decoded in
    chunks of 8 graph replays with a lookahead of 1, then the same stream
    through the eager loop (the yardstick: every request's tokens equal).
    Exact launches from the dispatch log, one capture a key, every request
    back within its budget. Then the step: ms through the graph and eagerly,
    a profile of 8 replayed steps split into K1, K2, the plain masked ring
    read and the int8 write (each timed alone at the step's shapes) and the
    rest. Then a short stream at 4 layers of full width over two prefixes
    (``sb = 2``) follows as a phase of its own (``drive_grouped_stream``).
    Returns the 7B graph stream's launches."""
    import numpy as np

    from hydragen_torch import HydragenLlama
    from hydragen_torch.core.batching import ring_mask
    from hydragen_torch.core.cache import KVWrite
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params
    from hydragen_torch.ops.reference import attention_bhsd
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    tag, cfg = "serving", PRESETS["llama-2-7b"]
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    U = SERVE_SUFFIX[1] + SERVE_BUDGET[1] + 8
    g = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    t0 = time.perf_counter()
    eng = HydragenLlama(cfg, init_params(cfg, g, quantized="w8a8", device="cuda"),
                        quantization="w8a8")
    eng.setup_caches(BATCH, U, [1], [SHARED_LEN], kv_quant="int8")
    eng.append_shared(torch.randint(1, V, (1, SHARED_LEN), generator=g, device="cuda"))
    rng = np.random.RandomState(args.seed)
    requests = [(rng.randint(1, V, (rng.randint(SERVE_SUFFIX[0], SERVE_SUFFIX[1] + 1),)),
                 int(rng.randint(SERVE_BUDGET[0], SERVE_BUDGET[1] + 1)), 0, None)
                for _ in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    print(f"[{tag}] {card}; llama-2-7b, {L} layers, w8a8 + int8 KV, pool {BATCH} rows x {U} "
          f"ring slots ({eng.cache.max_unique_seq_len} allocated), bshd "
          f"{eng.cache.unique_bshd} flat scales {eng.cache.flat_scales}; set-up "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated", flush=True)
    cb_kw = dict(chunk=SERVE_CHUNK, bucket=SERVE_BUCKET, admit_policy="lpt", lookahead=1,
                 temperature=0.0, seed=args.seed)
    captures = count_captures(eng)
    torch.cuda.reset_peak_memory_stats()
    toks, launches, stats, wall, _, cb = serve_stream(eng, requests, cb_kw, graphs=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    new_tokens = check_stream(tag, requests, toks, V, failures)
    check_launches(tag, L, launches, stats, failures)
    check_captures(tag, captures, [cb._key], failures)
    gstats = graph_stats(eng)
    print(f"[{tag}] {card}; graph stream: {SERVE_REQUESTS} requests in {wall:.3f} s: "
          f"{SERVE_REQUESTS / wall:.2f} requests/s, {new_tokens} new tokens, "
          f"{new_tokens / wall:.1f} new tokens/s; peak {peak:.2f} GiB; {gstats['graphs']} graphs "
          f"captured in {gstats['capture_s']:.3f} s, pool {gstats['pool_MiB']} MiB", flush=True)

    # The eager yardstick: the same stream through graph(False), admissions
    # and decode steps fenced and timed.
    decode_steps, decode_s = time_decode_loop(eng)
    toks_e, launches_e, stats_e, wall_e, admit_s, _ = serve_stream(
        eng, requests, cb_kw, graphs=False, timed=True)
    same = toks_e == toks
    print(f"[{tag}] {card}; eager stream (admissions and chunks fenced): {wall_e:.3f} s, "
          f"admissions {admit_s:.3f} s in {stats_e['admit_dispatches']} dispatches, decode "
          f"{decode_s[0]:.3f} s in {stats_e['decode_steps']} steps "
          f"({1e3 * decode_s[0] / max(stats_e['decode_steps'], 1):.3f} ms/step); tokens equal to "
          f"the graph stream's for every request: {same}; launches equal: "
          f"{launches_e == launches}", flush=True)
    if not same or launches_e != launches or stats_e != stats:
        failures.append(f"{tag}: eager stream differs from the graph stream (tokens equal "
                        f"{same}, stats {stats_e} vs {stats})")

    # The step: graph against eager over the finished batcher's buffers (a
    # step's work does not depend on which rows are live), then its profile.
    step_ms = {}
    for name, graphs in (("eager", False), ("graph", True)):
        eng.graph(graphs)
        decode_s[0] = 0.0
        for _ in range(2):
            cb._decode_chunk(PROFILE_STEPS)
        step_ms[name] = 1e3 * decode_s[0] / (2 * PROFILE_STEPS)
    eng.graph(True)
    eng._decode_steps = decode_steps
    prof = profile_decode(eng, decode_steps, lambda: cb._decode_chunk(PROFILE_STEPS), tag,
                          ("w8a8_kernel", "flash_kernel", "split_combine"), failures,
                          graphs=True)
    # The plain masked ring read and the int8 write of each layer, timed alone
    # on the device's clock at the step's shapes, over the engine's cache.
    cache = eng.cache
    hkv, hd = cfg.num_key_value_heads, cfg.head_dim
    q = torch.randn(BATCH, cfg.num_attention_heads, 1, hd, device="cuda", generator=g).to(
        torch.bfloat16)
    kv_tok = [torch.randn(BATCH, hkv, 1, hd, device="cuda", generator=g).to(torch.bfloat16)
              for _ in range(2)]
    mask = ring_mask(cb.state.start, cb.state.cursor, cb.U)
    Ua = cache.max_unique_seq_len

    def ring_read(li):
        return attention_bhsd(
            q, cache.unique_k[li], cache.unique_v[li], kv_mask=mask, kv_bshd=True,
            k_scale=cache.unique_k_scale[li].reshape(BATCH, Ua, hkv),
            v_scale=cache.unique_v_scale[li].reshape(BATCH, Ua, hkv))

    slot = torch.remainder(cb.state.cursor, Ua)
    ring_ms = L * cuda_graph_time_ms(Cycle(ring_read, L), iters=8, warmup=2)
    write = KVWrite.slot(cache, BATCH, slot)  # the batcher's step writes this
    write_ms = L * cuda_graph_time_ms(Cycle(lambda li: write.put(li, *kv_tok), L))
    k1 = prof["groups"].get("w8a8_kernel", 0.0)
    k2 = prof["groups"].get("flash_kernel", 0.0) + prof["groups"].get("split_combine", 0.0)
    busy = prof["busy_ms_per_step"]
    other = busy - k1 - k2 - ring_ms - write_ms
    split = dict(K1=k1, K2=k2, ring_read=ring_ms, int8_write=write_ms, other=other)
    print(f"[{tag}] {card}; decode ms/step (bs {BATCH}, {Ua} ring slots), eager "
          f"{step_ms['eager']:.3f}, graph {step_ms['graph']:.3f}; graph profile: busy "
          f"{busy:.3f}, idle share {prof['idle_share']:.4f}, {prof['kernels_per_step']:.0f} "
          f"kernels/step; device ms/step: " + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f" (ring read and int8 write timed alone, {L} layers each; ring read share of busy "
          f"{ring_ms / busy:.4f})", flush=True)
    return launches


def drive_grouped_stream(args, failures: list, card: str) -> None:
    """The short grouped stream: Llama-2-7B width at GROUPED_LAYERS layers,
    one level of two prefixes (each half of the pool decodes under its own),
    first in, first out, lookahead 2. A first graph run without stops picks
    a stop 2-gram for every third request (its own tokens 3-4); then the
    stream with those stops through graphs and eagerly: tokens equal, exact
    launches, one capture a key, stops honoured."""
    import numpy as np

    from hydragen_torch import HydragenLlama
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params

    tag = "serving grouped"
    cfg = dataclasses.replace(PRESETS["llama-2-7b"], num_hidden_layers=GROUPED_LAYERS)
    V = cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(args.seed + 4)
    eng = HydragenLlama(cfg, init_params(cfg, g, quantized="w8a8", device="cuda"),
                        quantization="w8a8")
    U = GROUPED_SUFFIX[1] + GROUPED_BUDGET[1] + 8
    eng.setup_caches(GROUPED_POOL, U, [2], [SHARED_LEN], kv_quant="int8")
    eng.append_shared(torch.randint(1, V, (2, SHARED_LEN), generator=g, device="cuda"))
    rng = np.random.RandomState(args.seed + 1)
    requests = [(rng.randint(1, V, (rng.randint(GROUPED_SUFFIX[0], GROUPED_SUFFIX[1] + 1),)),
                 int(rng.randint(GROUPED_BUDGET[0], GROUPED_BUDGET[1] + 1)), i % 2, None)
                for i in range(GROUPED_REQUESTS)]
    cb_kw = dict(chunk=SERVE_CHUNK, bucket=SERVE_BUCKET, admit_policy="fifo", lookahead=2,
                 temperature=0.0, seed=args.seed)
    captures = count_captures(eng)
    plain, *_, cb0 = serve_stream(eng, requests, cb_kw, graphs=True)
    requests = [(ids, n, grp, [t[2:4]] if i % 3 == 0 and t and len(t) >= 4 else None)
                for i, ((ids, n, grp, _), t) in enumerate(zip(requests, plain))]
    toks, launches, stats, wall, _, cb = serve_stream(eng, requests, cb_kw, graphs=True)
    new_tokens = check_stream(tag, requests, toks, V, failures)
    check_launches(tag, GROUPED_LAYERS, launches, stats, failures)
    toks_e, launches_e, stats_e, wall_e, _, _ = serve_stream(eng, requests, cb_kw,
                                                             graphs=False)
    check_captures(tag, captures, [cb0._key, cb._key], failures)
    same = toks_e == toks
    stopped = sum(1 for (_, n, _, s), t in zip(requests, toks) if s and t and len(t) < n)
    print(f"[{tag}] {card}; {GROUPED_LAYERS} layers, pool {GROUPED_POOL} over 2 prefixes: "
          f"{GROUPED_REQUESTS} requests, {sum(1 for r in requests if r[3])} with a stop "
          f"2-gram, {stopped} stopped by it; graph {wall:.3f} s ({GROUPED_REQUESTS / wall:.2f} "
          f"requests/s, {new_tokens / wall:.1f} new tokens/s), eager {wall_e:.3f} s; tokens "
          f"equal graph vs eager: {same}; launches equal: {launches_e == launches}", flush=True)
    if not same or launches_e != launches or stats_e != stats:
        failures.append(f"{tag}: eager stream differs from the graph stream (tokens equal "
                        f"{same}, stats {stats_e} vs {stats})")


@contextlib.contextmanager
def only_kernel(keep: str | None):
    """Within the block, every kernel wrapper but ``keep`` is replaced by its
    plain version (module attributes, which the model reads at call time);
    ``keep=None`` leaves them all on the kernel. K8's three entries and K9
    are among the others: a run of one kernel alone takes the plain chains
    for the s8 activations, RoPE and the int8 KV writes too."""
    from hydragen_torch.ops import act, decode, flash, gemm, rope

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
        "rms_norm_quant": (act, "rms_norm_quant", act.rms_norm_quant_plain),
        "silu_mul_quant": (act, "silu_mul_quant", act.silu_mul_quant_plain),
        "quantize_rows": (gemm, "quantize_rows", gemm.quantize_rows_plain),
        "rope_kv_quant": (rope, "rope_kv_quant", rope.rope_kv_quant_plain),
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
    run. K8 runs in the "kernel" run and has no run alone: its norm's sum of
    squares, taken in another order, moves a code where it ties, and such a
    drift alone read 1.283 times the plain run's RMS at the int4 path's
    step 0 (the run of all kernels 0.863 times); ``check_k8`` holds K8 to
    the plain chains exactly."""
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


# Phase parallel: two ranks sharing the card over gloo, (a) tp=2 and (d)
# tp=2 with int4 weights at PAR_TP2_LAYERS layers, (b) sp=2 at PAR_SP_LAYERS
# layers (full width; each cut from 32 so that the whole run stays near 900
# s), and (c) one rank of an NCCL mesh at full depth through the decode
# graphs.
PAR_TP2_LAYERS = 16
PAR_SP_LAYERS = 8
PAR_TIMEOUT = 600.0  # seconds a spawn may take, its set-up included


def expected_launches_request1(L: int, T: int, int4: bool = False, mesh: str = "") -> dict:
    """Request 1 of the main path alone: a shared prefill (7L GEMMs, L causal
    flash) and T-1 decode steps (7L GEMMs, L level reads, L unique reads).
    With ``int4`` (case (d), w4a8 at tp=2): the five column-parallel
    projections a layer on K6, o and down on the weight-only product, no K1.
    K8 in each of the T forwards, under ``mesh`` (``expected_k8``), and K9
    a layer in each (the KV is int8 under every mesh)."""
    gemm = {"w4a8_matmul_cached": 5 * L * T} if int4 else {"w8a8_matmul_cached": 7 * L * T}
    return {
        **gemm,
        "flash_attention_cached_bhsd": L * (T - 1),
        "decode_attention_cached": L * (T - 1),
        "flash_attention_bhsd": L,
        **expected_k8(L, T, mesh),
        "rope_kv_quant": L * T,
    }


def expected_collectives_request1(kind: str, L: int, T: int) -> dict:
    """The counted collectives of request 1 on each rank. tp: two sum
    all-reduces a layer (o, down) and one all-gather of the logits, in the
    prefill and in each of the T-1 steps. sp: each decode layer's level read
    merges its two halves (one max and one sum all-reduce); the prefill reads
    no level."""
    if kind == "sp2":
        return {"all_reduce_sum": L * (T - 1), "all_reduce_max": L * (T - 1), "all_gather": 0}
    return {"all_reduce_sum": 2 * L * T, "all_reduce_max": 0, "all_gather": T}


def expected_param_bytes(cfg, tp: int, int4: bool = False, loaded: bool = False) -> int:
    """A rank's parameter bytes under the sharding rules, from the shapes:
    ``init_params(quantized="w8a8")``'s bf16 embedding and norms, int8
    payloads with bf16 column scales, the MLP padded to 11,264; q/k/v,
    gate/up and the LM head split on their columns, o and down on their
    rows (their scales whole). With ``int4`` (``quantized="w4a8"``): the
    projections planar int4 (K/2 bytes a row) with bf16 scales a 128-wide
    group, a column family's cut on N, a row family's on K with its groups
    (or, where tp does not divide them, the subgroups of the rank's K
    slice); the LM head int8 as above. With ``loaded`` (the HF loader's
    w8a8): f32 column scales and the MLP unpadded."""
    H, V, L, hd = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers, cfg.head_dim
    I = cfg.intermediate_size if loaded else -(-cfg.intermediate_size // 512) * 512
    sb = 4 if loaded else 2  # bytes of a column scale
    Hq, Hkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    n = V * H * 2 + H * 2 + (V // tp) * (H + sb) + 2 * L * H * 2
    for N, K, column in ((Hq, H, True), (Hkv, H, True), (Hkv, H, True), (H, Hq, False),
                         (I, H, True), (I, H, True), (H, I, False)):
        if not int4:
            n += L * (N // tp) * (K + sb) if column else L * N * (K // tp + sb)
            continue
        g = math.gcd(K // 2, 128)
        if column:
            n += L * (N // tp) * (K // 2 + 2 * (K // g))
        else:
            k = K // tp
            groups = K // g // tp if (K // g) % tp == 0 else k // math.gcd(g, k)
            n += L * N * (k // 2 + 2 * groups)
    return n


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(t.numel() * t.element_size() for t in tree)
    return tree.numel() * tree.element_size()


def parallel_config(kind: str):
    """Llama-2-7B at the depth of case ``kind``: the gloo cases cut (the
    full depth for ``"nccl"`` and ``--tp4``'s ``"tp4"``)."""
    from hydragen_torch.models.config import PRESETS

    cfg = PRESETS["llama-2-7b"]
    L = {"sp2": PAR_SP_LAYERS, "tp2": PAR_TP2_LAYERS, "tp2-int4": PAR_TP2_LAYERS}.get(kind)
    return cfg if L is None else dataclasses.replace(cfg, num_hidden_layers=L)


def parallel_engine(kind: str, seed: int, mesh=None):
    """The main path's engine (w8a8, int8 KV, request 1's cache; w4a8 for
    case (d) "tp2-int4") over ``mesh`` (None: meshless), with its prompt: the
    weights drawn from ``seed`` on the card as the main path draws them,
    then sliced for the rank, the global draw freed before the request."""
    from hydragen_torch import HydragenLlama
    from hydragen_torch.models.llama import init_params

    cfg = parallel_config(kind)
    quant = "w4a8" if kind == "tp2-int4" else "w8a8"
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, g, quantized=quant, device="cuda")
    eng = HydragenLlama(cfg, params, quantization=quant, mesh=mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eng.setup_caches(BATCH, SUFFIX_LEN + NEW_TOKENS, [1], [SHARED_LEN], kv_quant="int8")
    prompt = torch.randint(1, cfg.vocab_size, (1, SHARED_LEN), generator=g, device="cuda")
    return eng, prompt


def request1(prompt, seed: int) -> dict:
    from hydragen_torch import SharedCacheOp

    return dict(input_ids=[prompt], num_return_sequences=BATCH, max_new_tokens=NEW_TOKENS,
                temperature=0.0, shared_cache_op=SharedCacheOp.WIPE, seed=seed)


def parallel_rank(rank: int, world: int, kind: str, seed: int) -> dict:
    """One rank of phase parallel's (a) ``kind="tp2"``, (b) ``"sp2"`` or (d)
    ``"tp2-int4"``: two ranks on the one card over gloo, request 1 through
    the eager loop; or
    of ``--tp4``'s ``"tp4"``: four ranks on four cards over NCCL, request 1
    eagerly and then through the decode graphs.
    Returns its tokens, row 0's logits a step, launch and collective counts,
    parameter bytes, device peaks and times; the decode loop's collectives
    are timed by ``mesh.timed_collectives`` (host staging, transfer and the
    wait for the other rank, after a synchronize that leaves this rank's
    queued kernels out)."""
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.parallel import make_mesh
    from hydragen_torch.parallel import mesh as mesh_lib

    dev = f"cuda:{rank}" if kind == "tp4" else "cuda:0"
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(sp=2, device=dev) if kind == "sp2" else make_mesh(tp=world, device=dev)
    t_rank = time.perf_counter()

    def reached(stage):  # where a rank is, should a run stall
        print(f"[parallel {kind}] rank {rank}: {stage} at "
              f"{time.perf_counter() - t_rank:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng, prompt = parallel_engine(kind, seed, mesh)
    torch.cuda.synchronize()
    reached("engine ready")
    out = dict(setup_s=time.perf_counter() - t, param_bytes=param_bytes(eng.params),
               draw_peak_GiB=torch.cuda.max_memory_allocated() / 2**30,
               graphs=eng.graphs_enabled)
    decode_s = [0.0]
    steps = eng._decode_steps

    def timed_steps(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mesh_lib.timed_collectives():
            try:
                return steps(*a, **kw)
            finally:
                torch.cuda.synchronize()
                decode_s[0] += time.perf_counter() - t

    eng._decode_steps = timed_steps
    eng.graph(False)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    mesh_lib.reset_collectives()
    t = time.perf_counter()
    toks, logits = eng.generate(return_logits=True, **request1(prompt, seed))
    torch.cuda.synchronize()
    reached("eager request done")
    out.update(
        request_s=time.perf_counter() - t, decode_s=decode_s[0],
        collective_s=mesh_lib.COLLECTIVE_SECONDS[0],
        launches={k: v for k, v in cuda_lib.LAUNCHES.items() if v},
        collectives=dict(mesh_lib.COLLECTIVES),
        request_peak_GiB=torch.cuda.max_memory_allocated() / 2**30,
        toks=toks, logits0=torch.stack([x[0].float() for x in logits]),
        finite=all(bool(torch.isfinite(x).all()) for x in logits),
        local=dict(heads=eng.cache.unique_k.shape[3], level_tokens=eng.cache.shared[0].k.shape[3],
                   wq=list(eng.params["layers"]["wq"][0].shape)),
    )
    if kind == "tp4":  # the same request through the graphs: bit for bit
        eager = (toks.cpu(), [x.cpu() for x in logits])
        del logits
        eng.graph(True)
        for name in ("graph_first", "graph"):  # the first captures its step
            decode_s[0] = 0.0
            cuda_lib.reset_launches()
            mesh_lib.reset_collectives()
            toks_g, logits_g = eng.generate(return_logits=True, **request1(prompt, seed))
            out[f"{name}_decode_s"] = decode_s[0]
            reached(f"{name} request done")
        out["graph_launches"] = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        out["graph_collectives"] = dict(mesh_lib.COLLECTIVES)
        out["graph_eq_eager"] = bool(torch.equal(toks_g.cpu(), eager[0])) and all(
            torch.equal(a.cpu(), b) for a, b in zip(logits_g, eager[1]))
    return out


def nccl_rank(rank: int, world: int, seed: int) -> dict:
    """Phase parallel (c): a one-rank NCCL mesh (``keep_trivial``: its tp
    collectives run over the one rank) at full width and depth. Request 1
    through the eager loop, then through the decode graphs (one captured
    step holding its NCCL all-reduces and all-gather), then the meshless
    engine on the same weights through its graphs. Returns whether tokens
    and every step's logits are equal bit for bit, the counts and the
    captured step's collectives."""
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.parallel import make_mesh
    from hydragen_torch.parallel import mesh as mesh_lib

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(tp=1, device="cuda:0", keep_trivial=True)
    eng, prompt = parallel_engine("nccl", seed, mesh)
    req = request1(prompt, seed)
    runs = {}
    for name, graphs in (("eager", False), ("graph", True)):
        eng.graph(graphs)
        cuda_lib.reset_launches()
        mesh_lib.reset_collectives()
        toks, logits = eng.generate(return_logits=True, **req)
        runs[name] = (toks.cpu(), [x.cpu() for x in logits],
                      {k: v for k, v in cuda_lib.LAUNCHES.items() if v},
                      dict(mesh_lib.COLLECTIVES))
    step = [st for st in eng._decode.values() if st.graph is not None]
    captured = dict(step[0].collectives) if step else {}
    graphs = eng.graphs_enabled
    del eng, prompt
    gc.collect()
    torch.cuda.empty_cache()
    eng, prompt = parallel_engine("nccl", seed)
    toks, logits = eng.generate(return_logits=True, **request1(prompt, seed))
    runs["meshless"] = (toks.cpu(), [x.cpu() for x in logits], {}, {})

    def same(a, b):
        return bool(torch.equal(runs[a][0], runs[b][0])) and all(
            torch.equal(x, y) for x, y in zip(runs[a][1], runs[b][1])) and len(
            runs[a][1]) == len(runs[b][1])

    return dict(graph_eq_eager=same("graph", "eager"), graph_eq_meshless=same("graph", "meshless"),
                launches=runs["graph"][2], collectives=runs["graph"][3],
                eager_collectives=runs["eager"][3], captured=captured, graphs=graphs,
                steps=len(runs["graph"][1]))


# K8's count under each case's mesh (``expected_k8``): sp=2 splits no projection.
PARALLEL_K8_MESH = {"tp2": "tp", "sp2": "", "tp2-int4": "tp-int4", "tp4": "tp"}


def drive_parallel_case(args, failures: list, card: str, kind: str) -> dict:
    """One two-rank case of phase parallel ((a) "tp2", (b) "sp2", (d)
    "tp2-int4"), or ``--tp4``'s four: spawn the ranks, hold their gates,
    then the meshless engine here on the same weights and token stream.
    Returns rank 0's launches."""
    from hydragen_torch.parallel import launch

    T = NEW_TOKENS
    t = time.perf_counter()
    world = 4 if kind == "tp4" else 2
    ranks = launch(parallel_rank, world, kind, args.seed,
                   backend="nccl" if kind == "tp4" else "gloo", timeout=PAR_TIMEOUT)
    cfg = parallel_config(kind)
    L = cfg.num_hidden_layers
    tag = f"parallel {kind}"
    int4 = kind == "tp2-int4"
    want_l = expected_launches_request1(L, T, int4, PARALLEL_K8_MESH[kind])
    want_c = expected_collectives_request1(kind, L, T)
    want_b = expected_param_bytes(cfg, {"sp2": 1, "tp4": 4}.get(kind, 2), int4)
    for r, res in enumerate(ranks):
        print(f"[{tag}] rank {r}: local {json.dumps(res['local'])}, launches "
              f"{json.dumps(res['launches'])}, collectives {json.dumps(res['collectives'])}, "
              f"param bytes {res['param_bytes']} (rules {want_b}), device peak "
              f"{res['request_peak_GiB']:.2f} GiB in the request, {res['draw_peak_GiB']:.2f} "
              f"GiB at the draw, graphs {res['graphs']}", flush=True)
        if res["launches"] != want_l:
            failures.append(f"{tag} rank {r}: launches {res['launches']} != {want_l}")
        if res["collectives"] != want_c:
            failures.append(f"{tag} rank {r}: collectives {res['collectives']} != {want_c}")
        if res["param_bytes"] != want_b:
            failures.append(f"{tag} rank {r}: {res['param_bytes']} param bytes != {want_b}")
        if res["graphs"] != (kind == "tp4") or not res["finite"]:
            failures.append(f"{tag} rank {r}: graphs {res['graphs']} finite {res['finite']}")
        if kind == "tp4" and not (res["graph_eq_eager"] and res["graph_launches"] == want_l
                                  and res["graph_collectives"] == want_c):
            failures.append(f"{tag} rank {r}: graph = eager {res['graph_eq_eager']}, "
                            f"launches {res['graph_launches']}, collectives "
                            f"{res['graph_collectives']}")
    toks = ranks[0]["toks"]
    same = all(np.array_equal(r["toks"], toks) for r in ranks)
    ok = toks.shape == (BATCH, T) and toks.min() >= 0 and toks.max() < cfg.vocab_size
    if not (same and ok):
        failures.append(f"{tag}: tokens equal on both ranks {same}, shape/range ok {ok}")
    # The meshless engine on the same weights and token stream.
    eng, prompt = parallel_engine(kind, args.seed)
    _, logits = eng.generate(return_logits=True, token_overrides=torch.as_tensor(toks).cuda(),
                             **request1(prompt, args.seed))
    ref = [x[0].float().cpu() for x in logits]
    del eng, prompt, logits
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(rms_rel(torch.as_tensor(a), b) for a, b in zip(ranks[0]["logits0"], ref))
    if len(ref) != len(ranks[0]["logits0"]) or worst > TOL_NOSHARE:
        failures.append(f"{tag}: forced-stream logits {worst:.4g} from the meshless "
                        f"engine's > {TOL_NOSHARE}")
    r0 = ranks[0]
    steps = T - 1
    stats = dict(
        layers=L, tokens_equal_on_both_ranks=same, forced_rms_vs_meshless=worst,
        decode_tok_s=BATCH * steps / r0["decode_s"],
        decode_ms_per_step=1e3 * r0["decode_s"] / steps,
        collective_ms_per_step=1e3 * r0["collective_s"] / steps,
        compute_ms_per_step=1e3 * (r0["decode_s"] - r0["collective_s"]) / steps,
        request_s=r0["request_s"], setup_s=r0["setup_s"],
        request_peak_GiB=[r["request_peak_GiB"] for r in ranks],
        phase_s=time.perf_counter() - t)
    if kind == "tp4":
        stats.update(graph_eq_eager=[r["graph_eq_eager"] for r in ranks],
                     graph_decode_tok_s=BATCH * steps / r0["graph_decode_s"],
                     graph_decode_ms_per_step=1e3 * r0["graph_decode_s"] / steps,
                     graph_first_decode_s=r0["graph_first_decode_s"])
        where = f"four ranks on four cards over NCCL, {torch.cuda.device_count()} cards"
    else:
        where = "two ranks sharing one card over gloo (not a multi-card figure)"
    print(f"[{tag}] {where}, {card}: {json.dumps(stats)}", flush=True)
    return ranks[0]["launches"]


NOSHARE_LAYERS = 8  # case (e)'s depth of Llama-3-8B: cut this, never the width


def expected_launches_gqa_request1(L: int, T: int, mesh: str = "") -> dict:
    """Request 1 alone on Llama-3-8B (w8a8 + int8 KV): a shared prefill (7L
    GEMMs, L causal flash), then T-1 decode steps of 7L GEMMs, L level reads
    (K2) and L small-M unique reads (K5, the unique cache being BHSD); K8 in
    each of the T forwards, under ``mesh``; K9 a layer in each."""
    return {
        "w8a8_matmul_cached": 7 * L * T,
        "flash_attention_cached_bhsd": L * (T - 1),
        "flash_decode_bhsd": L * (T - 1),
        "flash_attention_bhsd": L,
        **expected_k8(L, T, mesh),
        "rope_kv_quant": L * T,
    }


def noshare_engine(seed: int, mesh=None):
    """Case (e)'s engine: Llama-3-8B's width at ``NOSHARE_LAYERS`` layers,
    w8a8, the weights drawn on the card from ``seed`` (sliced for the rank
    under ``mesh``), and its 2,048-token prompt."""
    from hydragen_torch import HydragenLlama
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params

    cfg = dataclasses.replace(PRESETS["llama-3-8b"], num_hidden_layers=NOSHARE_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = init_params(cfg, g, quantized="w8a8", device="cuda")
    eng = HydragenLlama(cfg, params, quantization="w8a8", mesh=mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    prompt = torch.randint(1, cfg.vocab_size, (1, SHARED_LEN), generator=g, device="cuda")
    return eng, prompt


def noshare_arm(eng, prompt, seed: int, nohydra: bool, overrides=None) -> dict:
    """One arm of case (e) on ``eng`` (``drive_no_sharing``'s request: the
    prompt with 256 greedy completions of NEW_TOKENS, WIPE; the baseline's
    unique rows hold the prompt and the decoded tokens): tokens, row 0's
    logits a step, launches, collectives and the decode loop's seconds."""
    from hydragen_torch import SharedCacheOp
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.parallel import mesh as mesh_lib

    T = NEW_TOKENS
    eng.cache = None
    gc.collect()
    torch.cuda.empty_cache()
    eng.setup_caches(BATCH, T + (SHARED_LEN + 8 if nohydra else 0), [1], [SHARED_LEN],
                     kv_quant="int8")
    steps, decode_s = eng._decode_steps, [0.0]

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return steps(*a, **kw)
        finally:
            torch.cuda.synchronize()
            decode_s[0] += time.perf_counter() - t

    eng._decode_steps = timed
    cuda_lib.reset_launches()
    mesh_lib.reset_collectives()
    try:
        toks, logits = eng.generate(
            input_ids=[prompt], num_return_sequences=BATCH, max_new_tokens=T, temperature=0.0,
            shared_cache_op=SharedCacheOp.WIPE, seed=seed, return_logits=True,
            disable_hydragen=nohydra,
            token_overrides=None if overrides is None else torch.as_tensor(overrides).cuda())
    finally:
        eng._decode_steps = steps
    return dict(toks=toks, logits0=torch.stack([x[0].float() for x in logits]),
                launches={k: v for k, v in cuda_lib.LAUNCHES.items() if v},
                collectives=dict(mesh_lib.COLLECTIVES), decode_s=decode_s[0],
                peak_GiB=torch.cuda.max_memory_allocated() / 2**30)


def noshare_rank(rank: int, world: int, seed: int) -> dict:
    """Case (e) ``tp2-noshare``, one of two gloo ranks sharing the card:
    Hydragen, then the no-sharing baseline (``disable_hydragen``), eagerly,
    under one tp=2 mesh; where the two arms' greedy tokens differ, the
    baseline again on Hydragen's tokens."""
    from hydragen_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    eng, prompt = noshare_engine(seed, make_mesh(tp=2, device="cuda:0"))
    out = dict(param_bytes=param_bytes(eng.params), graphs=eng.graphs_enabled)
    out["hydragen"] = noshare_arm(eng, prompt, seed, False)
    torch.cuda.reset_peak_memory_stats()
    out["no-sharing"] = noshare_arm(eng, prompt, seed, True)
    out["unique_GB"] = (eng.cache.unique_k.numel() * 2 + eng.cache.unique_k_scale.numel() * 8
                        ) / 1e9
    if not torch.equal(out["hydragen"]["toks"], out["no-sharing"]["toks"]):
        out["forced"] = noshare_arm(eng, prompt, seed, True, out["hydragen"]["toks"])["logits0"]
    return out


def drive_parallel_noshare(args, failures: list, card: str) -> dict:
    """Case (e) ``tp2-noshare``: the gqa no-sharing configuration
    (``llama-3-8b``, w8a8 + int8 KV, full width, NOSHARE_LAYERS layers) over
    two gloo ranks on the card, Hydragen and ``disable_hydragen=True`` in
    turn under one mesh, eagerly. Gates on each rank: exact launches (K5 a
    layer a step on the rank's 4 kv heads in both arms, no K2 in the
    baseline), exact collectives, the parameter bytes of the rules, tokens
    equal between the arms (or the baseline's logits on Hydragen's tokens
    within TOL_NOSHARE of Hydragen's); then the meshless baseline here on the
    ranks' baseline tokens: the ranks' logits within TOL_NOSHARE of its at
    every step. Prints both decode rates and their ratio (two ranks sharing
    one card: not a multi-card figure). Returns rank 0's baseline
    launches."""
    from hydragen_torch.parallel import launch

    tag, T, L = "parallel tp2-noshare", NEW_TOKENS, NOSHARE_LAYERS
    t0 = time.perf_counter()
    ranks = launch(noshare_rank, 2, args.seed, backend="gloo", timeout=PAR_TIMEOUT)
    want_l = {"hydragen": expected_launches_gqa_request1(L, T, "tp"),
              "no-sharing": expected_launches_no_sharing(L, T, "tp")}
    want_c = expected_collectives_request1("tp2", L, T)
    eng, prompt = noshare_engine(args.seed)
    want_b = expected_param_bytes(eng.config, 2)
    for r, res in enumerate(ranks):
        same = np.array_equal(res["hydragen"]["toks"], res["no-sharing"]["toks"])
        worst_arms = 0.0 if same else max(
            rms_rel(torch.as_tensor(a), torch.as_tensor(b))
            for a, b in zip(res["forced"], res["hydragen"]["logits0"]))
        ok = (res["param_bytes"] == want_b and not res["graphs"]
              and worst_arms <= TOL_NOSHARE
              and all(res[a]["launches"] == want_l[a] and res[a]["collectives"] == want_c
                      for a in want_l))
        print(f"[{tag}] rank {r}: launches hydragen {json.dumps(res['hydragen']['launches'])}, "
              f"no-sharing {json.dumps(res['no-sharing']['launches'])} (want "
              f"{json.dumps(want_l)}); collectives {json.dumps(res['no-sharing']['collectives'])}"
              f" (want {json.dumps(want_c)} in each arm); param bytes {res['param_bytes']} "
              f"(rules {want_b}); unique KV {res['unique_GB']:.2f} GB, device peak "
              f"{res['no-sharing']['peak_GiB']:.2f} GiB; arms' tokens equal {same}"
              f"{'' if same else f', forced-stream rms {worst_arms:.4g}'} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{tag} rank {r}: launches, collectives, bytes or arms differ "
                            f"(rms {worst_arms:.4g})")
    base = ranks[0]["no-sharing"]
    ref = noshare_arm(eng, prompt, args.seed, True, base["toks"])["logits0"].cpu()
    del eng, prompt
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(rms_rel(torch.as_tensor(a), b) for a, b in zip(base["logits0"], ref))
    if worst > TOL_NOSHARE or len(ref) != len(base["logits0"]):
        failures.append(f"{tag}: the baseline's forced stream {worst:.4g} from the meshless "
                        f"baseline's > {TOL_NOSHARE}")
    steps = BATCH * (T - 1)
    rates = {a: steps / ranks[0][a]["decode_s"] for a in ("hydragen", "no-sharing")}
    stats = dict(layers=L, hydragen_decode_tok_s=rates["hydragen"],
                 no_sharing_decode_tok_s=rates["no-sharing"],
                 hydragen_over_no_sharing=rates["hydragen"] / rates["no-sharing"],
                 forced_rms_vs_meshless_baseline=worst, phase_s=time.perf_counter() - t0)
    print(f"[{tag}] two ranks sharing one card over gloo (not a multi-card figure), {card}: "
          f"{json.dumps(stats)}", flush=True)
    return base["launches"]


def drive_parallel(args, failures: list, card: str) -> dict:
    """Phase parallel: (a), (b), (d) and (e) spawn two gloo ranks on the
    card, then run the meshless engine here on the same weights and token
    stream; (c) spawns one NCCL rank. Returns rank 0's launches of each case
    by kind."""
    from hydragen_torch.parallel import launch

    t_phase = time.perf_counter()
    T = NEW_TOKENS
    out = {kind: drive_parallel_case(args, failures, card, kind)
           for kind in (("tp4",) if args.tp4 else ("tp2", "sp2", "tp2-int4"))}
    if args.tp4:
        return out
    out["tp2-noshare"] = drive_parallel_noshare(args, failures, card)

    t = time.perf_counter()
    res = launch(nccl_rank, 1, args.seed, backend="nccl", timeout=PAR_TIMEOUT)[0]
    L = parallel_config("nccl").num_hidden_layers
    want_l = expected_launches_request1(L, T, mesh="tp")
    want_c = expected_collectives_request1("tp2", L, T)
    step_c = {"all_reduce_sum": 2 * L, "all_gather": 1}
    ok = (res["graph_eq_eager"] and res["graph_eq_meshless"] and res["graphs"]
          and res["launches"] == want_l and res["collectives"] == want_c
          and res["eager_collectives"] == want_c and res["captured"] == step_c)
    print(f"[parallel nccl] one-rank NCCL mesh, full depth, through the decode graphs: graph = "
          f"eager bit for bit {res['graph_eq_eager']}, graph = meshless bit for bit "
          f"{res['graph_eq_meshless']}, launches {json.dumps(res['launches'])}, collectives "
          f"{json.dumps(res['collectives'])}, the captured step's {json.dumps(res['captured'])} "
          f"(want {json.dumps(step_c)}), {time.perf_counter() - t:.1f} s -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"parallel nccl: {json.dumps(res)}")
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# Phase serving mesh: the serving stream through ContinuousBatcher over a
# mesh. (a) tp=2 and (b) dp=2 as two gloo ranks sharing the card at
# SERVE_MESH_LAYERS layers of full width (cut from 32 for time; never the
# width), eagerly; (c) a one-rank NCCL mesh at full depth through the graphs.
SERVE_MESH_LAYERS = 8
SERVE_MESH_POOL = 64
SERVE_MESH_REQUESTS = 128
SERVE_MESH_FORCED = 8  # finished requests forced through the meshless engine
# The values gate of (a) and (b): each emitted token of a forced request lies
# within this margin of the top logit of its step on the meshless engine (the
# margin in units of that step's logit RMS). A greedy pick under tp parts from
# the meshless argmax only where the per-shard row quantization's drift
# (parallel (a) reads 0.0758 RMS relative) covers the gap between the two top
# logits; a token read off another row's KV, or off a misplaced prompt, lies
# several RMS below the top.
SERVE_MESH_MARGIN = 0.5


def serve_mesh_engine(L: int, seed: int, mesh=None):
    """The serving configuration at ``L`` layers of Llama-2-7B width, w8a8 +
    int8 KV, its weights drawn on the card from ``seed`` (sliced for the rank
    under ``mesh``, the global draw freed), a pool of SERVE_MESH_POOL rows
    and one level holding a 2,048-token prompt."""
    from hydragen_torch import HydragenLlama
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params

    cfg = dataclasses.replace(PRESETS["llama-2-7b"], num_hidden_layers=L)
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    params = init_params(cfg, g, quantized="w8a8", device="cuda")
    eng = HydragenLlama(cfg, params, quantization="w8a8", mesh=mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eng.setup_caches(SERVE_MESH_POOL, SERVE_SUFFIX[1] + SERVE_BUDGET[1] + 8, [1], [SHARED_LEN],
                     kv_quant="int8")
    eng.append_shared(torch.randint(1, cfg.vocab_size, (1, SHARED_LEN), generator=g,
                                    device="cuda"))
    return eng


def serve_mesh_requests(seed: int, vocab: int) -> list:
    """The stream: SERVE_MESH_REQUESTS requests, suffixes and budgets
    uniform from ``seed``, no stops (with budgets alone and no EOS the
    schedule does not depend on the tokens)."""
    rng = np.random.RandomState(seed + 5)
    return [(rng.randint(1, vocab, (rng.randint(SERVE_SUFFIX[0], SERVE_SUFFIX[1] + 1),)),
             int(rng.randint(SERVE_BUDGET[0], SERVE_BUDGET[1] + 1)), 0, None)
            for _ in range(SERVE_MESH_REQUESTS)]


def serve_mesh_stream(eng, requests, seed: int, graphs: bool) -> dict:
    """The stream through a new batcher over ``eng`` (chunk 8, bucket 32,
    longest budget first, lookahead 1, greedy), every admission and chunk
    fenced by synchronizes and timed, the collectives' host seconds read
    (``mesh.timed_collectives``); the launch and collective counts set to 0
    just before and read just after."""
    from hydragen_torch import ContinuousBatcher
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.parallel import mesh as mesh_lib

    if eng.mesh is None or eng.mesh.graphs_ok:
        eng.graph(graphs)
    cb = ContinuousBatcher(eng, chunk=SERVE_CHUNK, bucket=SERVE_BUCKET, admit_policy="lpt",
                           lookahead=1, temperature=0.0, seed=seed)
    rids = [cb.submit(ids, max_new_tokens=n) for ids, n, _, _ in requests]
    spent = {"admit": [0.0, 0.0], "decode": [0.0, 0.0]}  # (wall s, collectives' host s)

    def fenced(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t, c = time.perf_counter(), mesh_lib.COLLECTIVE_SECONDS[0]
            with mesh_lib.timed_collectives():
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    spent[name][0] += time.perf_counter() - t
                    spent[name][1] += mesh_lib.COLLECTIVE_SECONDS[0] - c
        return run

    cb._admit_batch = fenced("admit", cb._admit_batch)
    cb._decode_chunk = fenced("decode", cb._decode_chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    mesh_lib.reset_collectives()
    t = time.perf_counter()
    out = cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    toks = [out.get(r) for r in rids]
    return dict(toks=toks, stats=dict(cb.stats), admit_forwards=cb.admit_forwards,
                launches={k: v for k, v in cuda_lib.LAUNCHES.items() if v},
                collectives=dict(mesh_lib.COLLECTIVES), wall_s=wall,
                admit_s=spent["admit"][0], admit_collective_s=spent["admit"][1],
                decode_s=spent["decode"][0], decode_collective_s=spent["decode"][1],
                new_tokens=sum(len(x) for x in toks if x is not None),
                peak_GiB=torch.cuda.max_memory_allocated() / 2**30,
                graph=cb._chunk.graph is not None, key=cb._key)


def serve_mesh_rank(rank: int, world: int, kind: str, seed: int) -> dict:
    """One rank of phase serving mesh: (a) ``"tp2"`` or (b) ``"dp2"``, two
    gloo ranks on the one card, the stream eagerly at SERVE_MESH_LAYERS
    layers; or (c) ``"nccl1"``, a one-rank NCCL mesh (``keep_trivial``: its
    tp collectives run over the one rank) at full depth: the stream through
    the decode graphs (captures counted), eagerly, then the meshless engine's
    stream through its graphs on the same weights."""
    from hydragen_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "nccl1":
        mesh = make_mesh(tp=1, device="cuda:0", keep_trivial=True)
    else:
        mesh = make_mesh(**{kind[:2]: 2}, device="cuda:0")
    L = 32 if kind == "nccl1" else SERVE_MESH_LAYERS
    eng = serve_mesh_engine(L, seed, mesh)
    requests = serve_mesh_requests(seed, eng.config.vocab_size)
    captures = count_captures(eng)
    out = dict(graphs_enabled=eng.graphs_enabled)
    out["stream"] = serve_mesh_stream(eng, requests, seed, graphs=True)
    key = out["stream"].pop("key")
    if kind != "nccl1":
        return out
    out["captures"] = dict(of_key=captures.get(key, 0), all=sorted(captures.values()))
    out["eager"] = serve_mesh_stream(eng, requests, seed, graphs=False)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["meshless"] = serve_mesh_stream(serve_mesh_engine(L, seed), requests, seed, graphs=True)
    for run in (out["eager"], out["meshless"]):
        run.pop("key")
    return out


def serve_mesh_collectives(kind: str, L: int, run: dict) -> dict:
    """The counted collectives of a rank's stream, from its dispatch log.
    tp (and the one-rank NCCL mesh's trivial tp): each forward, this rank's
    admission prefills and every decode step, makes two sum all-reduces a
    layer and one all-gather of the logits. dp: every admission dispatch
    gathers its members' logits and every chunk its tokens."""
    st = run["stats"]
    if kind == "dp2":
        return {"all_reduce_sum": 0, "all_reduce_max": 0,
                "all_gather": st["admit_dispatches"] + st["chunks"]}
    forwards = run["admit_forwards"] + st["decode_steps"]
    return {"all_reduce_sum": 2 * L * forwards, "all_reduce_max": 0, "all_gather": forwards}


def forced_margins(eng, requests, toks, picks, seed: int) -> float:
    """The largest margin of a forced token: requests ``picks``' suffixes
    through ``eng.generate`` over the kept prompt (``PRESERVE``), each
    request's tokens ``toks`` forced (``token_overrides``); at each step, the
    top logit less the logit of the token emitted there, in units of that
    step's logit RMS, over every token of every picked request."""
    from hydragen_torch import SharedCacheOp

    lens = np.array([len(requests[i][0]) for i in picks], dtype=np.int32)
    ids = np.zeros((len(picks), int(lens.max())), dtype=np.int32)
    T = max(len(toks[i]) for i in picks)
    over = np.zeros((len(picks), T), dtype=np.int32)
    for j, i in enumerate(picks):
        ids[j, :lens[j]] = requests[i][0]
        over[j, :len(toks[i])] = toks[i]
        over[j, len(toks[i]):] = toks[i][-1]
    eng.graph(True)
    _, logits = eng.generate(input_ids=[ids], seq_lens=[lens], max_new_tokens=T,
                             temperature=0.0, return_logits=True, token_overrides=over,
                             shared_cache_op=SharedCacheOp.PRESERVE, seed=seed)
    worst = 0.0
    for j, i in enumerate(picks):
        for k, tok in enumerate(toks[i]):
            row = logits[k][j].float()
            margin = float(row.max() - row[tok]) / float(row.pow(2).mean().sqrt().clamp_min(1e-6))
            worst = max(worst, margin)
    return worst


def drive_serving_mesh(args, failures: list, card: str) -> dict:
    """Phase serving mesh: the serving stream (SERVE_MESH_REQUESTS requests
    over a pool of SERVE_MESH_POOL rows x 200 ring slots, suffixes 16-128,
    budgets 8-64, longest budget first, chunk 8, bucket 32, lookahead 1,
    greedy, no EOS) at full Llama-2-7B width, w8a8 + int8 KV, one 2,048-token
    level: (a) tp=2 and (b) dp=2 as two gloo ranks sharing the card at
    SERVE_MESH_LAYERS layers, eagerly, then the meshless batcher here on the
    same weights, stream and depth; (c) a one-rank NCCL mesh at full depth
    through the graphs. Gates on every rank: tokens and stats equal between
    the ranks and the stats the meshless batcher's; exact launches (the
    rank's own admission prefills and every step) and collectives; every
    request back within its budget, tokens in range; (a), (b): SERVE_MESH_
    FORCED finished requests' tokens forced through the meshless engine, each
    within SERVE_MESH_MARGIN of its step's top logit; (c): the graph stream
    equal to its eager run and to the meshless graph stream bit for bit, one
    capture a key. Returns rank 0's launches by case."""
    from hydragen_torch.parallel import launch

    t_phase = time.perf_counter()
    L = SERVE_MESH_LAYERS
    out, ranks_of = {}, {}
    for kind in ("tp2", "dp2"):
        t = time.perf_counter()
        ranks_of[kind] = launch(serve_mesh_rank, 2, kind, args.seed, backend="gloo",
                                timeout=PAR_TIMEOUT)
        ranks_of[kind].append(time.perf_counter() - t)
    # The meshless batcher on the same weights, stream and depth.
    eng = serve_mesh_engine(L, args.seed)
    V = eng.config.vocab_size
    requests = serve_mesh_requests(args.seed, V)
    base = serve_mesh_stream(eng, requests, args.seed, graphs=False)
    new = check_stream("serving mesh meshless", requests, base["toks"], V, failures)
    picks = list(range(0, SERVE_MESH_REQUESTS, SERVE_MESH_REQUESTS // SERVE_MESH_FORCED))
    control = forced_margins(eng, requests, base["toks"], picks, args.seed)
    print(f"[serving mesh meshless] {card}; {L} layers, pool {SERVE_MESH_POOL}: "
          f"{SERVE_MESH_REQUESTS} requests in {base['wall_s']:.3f} s (fenced, eager), "
          f"{new} new tokens; dispatches {json.dumps(base['stats'])}; decode "
          f"{1e3 * base['decode_s'] / base['stats']['decode_steps']:.3f} ms/step; its own "
          f"tokens forced: largest margin {control:.4g} logit RMS", flush=True)
    for kind in ("tp2", "dp2"):
        *ranks, secs = ranks_of[kind]
        tag = f"serving mesh {kind}"
        runs = [r["stream"] for r in ranks]
        for r, run in enumerate(runs):
            want_l = expected_launches_serving(L, run["admit_forwards"],
                                               run["stats"]["decode_steps"],
                                               "tp" if kind == "tp2" else "")
            want_c = serve_mesh_collectives(kind, L, run)
            ok = (run["launches"] == want_l and run["collectives"] == want_c
                  and run["stats"] == base["stats"] and not ranks[r]["graphs_enabled"])
            print(f"[{tag}] rank {r}: dispatches {json.dumps(run['stats'])}, admission "
                  f"forwards {run['admit_forwards']}; launches {json.dumps(run['launches'])} "
                  f"(want {json.dumps(want_l)}); collectives {json.dumps(run['collectives'])} "
                  f"(want {json.dumps(want_c)}); device peak {run['peak_GiB']:.2f} GiB -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"{tag} rank {r}: launches, collectives or stats differ "
                                f"(meshless stats {base['stats']})")
        same = all(run["toks"] == runs[0]["toks"] and run["stats"] == runs[0]["stats"]
                   for run in runs)
        if not same:
            failures.append(f"{tag}: the ranks' tokens or stats differ")
        toks = runs[0]["toks"]
        new = check_stream(tag, requests, toks, V, failures)
        worst = forced_margins(eng, requests, toks, picks, args.seed)
        if worst > SERVE_MESH_MARGIN:
            failures.append(f"{tag}: a forced token {worst:.4g} logit RMS below its step's "
                            f"top on the meshless engine > {SERVE_MESH_MARGIN}")
        agree = sum(a == b for a, b in zip(toks, base["toks"]))
        r0 = runs[0]
        steps = r0["stats"]["decode_steps"]
        stats = dict(
            layers=L, ranks_agree=same, requests_equal_to_meshless=agree,
            forced_margin=worst, requests_s=SERVE_MESH_REQUESTS / r0["wall_s"],
            new_tokens_s=new / r0["wall_s"], wall_s=r0["wall_s"],
            ms_per_step=1e3 * r0["decode_s"] / steps,
            collective_ms_per_step=1e3 * r0["decode_collective_s"] / steps,
            other_ms_per_step=1e3 * (r0["decode_s"] - r0["decode_collective_s"]) / steps,
            admit_s=r0["admit_s"], admit_collective_s=r0["admit_collective_s"],
            peak_GiB=[run["peak_GiB"] for run in runs], case_s=secs)
        print(f"[{tag}] two ranks sharing one card over gloo (not a multi-card figure), "
              f"{card}: {json.dumps(stats)}", flush=True)
        out[kind] = r0["launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    res = launch(serve_mesh_rank, 1, "nccl1", args.seed, backend="nccl", timeout=PAR_TIMEOUT)[0]
    g, e, m = res["stream"], res["eager"], res["meshless"]
    L32 = 32
    want_l = expected_launches_serving(L32, g["admit_forwards"], g["stats"]["decode_steps"],
                                       "tp")
    # The meshless engine quantizes o's and down's inputs whole, the SiLU
    # product fused: its K8 counts differ from the trivial tp's.
    want_m = expected_launches_serving(L32, g["admit_forwards"], g["stats"]["decode_steps"])
    want_c = serve_mesh_collectives("nccl1", L32, g)
    bit = g["toks"] == e["toks"] == m["toks"]
    ok = (bit and g["stats"] == e["stats"] == m["stats"] and res["graphs_enabled"]
          and g["graph"] and not e["graph"] and g["launches"] == want_l == e["launches"]
          and m["launches"] == want_m and g["collectives"] == want_c == e["collectives"]
          and res["captures"] == dict(of_key=1, all=[1]))
    new = check_stream("serving mesh nccl1", requests, g["toks"], V, failures)
    steps = g["stats"]["decode_steps"]
    print(f"[serving mesh nccl1] one-rank NCCL mesh, 32 layers, {card}: graph = eager = meshless "
          f"graph stream bit for bit {bit}; dispatches {json.dumps(g['stats'])}; launches "
          f"{json.dumps(g['launches'])} (want {json.dumps(want_l)}); collectives "
          f"{json.dumps(g['collectives'])} (want {json.dumps(want_c)}); captures "
          f"{json.dumps(res['captures'])}; graph stream {SERVE_MESH_REQUESTS / g['wall_s']:.2f} "
          f"requests/s, {new / g['wall_s']:.1f} new tokens/s, {1e3 * g['decode_s'] / steps:.3f} "
          f"ms/step, admissions {g['admit_s']:.3f} s, peak {g['peak_GiB']:.2f} GiB; eager "
          f"{1e3 * e['decode_s'] / steps:.3f} ms/step; meshless graph "
          f"{1e3 * m['decode_s'] / steps:.3f} ms/step, {SERVE_MESH_REQUESTS / m['wall_s']:.2f} "
          f"requests/s; {time.perf_counter() - t:.1f} s -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"serving mesh nccl1: bit for bit {bit}, stats {g['stats']} / "
                        f"{e['stats']} / {m['stats']}, launches {g['launches']}, collectives "
                        f"{g['collectives']}, captures {res['captures']}")
    out["nccl1"] = g["launches"]
    print(f"[serving mesh] {card}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# Phase scripts: the port's entry points at full width, in this process.
SYNTH_ARGV = ["--preset", "llama-2-7b", "--quantization", "w8a8", "--kv-quant", "int8",
              "--bs", "256", "--num-shared", "2048", "--num-unique", "64", "--mode", "all",
              "--iters", "2"]
SYNTH_CALLS = 2 + 2  # generate calls a point: 2 warm-up and --iters 2
NEEDLES_ARGV = ["--preset", "yi-6b-200k", "--haystack-chars", "65536",
                "--num-questions", "2:64:x2"]
NEEDLES_COUNTS = (2, 4, 8, 16, 32, 64)
RUN_LAYERS = 2  # the run.py checkpoint: Llama-2-7B width, cut in depth
RUN_PROMPTS = ["w11 w12 w13 w14 w15 w16 w17 w18", "w21 w22 w23|w31 w32 w33"]
RUN_SAMPLES, RUN_NEW_TOKENS = 4, 16
PROFILE_KERNELS = ("w8a8_kernel", "flash_kernel", "decode_kernel")  # K1, K2/K4, K3


def write_wordlevel_tokenizer(directory: Path, vocab_size: int) -> None:
    """A tokenizer that ``transformers.AutoTokenizer`` reads from
    ``directory`` with no download: ``tokenizers``' WordLevel over <unk>,
    <s>, </s> and the words w0 ... w{vocab_size-4}, split on whitespace,
    with <s> put before each encoded text (Llama's BOS)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"w{i}": i + 3 for i in range(vocab_size - 3)})
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.post_processor = processors.TemplateProcessing(single="<s> $A",
                                                      special_tokens=[("<s>", 1)])
    directory.mkdir(parents=True, exist_ok=True)
    tk.save(str(directory / "tokenizer.json"))
    (directory / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 4096}, indent=1))


def nonzero_launches() -> dict:
    from hydragen_torch.ops import cuda_lib

    torch.cuda.synchronize()
    return {k: v for k, v in cuda_lib.LAUNCHES.items() if v}


def script_synth(root: Path, failures: list, card: str, main_stats: dict) -> dict:
    """synth at the main path's shape, ``--mode all``: launches by mode
    (each ``bench_point`` counted alone), ``fits_hbm``'s answer by mode."""
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.scripts import synth
    from hydragen_torch.utils import SynthBenchmarkResult, load_yaml_dataclass

    by_mode, fits = {}, {}
    bench_point, fits_hbm = synth.bench_point, synth.fits_hbm

    def counted_point(engine, mode, *a, **kw):
        cuda_lib.reset_launches()
        out = bench_point(engine, mode, *a, **kw)
        by_mode[mode] = nonzero_launches()
        return out

    def recorded_fits(cfg, quant, kv_quant, bs, ns, nu, mode, *a, **kw):
        fits[mode] = fits_hbm(cfg, quant, kv_quant, bs, ns, nu, mode, *a, **kw)
        return fits[mode]

    synth.bench_point, synth.fits_hbm = counted_point, recorded_fits
    try:
        torch.cuda.reset_peak_memory_stats()
        written = synth.main([str(root / "synth")] + SYNTH_ARGV)
    finally:
        synth.bench_point, synth.fits_hbm = bench_point, fits_hbm
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = synth.PRESETS["llama-2-7b"]
    noshared_bytes = synth.hbm_bytes(cfg, "w8a8", "int8", 256, 2048, 64, "hydragen_noshared", 1)
    want = {k: SYNTH_CALLS * v for k, v in
            expected_launches_request1(cfg.num_hidden_layers, 64).items()}
    names = sorted(p.name for p in written)
    print(f"[scripts synth] launches by mode {json.dumps(by_mode)}; fits_hbm {json.dumps(fits)} "
          f"(hydragen_noshared needs {noshared_bytes / 1e9:.1f} GB of {synth.HBM_BYTES / 1e9:.0f}); "
          f"device peak {peak:.2f} GiB; wrote {names}", flush=True)
    if by_mode.get("hydragen") != want:
        failures.append(f"scripts synth: hydragen launches {by_mode.get('hydragen')} != {want}")
    att = {k: v for k, v in by_mode.get("noattention", {"missing": 1}).items()
           if k in ("flash_attention_cached_bhsd", "decode_attention_cached", "missing")}
    if att:
        failures.append(f"scripts synth: noattention launched {att}")
    if "hydragen_noshared" in by_mode or fits.get("hydragen_noshared") is not False:
        failures.append(f"scripts synth: hydragen_noshared not skipped by fits_hbm "
                        f"(fits {fits.get('hydragen_noshared')}, ran "
                        f"{'hydragen_noshared' in by_mode})")
    if names != ["hydragen_bs256_ns2048_nu64.yaml", "noattention_bs256_ns2048_nu64.yaml"]:
        failures.append(f"scripts synth: wrote {names}")
    rates = {}
    for path in written:
        r = load_yaml_dataclass(SynthBenchmarkResult, path)
        rates[r.mode] = dict(tok_s=r.throughput, mean_s=r.mean_time, times=r.times)
    print(f"[scripts synth] {card}: tok/s (a whole generate call: the 2,048-token prefill and "
          f"63 decode steps, 256 rows) {json.dumps(rates)}; the main path's graph decode rate "
          f"(decode steps alone, request 2 again) {main_stats.get('graph_decode_tok_s')}",
          flush=True)
    return by_mode.get("hydragen", {})


def script_needles(root: Path, failures: list, card: str) -> dict:
    from hydragen_torch.scripts import needles

    argv = [str(root / "needles")] + NEEDLES_ARGV
    new_tokens = needles.parse_args(argv).max_new_tokens
    res = needles.main(argv)
    launches = nonzero_launches()
    yamls = sorted(int(p.stem.split("_q")[1]) for p in (root / "needles").glob("*.yaml"))
    rates = {r.num_questions: r.num_questions * new_tokens / r.decode_times[0] for r in res}
    print(f"[scripts needles] {card}: shared prefill of {65536 // 4} tokens "
          f"{res[0].shared_prefill_time if res else float('nan'):.4f} s; tok/s of a whole "
          f"generate call (the questions' prefill over the shared level and {new_tokens} new "
          f"tokens) by question count {json.dumps(rates)}; launches {json.dumps(launches)} (K5: "
          f"{launches.get('flash_decode_bhsd', 0)})", flush=True)
    if yamls != list(NEEDLES_COUNTS):
        failures.append(f"scripts needles: YAMLs for {yamls}, want {list(NEEDLES_COUNTS)}")
    if not (launches.get("flash_attention_cached_bhsd") and launches.get("flash_attention_bhsd")):
        failures.append(f"scripts needles: K2 or K4 not launched: {launches}")
    return launches


def script_microbenchmark(root: Path, failures: list, card: str, seed: int) -> dict:
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.scripts import microbenchmark as mb

    g = torch.Generator(device="cuda").manual_seed(seed)
    inputs = mb.make_inputs(g, 512, 2048, 128, 8, 1, 128, torch.bfloat16, "cuda")
    outs = {}
    for mode in ("hydragen", "baseline"):
        op, op_args = getattr(mb, f"go_{mode}")(*inputs, 128, 512)
        outs[mode] = op(*op_args)
    err, rel = rel_err(outs["hydragen"], outs["baseline"])
    del outs, inputs
    cuda_lib.reset_launches()  # the gate's calls above are not the script's run
    res = mb.main([str(root / "micro")])
    launches = nonzero_launches()
    t = {r.mode: r.mean_time for r in res}
    ratio = t["hydragen"] / t["baseline"] if len(t) == 2 else float("nan")
    print(f"[scripts microbenchmark] {card}: defaults (bs 512, shared 2,048, unique 128, 8 q "
          f"heads over 1 kv head, d 128, bf16), each call after an L2 flush: hydragen "
          f"{t.get('hydragen', float('nan')) * 1e3:.4f} ms, baseline "
          f"{t.get('baseline', float('nan')) * 1e3:.4f} ms, hydragen/baseline {ratio:.4f}; "
          f"hydragen vs baseline max |err| {err:.4g} (relative {rel:.4g}, tol {TOL_REL}); "
          f"launches {json.dumps(launches)}", flush=True)
    if rel > TOL_REL or len(t) != 2:
        failures.append(f"scripts microbenchmark: hydragen vs baseline relative {rel:.4g} > "
                        f"{TOL_REL} or modes {sorted(t)}")
    return launches


def script_serving(failures: list, card: str) -> dict:
    from hydragen_torch.scripts import serving_bench

    res = serving_bench.main([])
    launches = nonzero_launches()
    print(f"[scripts serving_bench] {card}: {res['requests'] / res['continuous_s']:.2f} "
          f"requests/s continuous, {res['requests'] / res['static_s']:.2f} static; launches "
          f"{json.dumps(launches)}", flush=True)
    if res["requests"] != 96:
        failures.append(f"scripts serving_bench: {res['requests']} requests")
    return launches


def script_run(root: Path, failures: list, seed: int) -> dict:
    import io

    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.scripts import run

    cfg = dataclasses.replace(PRESETS["llama-2-7b"], num_hidden_layers=RUN_LAYERS)
    ckpt = root / "run_ckpt"
    g = torch.Generator(device="cuda").manual_seed(seed)
    write_hf_checkpoint(ckpt, cfg, hf_state_dict(cfg, g), shards=1)
    write_wordlevel_tokenizer(ckpt, cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run.main([str(ckpt), "--prompts", *RUN_PROMPTS, "--num-return-sequences",
                        str(RUN_SAMPLES), "--max-new-tokens", str(RUN_NEW_TOKENS),
                        "--quantization", "w8a8", "--kv-quant", "int8"])
    launches = nonzero_launches()
    text = out.getvalue()
    blocks = text.splitlines().count("---")
    toks = res["tokens"]
    rows = len(RUN_PROMPTS[-1].split("|")) * RUN_SAMPLES
    ok = (blocks == rows == toks.shape[0] and 0 < toks.shape[1] <= RUN_NEW_TOKENS
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size)
    print(f"[scripts run] {RUN_LAYERS}-layer Llama-2-7B-width checkpoint, w8a8 + int8 KV: "
          f"{blocks} blocks for {rows} rows, tokens {tuple(toks.shape)} in range "
          f"{ok}; launches {json.dumps(launches)}; first block: "
          f"{text.split('---')[1].strip()[:120] if blocks else ''!r}", flush=True)
    if not ok:
        failures.append(f"scripts run: {blocks} blocks, {rows} rows, tokens {toks.shape}")
    return launches


def script_profile(failures: list) -> dict:
    from hydragen_torch.scripts import profile_decode

    res = profile_decode.main(["--steps", str(PROFILE_STEPS)])
    launches = nonzero_launches()
    s = res["summary"]
    names = {op.name.split("::")[-1] for op in s.ops}
    print(f"[scripts profile_decode] wall {res['decode_ms_per_step']:.3f} ms/step (no profiler); "
          f"under the profiler: wall {s.wall_ms / s.steps:.3f}, busy {s.busy_ms / s.steps:.3f} "
          f"ms/step; K1-K3 in the table: {sorted(names & set(PROFILE_KERNELS))}", flush=True)
    if not set(PROFILE_KERNELS) <= names:
        failures.append(f"scripts profile_decode: table lacks "
                        f"{sorted(set(PROFILE_KERNELS) - names)}: {sorted(names)}")
    return launches


# quality.py's modes at its defaults (sheared-llama-1.3b, 512 tokens x 4):
# name: (argv, gate). The gates are tests/test_quality.py's bounds on the
# modes it asserts them on ("pass": ce delta < 0.015 nats and mean KL <
# kl_max; "fail": the per-tensor scheme under outliers must break one;
# "kv": mean KL < 5e-3); the others print.
QUALITY_MODES = {
    "int8": ([], ("pass", 5e-3)),
    "w8a8": (["--quantization", "w8a8"], ("pass", 8e-3)),
    "w4a8": (["--quantization", "w4a8"], None),
    "outliers per-channel": (["--outliers"], ("pass", 5e-3)),
    "outliers per-tensor": (["--outliers", "--scheme", "per_tensor"], ("fail", 5e-3)),
    "kv int8": (["--kv-quant", "int8"], ("kv", 5e-3)),
    "kv int4": (["--kv-quant", "int4"], None),
}
QUALITY_CE = 0.015


def script_quality(failures: list, card: str) -> dict:
    """quality.py in each of QUALITY_MODES, counted alone: its gate, and
    under w8a8 and w4a8 every family on K1 or K6 (7 launches a layer of the
    quantized prefill; K4 a layer in each of the two prefills)."""
    import io

    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.ops import cuda_lib
    from hydragen_torch.scripts import quality

    L = PRESETS["sheared-llama-1.3b"].num_hidden_layers
    out, total = {}, {}
    for name, (argv, gate) in QUALITY_MODES.items():
        cuda_lib.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            res = quality.main(argv)
        launches = nonzero_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        ce, kl = res["ce_delta_nats"], res["mean_kl_nats"]
        ok = True
        if gate is not None:
            kind, kl_max = gate
            passed = ce < QUALITY_CE and kl < kl_max
            ok = {"pass": passed, "fail": ce > QUALITY_CE or kl > kl_max,
                  "kv": kl < kl_max}[kind]
        quant = argv[1] if argv[:1] == ["--quantization"] else None
        if quant in ("w8a8", "w4a8"):
            gemm = "w8a8_matmul_cached" if quant == "w8a8" else "w4a8_matmul_cached"
            want = {gemm: 7 * L, "flash_attention_bhsd": 2 * L, **expected_k8(L, 1)}
            ok = ok and launches == want and all(res["s8_kernel_coverage"].values())
        print(f"[scripts quality] {name}: ce delta {ce} nats, mean KL {kl} nats (ce "
              f"{res.get('ce_bf16_nats')} -> {res.get('ce_int8_nats', res.get('ce_kvq_nats'))}"
              f"); gate {gate}; coverage {res.get('s8_kernel_coverage')}; launches "
              f"{json.dumps(launches)} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"scripts quality {name}: {json.dumps(res)}, launches {launches}")
        out[name] = res
    print(f"[scripts quality] {card}: {json.dumps(out)}", flush=True)
    return total


def script_ubench_gemm(failures: list, card: str) -> dict:
    """ubench_gemm at its defaults: K1's 2-D entry (K1') and K6's within
    TOL_REL of their f32 oracles at every shape."""
    from hydragen_torch.scripts import ubench_gemm

    rows = ubench_gemm.main([])
    launches = nonzero_launches()
    bad = [r for r in rows if r["arm"] in ("w8a8", "w4a8") and r["rel_err"] > TOL_REL]
    arms = sorted({(r["shape"], r["arm"]) for r in rows})
    print(f"[scripts ubench_gemm] {card}: {json.dumps(rows)}; launches {json.dumps(launches)}",
          flush=True)
    if bad or len(arms) != len(ubench_gemm.SHAPES) * len(ubench_gemm.ARMS):
        failures.append(f"scripts ubench_gemm: {bad} beyond {TOL_REL}, arms {arms}")
    return launches


def script_ubench_unique(failures: list, card: str) -> dict:
    """ubench_unique at its defaults: K3 within TOL_REL (out) and TOL_LSE
    (lse) of the plain read at both widths."""
    from hydragen_torch.scripts import ubench_unique

    res = ubench_unique.main([])
    launches = nonzero_launches()
    print(f"[scripts ubench_unique] {card}: {json.dumps(res)}; launches {json.dumps(launches)}",
          flush=True)
    for arm in ("k3", "kv4"):
        r = res.get(arm, {})
        if not (r.get("rel", 1.0) <= TOL_REL and r.get("dlse", 1.0) <= TOL_LSE):
            failures.append(f"scripts ubench_unique {arm}: {r}")
    return launches


def drive_scripts(args, failures: list, card: str, main_stats: dict) -> dict:
    """Phase scripts: each entry point of ``hydragen_torch.scripts`` through
    its ``main(argv)`` in this process, outputs under
    ``build/scripts_phase/`` (emptied first; the checkpoint deleted after).
    A script that raises fails the phase; the others still run. Returns the
    launches of each script by name."""
    import shutil

    from hydragen_torch.ops import cuda_lib

    root = Path(__file__).resolve().parent / "build" / "scripts_phase"
    shutil.rmtree(root, ignore_errors=True)
    steps = (
        ("synth", lambda: script_synth(root, failures, card, main_stats)),
        ("needles", lambda: script_needles(root, failures, card)),
        ("microbenchmark", lambda: script_microbenchmark(root, failures, card, args.seed)),
        ("serving_bench", lambda: script_serving(failures, card)),
        ("run", lambda: script_run(root, failures, args.seed)),
        ("profile_decode", lambda: script_profile(failures)),
        ("quality", lambda: script_quality(failures, card)),
        ("ubench_gemm", lambda: script_ubench_gemm(failures, card)),
        ("ubench_unique", lambda: script_ubench_unique(failures, card)),
    )
    out, seconds = {}, {}
    t_phase = time.perf_counter()
    for name, step in steps:
        t = time.perf_counter()
        cuda_lib.reset_launches()
        try:
            out[name] = step()
        except Exception:  # a failed script fails the phase; the others still run
            traceback.print_exc()
            failures.append(f"scripts {name} raised")
            out[name] = {}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t, 1)
    shutil.rmtree(root / "run_ckpt", ignore_errors=True)
    print(f"[scripts] seconds {json.dumps(seconds)}, phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and prompts")
    ap.add_argument("--tp4", action="store_true",
                    help="run only phase parallel's tp=4 case over NCCL on four cards "
                         "(the default run needs one card and never runs it)")
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
    print("\n".join(smi) or card, flush=True)

    failures: list[str] = []
    t = time.perf_counter()
    seconds = cuda_lib.build()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"wall {time.perf_counter() - t:.2f} s into {cuda_lib.build_dir()}", flush=True)
    print_ptxas(cuda_lib.BUILD_LOG)

    if args.tp4:
        drive_parallel(args, failures, card)
        if failures:
            print("chip_smoke --tp4 FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    report: dict = {}
    launches: dict = {"main": {}, "load": {}, "load tp2": {}, "int4": {}, "gqa": {},
                      "gqa no-sharing": {}, "serving": {}, "parallel": {}, "parallel int4": {},
                      "parallel noshare": {}, "serving mesh tp2": {}, "serving mesh dp2": {},
                      "serving mesh nccl1": {}}
    main_stats: dict = {}

    def load_phase():
        meshless, tp2 = drive_load(args, failures)
        launches["load"].update(meshless)
        launches["load tp2"].update(tp2)

    def parallel_phase():
        by_kind = drive_parallel(args, failures, card)
        launches["parallel"].update(by_kind["tp2"])
        launches["parallel int4"].update(by_kind["tp2-int4"])
        launches["parallel noshare"].update(by_kind["tp2-noshare"])

    def serving_mesh_phase():
        for kind, counts in drive_serving_mesh(args, failures, card).items():
            launches[f"serving mesh {kind}"].update(counts)

    def scripts_phase():
        for name, counts in drive_scripts(args, failures, card, main_stats).items():
            launches[f"scripts {name}"] = counts

    phases = (
        ("kernels", lambda: check_kernels(report, failures, cuda_time_ms)),
        ("main path", lambda: launches["main"].update(
            drive_path(args, failures, "main", stats_out=main_stats))),
        ("load", load_phase),
        ("int4 path", lambda: launches["int4"].update(drive_path(args, failures, "int4"))),
        ("gqa path", lambda: launches["gqa"].update(drive_path(args, failures, "gqa"))),
        ("gqa no-sharing", lambda: launches["gqa no-sharing"].update(
            drive_no_sharing(args, failures))),
        ("serving", lambda: launches["serving"].update(drive_serving(args, failures, card))),
        ("serving grouped", lambda: drive_grouped_stream(args, failures, card)),
        ("plain path", lambda: check_plain_path(args, failures, "w8a8")),
        ("plain path int4", lambda: check_plain_path(args, failures, "int4")),
        ("plain path gqa", lambda: check_plain_path(args, failures, "gqa")),
        ("parallel", parallel_phase),
        ("serving mesh", serving_mesh_phase),
        ("scripts", scripts_phase),
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

    # name: (source, TPU call site, the path whose launches it reports[, the
    # launch counter where it is not the name])
    sources = {
        "w8a8_matmul_cached": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:222", "main"),
        "w8a8_matmul": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:118", "scripts ubench_gemm"),
        "w8a8_matmul_cached_f32_scales": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:222",
                                          "load"),
        "flash_attention_cached_bhsd": ("csrc/flash.cu", "hydragen_tpu/ops/flash.py:924",
                                        "main"),
        "decode_attention_cached": ("csrc/decode.cu", "hydragen_tpu/ops/decode.py:616",
                                    "main"),
        "decode_attention_cached_int4": ("csrc/decode.cu",
                                         "hydragen_tpu/ops/decode.py:616", "int4"),
        "flash_attention_bhsd": ("csrc/flash.cu", "hydragen_tpu/ops/flash.py:608", "main"),
        "w4a8_matmul_cached": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:495", "int4"),
        "w4a8_matmul_cached_tp2": ("csrc/gemm.cu", "hydragen_tpu/ops/gemm.py:495",
                                   "parallel int4", "w4a8_matmul_cached"),
        "write_token_int4_cached": ("csrc/decode.cu", "hydragen_tpu/ops/decode.py:729",
                                    "int4"),
        "flash_decode_bhsd": ("csrc/flash.cu", "hydragen_tpu/ops/flash.py:715", "gqa"),
        # K8: no TPU kernel (XLA fuses the norm, the SiLU product and
        # hydragen_tpu/ops/gemm.py:quantize_rows inside jit).
        "rms_norm_quant": ("csrc/act.cu", "none (XLA fusion)", "main"),
        "silu_mul_quant": ("csrc/act.cu", "none (XLA fusion)", "main"),
        "quantize_rows": ("csrc/act.cu", "none (XLA fusion)", "main"),
    }
    kernels = []
    for name, (src, replaces, path, *counter) in sources.items():
        r = report.get(name)
        if r is None:
            failures.append(f"no measurement for {name}")
            continue
        counter = counter[0] if counter else name
        n = launches.get(path, {}).get(counter, 0)
        if n < 1:
            failures.append(f"{name} never launched on the {path} path")
        by_path = {p: launches[p].get(counter, 0) for p in launches}
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
