"""Decode-shape GEMM microbenchmark: the port's int8 and int4 products
against the bf16 matmul, at the Llama-2-7B decode shapes (M = 256 rows).

Port of the JAX package's ``scripts/ubench_gemm.py``. The arms of a shape:

  bf16  ``torch.matmul`` of bf16 activations and a bf16 weight (a baseline)
  dq    the weight-only int8 route (``ops/quant.py:qmatmul``): the payload
        cast to bf16 on every call, the product, the column scale
  w8a8  ``quantize_rows`` and K1's 2-D entry (``ops/gemm.py:w8a8_matmul``)
  w4a8  ``quantize_rows`` and K6's 2-D entry (``ops/gemm.py:w4a8_matmul``)
  dq4   the weight-only int4 route (``qmatmul`` on a ``Quantized4Tensor``)

The row quantization is part of the w8a8 and w4a8 arms' timed call, as it
is part of their cost in the model. Each call is a CUDA-graph replay after
an L2 flush (``utils/timing.py:time_flushed``); beside its mean time stand
the card's bound for its bytes and operations (``utils/timing.py:bound_ms``)
and its largest distance from its f32 oracle, relative to the oracle's
largest value. The JAX script's ``--block-n`` / ``--block-k`` are TPU tiles:
K1 and K6 choose their own tiles. A shape K1 or K6 does not take is
skipped with the reason.

    python -m hydragen_torch.scripts.ubench_gemm [--shapes qkv_o,down] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from hydragen_torch.ops import gemm
from hydragen_torch.ops.quant import (
    Quantized4Tensor,
    QuantizedTensor,
    dequantize4,
    pick_group4,
    qmatmul,
)
from hydragen_torch.scripts import common
from hydragen_torch.utils.timing import bound_ms, time_flushed

SHAPES = {  # name: (K, N)
    "qkv_o": (4096, 4096),
    "gate_up": (4096, 11008),
    "down": (11008, 4096),
    "lm_head": (4096, 32000),
}
ARMS = ("bf16", "dq", "w8a8", "w4a8", "dq4")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--m", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--which", default=",".join(ARMS))
    p.add_argument("--shapes", default=",".join(SHAPES))
    common.add_device_arg(p)
    return p.parse_args(argv)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / max |ref|."""
    ref = ref.float()
    return float((out.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def shape_inputs(g, M: int, K: int, N: int, device):
    """The shape's operands from ``g``: bf16 activations ``[M, K]``, an int8
    weight ``[N, K]`` with bf16 column scales and its bf16 copy, a planar
    int4 weight ``[N, K/2]`` with bf16 group scales."""
    x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (N, K), generator=g, device=device, dtype=torch.int8)
    wscale = (torch.rand(N, generator=g, device=device) * 0.02).to(torch.bfloat16)
    group = pick_group4(K)
    w4 = Quantized4Tensor(
        qp=torch.randint(-128, 128, (N, K // 2), generator=g, device=device, dtype=torch.int8),
        gscale=(torch.rand(K // group, N, generator=g, device=device) * 0.02).to(torch.bfloat16))
    return x, QuantizedTensor(q=w8, scale=wscale), (w8.to(torch.bfloat16) * wscale[:, None]), w4


def arms(x, w8: QuantizedTensor, wbf: torch.Tensor, w4: Quantized4Tensor) -> dict:
    """arm: (op, args, oracle, bytes the weight takes, operand type), for the
    arms these operands allow; an arm K1 or K6 does not take maps to the
    reason."""
    M, K = x.shape
    N = wbf.shape[0]
    xf = x.float()

    def w8a8(x, q, s):
        a_q, a_s = gemm.quantize_rows(x)
        return gemm.w8a8_matmul(a_q, a_s, q, s)

    def w4a8(x, qp, gs):
        a_q, a_s = gemm.quantize_rows(x)
        return gemm.w4a8_matmul(a_q, a_s, qp, gs)

    def s8_oracle(ref, *w):
        a_q, a_s = gemm.quantize_rows(x)
        return ref(a_q, a_s, *w, out_dtype=torch.float32)

    out = {
        "bf16": (lambda x, w: torch.matmul(x, w.t()), (x, wbf), lambda: xf @ wbf.float().t(),
                 N * K * 2, "bf16"),
        "dq": (lambda x, q, s: qmatmul(x, QuantizedTensor(q, s), "mk,kn->mn", impl="dq"),
               (x, *w8), lambda: xf @ wbf.float().t(), N * K + N * 2, "bf16"),
    }
    if gemm.w8a8_supported(N, K):
        out["w8a8"] = (w8a8, (x, *w8), lambda: s8_oracle(gemm.w8a8_reference, *w8),
                       N * K + N * 2, "int8")
    else:
        out["w8a8"] = f"K1 does not take N={N}, K={K} (rows of 16 bytes, paired columns)"
    w4_bytes = N * K // 2 + w4.gscale.numel() * 2
    if gemm.w4a8_supported(N, K // 2, w4.group_size):
        out["w4a8"] = (w4a8, (x, *w4), lambda: s8_oracle(gemm.w4a8_reference, *w4), w4_bytes,
                       "int8")
    else:
        out["w4a8"] = (f"K6 does not take N={N}, K={K} at group {w4.group_size} (a group of "
                       "a multiple of 64 in one nibble plane, paired columns)")
    out["dq4"] = (lambda x, qp, gs: qmatmul(x, Quantized4Tensor(qp, gs), "mk,kn->mn", impl="dq"),
                  (x, *w4), lambda: xf @ dequantize4(w4, torch.float32), w4_bytes, "bf16")
    return out


def main(argv=None) -> list:
    """Returns a row a (shape, arm): its mean ms, bound ms and what bounds
    it, TOP/s or TFLOP/s, and its relative distance from its oracle."""
    args = parse_args(argv)
    device = common.device_of(args, "ubench_gemm")
    which = args.which.split(",")
    g = common.generator(device)
    M = args.m
    print(f"card: {common.card_name(device)}")
    rows = []
    for name in args.shapes.split(","):
        K, N = SHAPES[name]
        flops = 2 * M * K * N
        print(f"== {name}: M={M} K={K} N={N}  ({flops / 1e9:.1f} GFLOP)")
        x, w8, wbf, w4 = shape_inputs(g, M, K, N, device)
        for arm, spec in arms(x, w8, wbf, w4).items():
            if arm not in which:
                continue
            if isinstance(spec, str):
                print(f"  {arm:5s}: skipped ({spec})")
                continue
            op, op_args, oracle, w_bytes, kind = spec
            err = rel_err(op(*op_args), oracle())
            times = time_flushed(op, op_args, args.iters, device)
            ms = 1e3 * sum(times) / len(times)
            b_ms, by = bound_ms(M * K * 2 + w_bytes + M * N * 2, flops, kind)
            rate = flops / (ms * 1e-3) / 1e12
            print(f"  {arm:5s}: {ms * 1e3:9.1f} us  ({rate:6.1f} {'TOP' if kind == 'int8' else 'TFLOP'}"
                  f"/s), bound {b_ms * 1e3:.1f} us ({by}), max |err| / max |oracle| {err:.3g}")
            rows.append(dict(shape=name, arm=arm, M=M, K=K, N=N, ms=ms, bound_ms=b_ms,
                             bound_by=by, rate_t=rate, rel_err=err))
    return rows


if __name__ == "__main__":
    main()
