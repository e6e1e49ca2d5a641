"""Unique-read microbenchmark: the decode step's read of the unique cache at
the Llama-2-7B batch-256 shapes (q ``[256, 32, 1, 128]``, int8 KV ``[256,
64, 32, 128]`` BSHD with f32 scales a (token, head)).

Port of the JAX package's ``scripts/ubench_unique.py``. The arms:

  plain    the plain read (``ops/reference.attention_bhsd``, ``kv_bshd``)
  k3       K3 through ``ops/decode.py:decode_attention_bshd`` on the flat
           (chunked) scales; its line gives ``dout`` and ``dlse``, its
           largest distances from the plain read
  plain4   the plain read of the token-planar int4 pack of the same keys
           and values (clipped to [-7, 7]), half the payload bytes
  kv4      K3 at ``kv_bits=4`` on that pack (``decode_attention_cached``),
           held to ``plain4``

Each call is a CUDA-graph replay after an L2 flush
(``utils/timing.py:time_flushed``); beside its mean time stand its rate over
the payload it reads and the card's bound for the call's bytes and
operations (``utils/timing.py:bound_ms``). The JAX script's ``--rows`` (its
kernel's row batch) is a TPU tiling that K3 does not have, and its arms are
not wrapped to go on past a failure: a kernel that fails fails the run.

    python -m hydragen_torch.scripts.ubench_unique [--s 64] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from hydragen_torch.ops.decode import (
    chunk_kv_scales,
    decode_attention_bshd,
    decode_attention_cached,
)
from hydragen_torch.ops.reference import attention_bhsd
from hydragen_torch.scripts import common
from hydragen_torch.utils.timing import bound_ms, time_flushed

ARMS = ("plain", "k3", "plain4", "kv4")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--b", type=int, default=256)
    p.add_argument("--hq", type=int, default=32)
    p.add_argument("--hkv", type=int, default=32)
    p.add_argument("--s", type=int, default=64)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--which", default=",".join(ARMS))
    common.add_device_arg(p)
    return p.parse_args(argv)


def make_inputs(g, b, hq, hkv, s, d, device):
    """q bf16 ``[b, hq, 1, d]``, int8 k/v ``[b, s, hkv, d]``, f32 scales
    ``[b, s, hkv]`` (uniform in [0, 0.02)) and the lengths (all ``s``)."""
    q = torch.randn(b, hq, 1, d, generator=g, device=device).to(torch.bfloat16)
    k8, v8 = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=device,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, s, hkv, generator=g, device=device) * 0.02 for _ in range(2))
    return q, k8, v8, ks, vs, torch.full((b,), s, dtype=torch.int32, device=device)


def pack_tokens4(x: torch.Tensor) -> torch.Tensor:
    """``[b, s, hkv, d]`` int4 values -> the token-planar pack ``[b, s/2,
    hkv, d]``: byte row j holds token j low and token j + s/2 high."""
    s = x.shape[1]
    lo = x[:, :s // 2].to(torch.int32)
    hi = x[:, s // 2:].to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def arms(q, k8, v8, ks, vs, lens) -> dict:
    """arm: (payload bits, op, its arguments) over the int8 cache ``k8``,
    ``v8`` with scales ``ks``, ``vs`` ``[b, s, hkv]`` (the int4 arms over
    its clipped token-planar pack)."""
    b, s, hkv, _ = k8.shape
    k4, v4 = pack_tokens4(k8.clamp(-7, 7)), pack_tokens4(v8.clamp(-7, 7))
    ks_f = chunk_kv_scales(ks, hkv).reshape(1, b, s * hkv)
    vs_f = chunk_kv_scales(vs, hkv).reshape(1, b, s * hkv)
    plain_kw = dict(kv_seq_lens=lens, k_scale=ks, v_scale=vs, kv_bshd=True)
    return {
        "plain": (8, lambda q, k, v: attention_bhsd(q, k, v, **plain_kw), (q, k8, v8)),
        "k3": (8, lambda q, k, v, kc, vc: decode_attention_bshd(
            q, k, v, kv_seq_lens=lens, k_scale=kc, v_scale=vc, scales_chunked=True),
            (q, k8, v8, chunk_kv_scales(ks, hkv), chunk_kv_scales(vs, hkv))),
        "plain4": (4, lambda q, k, v: attention_bhsd(q, k, v, kv_bits=4, **plain_kw),
                   (q, k4, v4)),
        "kv4": (4, lambda q, k, v: decode_attention_cached(
            0, q, k[None], v[None], kv_seq_lens=lens, k_scale_all=ks_f, v_scale_all=vs_f,
            kv_bits=4), (q, k4, v4)),
    }


def main(argv=None) -> dict:
    """Returns each arm's mean ms, bound ms and what bounds it, and GB/s over
    its payload; ``k3`` and ``kv4`` also their ``dout`` and ``dlse`` from the
    plain read of their width."""
    args = parse_args(argv)
    device = common.device_of(args, "ubench_unique")
    b, hq, hkv, s, d = args.b, args.hq, args.hkv, args.s, args.d
    which = args.which.split(",")
    if s % 2:
        raise SystemExit(f"ubench_unique: --s {s} must be even (the int4 pack pairs tokens)")
    q, k8, v8, ks, vs, lens = make_inputs(common.generator(device), b, hq, hkv, s, d, device)
    scale_bytes = 4 * 2 * b * s * hkv
    payload = {8: 2 * b * s * hkv * d + scale_bytes, 4: b * s * hkv * d + scale_bytes}
    # Besides the payload a call reads q and lengths and writes out and lse.
    io_bytes = 2 * b * hq * d * 2 + 4 * b + 4 * b * hq
    ops = 4 * b * hq * s * d  # q.k and p.v
    print(f"card: {common.card_name(device)}")
    for bits in (8, 4):
        b_ms, by = bound_ms(payload[bits] + io_bytes, ops, "bf16")
        print(f"int{bits} payload {payload[bits] / 1e6:.0f} MB -> bound {b_ms * 1e3:.1f} us "
              f"({by}; 3.35 TB/s)")

    arm_ops = arms(q, k8, v8, ks, vs, lens)
    plain_of = {"k3": "plain", "kv4": "plain4"}
    res = {}
    for name in ARMS:
        if name not in which:
            continue
        bits, op, op_args = arm_ops[name]
        row = {}
        if name in plain_of:
            o, lse = op(*op_args)
            po, plse = arm_ops[plain_of[name]][1](*arm_ops[plain_of[name]][2])
            row.update(dout=float((o.float() - po.float()).abs().max()),
                       dlse=float((lse - plse).abs().max()),
                       rel=float((o.float() - po.float()).abs().max()
                                 / po.float().abs().max().clamp_min(1e-30)))
        times = time_flushed(op, op_args, args.iters, device)
        ms = 1e3 * sum(times) / len(times)
        b_ms, by = bound_ms(payload[bits] + io_bytes, ops, "bf16")
        row.update(ms=ms, bound_ms=b_ms, bound_by=by, GB_s=payload[bits] / (ms * 1e-3) / 1e9)
        extra = (f"  dout={row['dout']:.4f} dlse={row['dlse']:.5f}" if "dout" in row else "")
        print(f"{name:7s} int{bits}: {ms * 1e3:9.1f} us  ({row['GB_s']:.0f} GB/s of payload; "
              f"bound {b_ms * 1e3:.1f} us){extra}")
        res[name] = row
    return res


if __name__ == "__main__":
    main()
