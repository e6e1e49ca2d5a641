"""Attention-op microbenchmark: Hydragen against plain flash attention.

Port of the JAX package's ``scripts/microbenchmark.py``: time the Hydragen
attention op (one shared level plus per-sequence unique KV) against one
flash-attention call over each sequence's concatenated prefix and suffix
KV, the kernel-level version of the paper's Fig. 5. Defaults: 8 query heads
over 1 kv head (one GQA group of a tensor-parallel shard), head dim 128.

Each timed call is a replay of the op captured as a CUDA graph, after a
write of a buffer twice the card's L2 cache, and CUDA events time the
replay alone. The flush is needed on the card: at the
defaults the shared K and V take 1 MiB and would stay in the 50 MB L2
between back-to-back calls, so Hydragen's shared read would be timed out of
L2, while the baseline's broadcast KV (about 537 MB) streams from HBM
either way. A caller meets the prefix cold: the model's other layers and
projections run between two reads of a layer's level.

    python -m hydragen_torch.scripts.microbenchmark OUTDIR --bs 512:4096:x2
"""

from __future__ import annotations

import argparse
import itertools
from pathlib import Path

import torch

from hydragen_torch.ops.flash import flash_attention
from hydragen_torch.ops.hydragen import hydragen_attention
from hydragen_torch.scripts import common
from hydragen_torch.utils import MicrobenchmarkResult, save_yaml_dataclass, split_range
from hydragen_torch.utils.timing import time_flushed


def make_inputs(generator, bs, ns, nu, hq, hkv, d, dtype, device):
    """(q, shared_k, shared_v, unique_k, unique_v), BSHD, normal draws from
    ``generator`` on ``device``; the unique pair is None when ``nu`` is 0."""
    def draw(*shape):
        return torch.randn(shape, generator=generator, device=device).to(dtype)

    q = draw(bs, 1, hq, d)
    shared_k = draw(1, ns, hkv, d)
    shared_v = draw(1, ns, hkv, d)
    uk = draw(bs, nu, hkv, d) if nu else None
    uv = draw(bs, nu, hkv, d) if nu else None
    return q, shared_k, shared_v, uk, uv


def go_hydragen(q, sk, sv, uk, uv, nu, bs):
    """(op, args): ``hydragen_attention`` over one shared level and, when
    ``nu``, the unique KV of every row at its full length."""
    if uk is None:
        return (lambda q, sk, sv: hydragen_attention(
            q, None, None, [sk], [sv], [None])), (q, sk, sv)
    seq_lens = torch.full((bs,), nu, dtype=torch.int32, device=q.device)
    return (lambda q, sk, sv, uk, uv: hydragen_attention(
        q, uk, uv, [sk], [sv], [None], seq_lens=seq_lens)), (q, sk, sv, uk, uv)


def go_baseline(q, sk, sv, uk, uv, nu, bs):
    """(op, args): the port's ``flash_attention`` over each row's prefix
    (broadcast to the batch) concatenated with its suffix."""
    ns = sk.shape[1]

    def fn(q, sk, sv, uk=None, uv=None):
        k = sk.expand((bs, ns) + tuple(sk.shape[2:]))
        v = sv.expand((bs, ns) + tuple(sv.shape[2:]))
        if uk is not None:
            k = torch.cat([k, uk], dim=1)
            v = torch.cat([v, uv], dim=1)
        out, _ = flash_attention(q, k.contiguous(), v.contiguous(), causal=False)
        return out

    if uk is None:
        return fn, (q, sk, sv)
    return fn, (q, sk, sv, uk, uv)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("outdir", type=Path)
    p.add_argument("--bs", default="512", help="e.g. 512:4096:x2")
    p.add_argument("--num-shared", default="2048", help="e.g. 512:8192:x2")
    p.add_argument("--num-unique", default="128", help="e.g. 0,128,512")
    p.add_argument("--qheads", type=int, default=8)
    p.add_argument("--kvheads", type=int, default=1)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--modes", default="hydragen,baseline")
    common.add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Returns the results of the points run (a point whose YAML exists is
    skipped)."""
    args = parse_args(argv)
    device = common.device_of(args, "microbenchmark")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    args.outdir.mkdir(parents=True, exist_ok=True)
    modes = args.modes.split(",")
    results = []
    for bs, ns, nu in itertools.product(
        split_range(args.bs), split_range(args.num_shared), split_range(args.num_unique)
    ):
        q, sk, sv, uk, uv = make_inputs(
            common.generator(device), bs, ns, nu, args.qheads, args.kvheads,
            args.dim, dtype, device,
        )
        for mode in modes:
            path = args.outdir / f"{mode}_bs{bs}_ns{ns}_nu{nu}.yaml"
            if path.exists():
                print(f"skip (exists): {path}")
                continue
            maker = go_hydragen if mode == "hydragen" else go_baseline
            op, op_args = maker(q, sk, sv, uk, uv, nu, bs)
            res = MicrobenchmarkResult(
                batch_size=bs, num_shared=ns, num_unique=nu,
                num_qheads=args.qheads, num_kvheads=args.kvheads,
                head_dim=args.dim, mode=mode,
                times=time_flushed(op, op_args, args.iters, device),
            )
            print(f"{mode} bs={bs} ns={ns} nu={nu}: {res.mean_time*1e6:.1f} us "
                  f"(rstd {res.rstd:.3f})")
            save_yaml_dataclass(res, path)
            results.append(res)
    return results


if __name__ == "__main__":
    main()
