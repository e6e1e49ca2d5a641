"""Synthetic end-to-end benchmark sweep.

Port of the JAX package's ``scripts/synth.py``: sweep batch size x shared
prefix length x new tokens over modes {hydragen, hydragen_noshared,
noattention} (and the hierarchy ablation), one YAML per point (resumable:
existing files are skipped). "hydragen_noshared" is the no-sharing baseline
(``disable_hydragen``), "noattention" the attention-free upper bound
(``disable_attention``). A point's time is the wall time of one whole
``generate`` call (prefill included), fenced on the device.

Random weights by default (timing does not depend on their values), drawn
on the device from a seeded generator; ``--pretrained DIR`` loads a local HF
checkpoint. ``--tp``/``--dp`` run one process a rank (rank 0 writes the
YAMLs); the no-sharing baseline under a mesh raises ``NotImplementedError``.

    python -m hydragen_torch.scripts.synth OUTDIR --preset llama-2-7b \\
        --quantization w8a8 --kv-quant int8 --bs 64:256:x2 --mode all
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from pathlib import Path

import numpy as np
import torch

from hydragen_torch.core.engine import HydragenLlama, SharedCacheOp
from hydragen_torch.models.config import PRESETS
from hydragen_torch.models.llama import init_params
from hydragen_torch.scripts import common
from hydragen_torch.utils import (
    SynthBenchmarkResult,
    save_yaml_dataclass,
    split_range,
    timed,
)
from hydragen_torch.utils.capacity import HBM_BYTES, param_bytes

MODES = ("hydragen", "hydragen_noshared", "noattention", "hydragen_nohierarchy")


def hbm_bytes(cfg, quant, kv_quant, bs, ns, nu, mode, levels,
              shared_int8=None, level2_bs=0) -> int:
    """Device bytes a sweep point needs: weights, the unique and shared
    caches (payloads and f32 scales), the largest transient (the no-sharing
    baseline's copy of the prefix into every row, or one layer of the shared
    prefill's new KV) and the prefill's activation rows. The JAX package's
    formula: the port keeps its cache shapes, dtypes and scale layouts."""
    L = cfg.num_hidden_layers
    weights = param_bytes(cfg, quant)
    per_tok = cfg.num_key_value_heads * cfg.head_dim * 2
    itemsize = {None: 2, "int8": 1, "int4": 0.5}[kv_quant]
    if shared_int8 is None:
        shared_int8 = kv_quant is not None
    s_itemsize = 1 if shared_int8 else 2
    unique_len = nu + 8 + (ns if mode == "hydragen_noshared" else 0)
    # Level-1 sub-prompts live in a shared level (stored once a prefix),
    # except in the no-hierarchy ablation, where they join each row's suffix.
    l2_len = max(16, ns // 8) if levels == 2 else 0
    l2 = (level2_bs or max(1, int(bs ** 0.5))) if levels == 2 else 0
    if mode == "hydragen_nohierarchy":
        unique_len += l2_len
    u_tokens = bs * unique_len
    shared_tokens = ns + l2 * l2_len
    cache = int(L * u_tokens * per_tok * itemsize) \
        + L * shared_tokens * per_tok * s_itemsize
    if kv_quant is not None:
        cache += L * u_tokens * cfg.num_key_value_heads * 2 * 4  # f32 scales
    if shared_int8:
        cache += L * shared_tokens * cfg.num_key_value_heads * 2 * 4
    transient = 0
    if mode == "hydragen_noshared":  # copy_shared_to_unique's repeat
        transient = L * bs * ns * per_tok * itemsize
    # The shared prefill writes each layer's KV into the level as it goes:
    # one layer's new KV is in flight.
    sp_item = (1 + 4 / cfg.head_dim) if shared_int8 else 2
    transient = max(transient, int(ns * per_tok * sp_item))
    if mode == "hydragen_noshared":
        up_item = (1 + 4 / cfg.head_dim) if kv_quant else 2
        transient = max(
            transient,
            int(L * bs * (ns + nu) * per_tok * up_item)
            + L * bs * ns * per_tok * itemsize,  # the repeat copy coexists
        )
    act = 6 * ns * max(cfg.intermediate_size, cfg.hidden_size) * 2
    return weights + cache + transient + act


def fits_hbm(cfg, quant, kv_quant, bs, ns, nu, mode, levels,
             shared_int8=None, level2_bs=0, device="cuda") -> bool:
    """Pre-flight device-memory estimate, so that a grid can hold points the
    card cannot (the no-sharing baseline at paper scale): those are skipped
    with a note instead of running out of memory mid-sweep. Binding on a
    CUDA device (``utils/capacity.HBM_BYTES``); on the CPU every point fits.
    ``quant`` is the quantization mode (None/int8/w8a8/int4/w4a8)."""
    if torch.device(device).type != "cuda":
        return True
    return hbm_bytes(cfg, quant, kv_quant, bs, ns, nu, mode, levels,
                     shared_int8=shared_int8, level2_bs=level2_bs) < HBM_BYTES


def result_path(outdir: Path, mode: str, bs: int, ns: int, nu: int) -> Path:
    return outdir / f"{mode}_bs{bs}_ns{ns}_nu{nu}.yaml"


def bench_point(engine, mode: str, bs: int, ns: int, nu: int, iters: int,
                vocab: int, measure_prefill: bool, levels: int = 1,
                level2_bs: int = 0, kv_quant=None, shared_kv_quant="follow"):
    """Time ``iters`` generate calls of one point (after 2 warm-up calls,
    which also capture its decode graph); with ``measure_prefill``, also a
    series of 1-token calls. Returns (times, warmup, prefill_times)."""
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, vocab, size=(1, ns)).astype(np.int32)
    unique_len = nu + 8 + (ns if mode == "hydragen_noshared" else 0)
    if mode == "hydragen_nohierarchy":
        assert levels == 2, "nohierarchy ablation needs --levels 2"
        unique_len += max(16, ns // 8)  # the flattened level-1 prompt
    if levels == 2:
        # Two-level hierarchy (paper §4.4): level 0 one shared prompt, level
        # 1 level2_bs distinct sub-prompts, bs/level2_bs completions each.
        l2 = level2_bs or max(1, int(bs ** 0.5))
        assert bs % l2 == 0
        prompt2 = rng.randint(1, vocab, size=(l2, max(16, ns // 8))).astype(np.int32)
        inputs = [prompt, prompt2]
        shared_bs, shared_len = [1, l2], [ns, prompt2.shape[1]]
    else:
        inputs = [prompt]
        shared_bs, shared_len = [1], [ns]
    engine.cache = None  # free the previous point's buffers before allocating
    engine.setup_caches(
        max_unique_batch_size=bs,
        max_unique_seq_length=unique_len,
        max_shared_batch_sizes=shared_bs,
        max_shared_seq_lengths=shared_len,
        kv_quant=kv_quant,
        shared_kv_quant=shared_kv_quant,
    )

    def gen(max_new=nu):
        return engine.generate(
            input_ids=inputs,
            num_return_sequences=bs // (inputs[-1].shape[0]),
            max_new_tokens=max_new,
            temperature=0.0,
            shared_cache_op=SharedCacheOp.WIPE,
            disable_hydragen=(mode == "hydragen_noshared"),
            disable_attention=(mode == "noattention"),
            disable_hierarchy=(mode == "hydragen_nohierarchy"),
        )

    times, warmup = timed(gen, num_iters=iters, num_warmup=2, device=engine.device)
    prefill_times = []
    if measure_prefill:  # a separate prefill series from 1-token runs
        prefill_times, _ = timed(lambda: gen(1), num_iters=iters, num_warmup=1,
                                 device=engine.device)
    return times, warmup, prefill_times


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("outdir", type=Path)
    p.add_argument("--bs", default="32", help="sweep range, e.g. 32:1024:x2")
    p.add_argument("--num-shared", default="1024", help="shared prefix length range")
    p.add_argument("--num-unique", default="64", help="new tokens per sequence range")
    p.add_argument("--mode", default="hydragen", choices=MODES + ("all",))
    p.add_argument("--levels", type=int, default=1, choices=(1, 2),
                   help="2 = two-level hierarchy (paper §4.4)")
    p.add_argument("--level2-bs", type=int, default=0,
                   help="level-1 prefix count (default sqrt(bs))")
    p.add_argument("--preset", default="sheared-llama-1.3b")
    p.add_argument("--pretrained", default=None, help="a local HF checkpoint directory")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantization", default=None,
                   choices=[None, "int8", "w8a8", "int4", "w4a8"])
    p.add_argument("--kv-quant", default=None, choices=[None, "int8", "int4"],
                   help="int8 KV cache (halves the cache's bytes)")
    p.add_argument("--shared-kv", default="follow", choices=("follow", "none", "int8"),
                   help="shared-level KV precision (none = compute dtype)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--impl", default=None, choices=(None,) + tuple(common.IMPLS),
                   help=common.IMPL_HELP)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--measure-prefill", action="store_true")
    common.add_device_arg(p)
    return p.parse_args(argv)


def make_engine(args, device, mesh=None):
    """(engine, model name) from a checkpoint or seeded random weights."""
    impl = common.impl_of(args.impl)
    if args.pretrained:
        kw = dict(mesh=mesh) if mesh is not None else dict(device=device)
        engine = HydragenLlama.from_pretrained(
            args.pretrained, dtype=args.dtype, quantization=args.quantization, impl=impl, **kw)
        return engine, args.pretrained
    cfg = PRESETS[args.preset]
    if cfg.dtype != args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = init_params(cfg, common.generator(device), quantized=args.quantization or False,
                         device=device)
    engine = HydragenLlama(cfg, params, quantization=args.quantization, impl=impl,
                           device=device, mesh=mesh)
    return engine, args.preset


def sweep_modes(args) -> tuple:
    if args.mode != "all":
        return (args.mode,)
    # The no-sharing baseline takes the flat two-level layout only; a
    # hierarchical sweep compares Hydragen with the no-hierarchy ablation.
    return ("hydragen", "noattention", "hydragen_nohierarchy") if args.levels == 2 \
        else MODES[:3]


def sweep_grid(args) -> list:
    return list(itertools.product(
        split_range(args.bs), split_range(args.num_shared), split_range(args.num_unique)
    ))


def run(args, device, mesh=None, rank: int = 0) -> list:
    """The sweep on this process (one rank of ``mesh``, or alone). Returns
    the paths written (rank 0) or that would be (other ranks)."""
    if mesh is not None:
        device = mesh.device
    engine, model_name = make_engine(args, device, mesh)
    modes = sweep_modes(args)
    if rank == 0:
        args.outdir.mkdir(parents=True, exist_ok=True)
    grid = sweep_grid(args)
    # Every rank decides what to run before rank 0 writes anything.
    todo = [(bs, ns, nu, mode) for bs, ns, nu in grid for mode in modes
            if not result_path(args.outdir, mode, bs, ns, nu).exists()]
    written = []
    for bs, ns, nu in grid:
        for mode in modes:
            path = result_path(args.outdir, mode, bs, ns, nu)
            if (bs, ns, nu, mode) not in todo:
                print(f"skip (exists): {path}")
                continue
            if mode == "hydragen_noshared" and args.kv_quant == "int4":
                # The baseline's copied prefix cannot live in the int4
                # token-planar pack (the engine raises); run it at int8.
                print(f"skip (noshared unsupported with kv int4): bs={bs}")
                continue
            shared_int8 = {"follow": args.kv_quant is not None, "int8": True,
                           "none": False}[args.shared_kv]
            if not fits_hbm(engine.config, args.quantization, args.kv_quant, bs, ns, nu, mode,
                            args.levels, level2_bs=args.level2_bs, shared_int8=shared_int8,
                            device=engine.device):
                print(f"skip (exceeds HBM): mode={mode} bs={bs} ns={ns} nu={nu}")
                continue
            print(f"run: mode={mode} bs={bs} shared={ns} unique={nu}")
            times, warmup, prefill = bench_point(
                engine, mode, bs, ns, nu, args.iters, engine.config.vocab_size,
                args.measure_prefill, levels=args.levels, level2_bs=args.level2_bs,
                kv_quant=args.kv_quant, shared_kv_quant=args.shared_kv,
            )
            res = SynthBenchmarkResult(
                mode=mode, batch_size=bs, num_shared=ns, num_unique=nu, model=model_name,
                times=times, warmup_times=warmup, prefill_times=prefill,
            )
            if res.rstd > 0.1:
                print(f"WARNING: rstd {res.rstd:.3f} > 0.1 (noisy measurement)")
            print(f"  mean {res.mean_time*1e3:.2f} ms, {res.throughput:.0f} tok/s")
            if rank == 0:
                save_yaml_dataclass(res, path)
            written.append(path)
    return written


def _rank(rank: int, world: int, args) -> list:
    with common.rank_output(rank):
        return run(args, None, mesh=common.rank_mesh(args, args.tp, args.dp), rank=rank)


def main(argv=None) -> list:
    args = parse_args(argv)
    device = common.device_of(args, "synth")
    if args.tp * args.dp > 1:
        return common.over_ranks(_rank, args.tp * args.dp, device, args,
                                 points=len(sweep_grid(args)) * len(sweep_modes(args)))[0]
    return run(args, device)


if __name__ == "__main__":
    main()
