"""Profile the decode step: wall time a step and device time by kernel.

Port of the JAX package's ``scripts/profile_decode.py``. Builds ``bench.py``'s
configuration (``llama-2-7b``, w8a8 weights, int8 KV, bs 256, a 2,048-token
shared prefix by default), warms it (the decode graph is captured), prints
the wall time a decode step (a short and a full ``generate`` differenced, so
the prefill and sampling cancel), then profiles ``--steps`` decode steps of
one more request under ``torch.profiler`` and prints the kernels by device
time, each kernel's instantiations folded into one row
(``utils/profiling.step_summary``), with the profiler's busy time beside the
block's wall time.

    python -m hydragen_torch.scripts.profile_decode [--model llama-2-7b] \\
        [--bs 256] [--shared 2048] [--new 64] [--steps 32] [--no-trace]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from hydragen_torch.core.engine import HydragenLlama, SharedCacheOp
from hydragen_torch.models.config import PRESETS
from hydragen_torch.models.llama import init_params
from hydragen_torch.scripts import common
from hydragen_torch.utils.profiling import print_op_summary, print_step_summary, trace_decode
from hydragen_torch.utils.timing import fence


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="llama-2-7b")
    ap.add_argument("--bs", type=int, default=256)
    ap.add_argument("--shared", type=int, default=2048)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--quant", default="w8a8",
                    help="weight quantization (bench.py's w8a8; none for the model dtype)")
    ap.add_argument("--kv", default="int8")
    ap.add_argument("--shared-kv", default="follow", choices=("follow", "none", "int8"),
                    help="shared-level KV precision (none = compute dtype)")
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--levels", type=int, default=1, choices=(1, 2),
                    help="2 = a two-level hierarchy (level 0: one --shared prompt; "
                    "level 1: --level2-bs distinct --level2-shared sub-prompts)")
    ap.add_argument("--level2-bs", type=int, default=8)
    ap.add_argument("--level2-shared", type=int, default=256)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {"decode_ms_per_step": wall, "summary": StepSummary or None}."""
    args = parse_args(argv)
    device = common.device_of(args, "profile_decode")
    cfg = PRESETS[args.model]
    quant = None if args.quant in ("", "none") else args.quant
    kv_quant = None if args.kv in ("", "none") else args.kv
    params = init_params(cfg, common.generator(device), quantized=quant or False,
                         device=device)
    engine = HydragenLlama(cfg, params, quantization=quant, device=device)

    rng = np.random.RandomState(0)
    prompt = rng.randint(1, cfg.vocab_size, size=(1, args.shared)).astype(np.int32)
    level_bs, level_lens, prompts = [1], [args.shared], [prompt]
    if args.levels == 2:
        assert args.bs % args.level2_bs == 0
        level_bs.append(args.level2_bs)
        level_lens.append(args.level2_shared)
        prompts.append(rng.randint(
            1, cfg.vocab_size, size=(args.level2_bs, args.level2_shared)
        ).astype(np.int32))

    engine.setup_caches(
        max_unique_batch_size=args.bs,
        max_unique_seq_length=args.new,
        max_shared_batch_sizes=level_bs,
        max_shared_seq_lengths=level_lens,
        kv_quant=kv_quant,
        shared_kv_quant=args.shared_kv,
    )
    nrs = args.bs if args.levels == 1 else args.bs // args.level2_bs

    def gen(steps):
        out = engine.generate(
            input_ids=prompts,
            num_return_sequences=nrs,
            max_new_tokens=steps,
            temperature=0.0,
            shared_cache_op=SharedCacheOp.WIPE,
        )
        fence(device)
        return out

    t0 = time.perf_counter()
    gen(args.new)
    print(f"warmup (kernel build, graph capture): {time.perf_counter() - t0:.1f} s")

    # Wall time a decode step: a short and a full run differenced, so the
    # prefill and the first sample cancel; the best of 3 each.
    times = {}
    for steps in (2, args.new):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            gen(steps)
            best = min(best, time.perf_counter() - t0)
        times[steps] = best
    per_step = (times[args.new] - times[2]) / (args.new - 2)
    print(f"decode wall: {per_step*1e3:.3f} ms/step  "
          f"({args.bs/per_step:.0f} tok/s decode-only)")

    summary = None
    if not args.no_trace:
        # One request of --steps + 1 tokens: its prefill outside the profile,
        # its decode steps inside.
        tr = trace_decode(engine, lambda: gen(args.steps + 1))
        print_op_summary(tr, top=args.top)
        summary = print_step_summary(tr, args.steps, top=args.top)
    return {"decode_ms_per_step": per_step * 1e3, "summary": summary}


if __name__ == "__main__":
    main()
