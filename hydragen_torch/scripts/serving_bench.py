"""Continuous-batching (serving) benchmark: ring-slot pool against a static
batch.

Port of the JAX package's ``scripts/serving_bench.py``. Workload: N requests
with random prompts and token budgets share one prefix; the
``ContinuousBatcher`` drains them through a B-row pool in decode chunks
(each a captured CUDA graph on the card), admitting between chunks. The
static comparison runs ceil(N/B) full batches of the same requests, each
with the budget of its longest request (what a naive server would do). Each
side runs once to warm (graphs captured), then twice; the better of the two
is reported as one JSON line. Every request must come back with at least one
and at most its budget of tokens.

    python -m hydragen_torch.scripts.serving_bench --preset sheared-llama-1.3b \\
        --quantization int8 --requests 96 --pool 32 --shared 1024
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from hydragen_torch.core.batching import ContinuousBatcher
from hydragen_torch.core.engine import HydragenLlama, SharedCacheOp
from hydragen_torch.models.config import PRESETS
from hydragen_torch.models.llama import init_params
from hydragen_torch.scripts import common
from hydragen_torch.utils.timing import fence


def build_requests(rng, n, prompt_len, budget_lo, budget_hi, vocab):
    reqs = []
    for _ in range(n):
        p = rng.randint(1, vocab, size=(prompt_len,)).astype(np.int32)
        reqs.append((p, int(rng.randint(budget_lo, budget_hi + 1))))
    return reqs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="sheared-llama-1.3b")
    ap.add_argument("--quantization", default="int8",
                    choices=["int8", "w8a8", "int4", "w4a8", "none"])
    ap.add_argument("--kv-quant", default=None, choices=[None, "int8"])
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--pool", type=int, default=32)
    ap.add_argument("--shared", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--budget", default="8:64")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--policy", default="lpt", choices=["fifo", "lpt"],
                    help="admission order: lpt = longest budget first (finish times "
                    "align within chunks), fifo = arrival order (latency-fair)")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="decode chunks in flight before the host reads one back")
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Prints and returns the JSON line's dict."""
    args = parse_args(argv)
    device = common.device_of(args, "serving_bench")
    cfg = PRESETS[args.preset]
    quant = None if args.quantization == "none" else args.quantization
    params = init_params(cfg, common.generator(device), quantized=quant or False,
                         device=device)
    rng = np.random.RandomState(args.seed)
    prefix = rng.randint(1, cfg.vocab_size, size=(1, args.shared)).astype(np.int32)
    lo, hi = (int(x) for x in args.budget.split(":"))
    reqs = build_requests(rng, args.requests, args.prompt_len, lo, hi, cfg.vocab_size)
    total_tokens = sum(b for _, b in reqs)
    pool_width = args.prompt_len + hi + args.chunk

    def make_engine():
        eng = HydragenLlama(cfg, params, quantization=quant, device=device)
        eng.setup_caches(
            max_unique_batch_size=args.pool,
            max_unique_seq_length=pool_width,
            max_shared_batch_sizes=[1],
            max_shared_seq_lengths=[args.shared],
            kv_quant=args.kv_quant,
        )
        eng.append_shared(prefix)
        return eng

    def run_continuous():
        eng = make_engine()
        cb = ContinuousBatcher(eng, chunk=args.chunk, bucket=args.prompt_len,
                               admit_policy=args.policy, lookahead=args.lookahead)
        rids = [cb.submit(ids, max_new_tokens=budget) for ids, budget in reqs]
        fence(device)
        t0 = time.perf_counter()
        out = cb.run()
        dt = time.perf_counter() - t0
        bad = [r for r, (_, budget) in zip(rids, reqs)
               if not 1 <= len(out.get(r, ())) <= budget]
        if len(out) != len(reqs) or bad:
            raise RuntimeError(f"serving_bench: {len(out)} of {len(reqs)} requests back, "
                               f"{len(bad)} outside their budgets (first {bad[:4]})")
        return dt

    def run_static():
        eng = make_engine()
        B = args.pool
        fence(device)
        t0 = time.perf_counter()
        for i in range(0, len(reqs), B):
            batch = reqs[i : i + B]
            while len(batch) < B:
                batch = batch + batch[: B - len(batch)]
            ids = np.stack([p for p, _ in batch])
            budget = max(b for _, b in batch)
            eng.generate(
                input_ids=[ids], max_new_tokens=budget, temperature=0.0,
                shared_cache_op=SharedCacheOp.PRESERVE,
            ).cpu()
        return time.perf_counter() - t0

    # Warm (graph captures), then the better of two.
    run_continuous()
    run_static()
    t_cont = min(run_continuous() for _ in range(2))
    t_stat = min(run_static() for _ in range(2))
    res = {
        "requests": len(reqs),
        "total_new_tokens": total_tokens,
        "continuous_s": round(t_cont, 3),
        "static_s": round(t_stat, 3),
        "continuous_tok_s": round(total_tokens / t_cont, 1),
        "ratio_vs_static": round(t_cont / t_stat, 3),
        "policy": args.policy,
        "chunk": args.chunk,
        "lookahead": args.lookahead,
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
