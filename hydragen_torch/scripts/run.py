"""Quickstart CLI: multi-level shared-prefix generation.

Port of the JAX package's ``scripts/run.py``. Prompts are given as
``|``-separated levels: ``--prompts "system prompt" "few|shot" "q1|q2|q3|q4"``
builds a 3-level hierarchy whose level sizes must divide the next level's.
Needs a local HF checkpoint directory with its tokenizer (read by
``transformers.AutoTokenizer``; nothing is downloaded). ``--tp``/``--dp``
run one process a rank, each loading its slices through
``HydragenLlama.from_pretrained_tp``; rank 0 prints.

    python -m hydragen_torch.scripts.run CKPT_DIR --prompts "You are terse." \\
        "Name a colour.|Name a fruit." --num-return-sequences 4
"""

from __future__ import annotations

import argparse

import numpy as np

from hydragen_torch.core.engine import HydragenLlama, SharedCacheOp
from hydragen_torch.scripts import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("pretrained", help="a local HF checkpoint directory")
    p.add_argument("--prompts", nargs="+", required=True,
                   help="one string per level; '|' separates prompts in a level")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--num-return-sequences", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantization", default=None,
                   choices=[None, "int8", "w8a8", "int4", "w4a8"],
                   help="weight quantization (on the host, while loading)")
    p.add_argument("--kv-quant", default=None, choices=[None, "int8", "int4"],
                   help="KV-cache precision")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    p.add_argument("--dp", type=int, default=1, help="data-parallel degree")
    p.add_argument("--seed", type=int, default=0)
    common.add_device_arg(p)
    return p.parse_args(argv)


def run(args, device) -> dict:
    """Generate and print one block a row; with ``--tp``/``--dp`` this is one
    rank of an initialised group. Returns {"tokens": [rows, T] int32,
    "texts": decoded rows}."""
    from transformers import AutoTokenizer

    levels = [s.split("|") for s in args.prompts]
    for prev, cur in zip(levels, levels[1:]):
        if len(cur) % len(prev):
            raise ValueError(f"level sizes must divide: {len(prev)} then {len(cur)}")

    tok = AutoTokenizer.from_pretrained(args.pretrained)
    kw = dict(dtype=args.dtype, quantization=args.quantization)
    if args.tp * args.dp > 1:
        engine = HydragenLlama.from_pretrained_tp(
            args.pretrained, tp=args.tp, dp=args.dp,
            device="cpu" if args.device == "cpu" else None, **kw)
    else:
        engine = HydragenLlama.from_pretrained(args.pretrained, device=device, **kw)

    # Tokenized per level, BOS only at level 0. A level is rectangular: its
    # prompts must tokenize to one length.
    ids = []
    for i, lvl in enumerate(levels):
        enc = [tok.encode(s, add_special_tokens=(i == 0)) for s in lvl]
        width = max(len(e) for e in enc)
        if any(len(e) != width for e in enc):
            raise ValueError("prompts within a level must tokenize to equal lengths "
                             "(pass seq_lens through the library API for ragged levels)")
        ids.append(np.asarray(enc, dtype=np.int32))

    final_bs = ids[-1].shape[0] * args.num_return_sequences
    engine.setup_caches(
        max_unique_batch_size=final_bs,
        max_unique_seq_length=ids[-1].shape[1] + args.max_new_tokens + 8,
        max_shared_batch_sizes=[a.shape[0] for a in ids],
        max_shared_seq_lengths=[a.shape[1] + 8 for a in ids],
        kv_quant=args.kv_quant,
    )
    out = engine.generate(
        input_ids=ids,
        num_return_sequences=args.num_return_sequences,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        eos_token_id=tok.eos_token_id,
        shared_cache_op=SharedCacheOp.WIPE,
        seed=args.seed,
    ).cpu().numpy()
    texts = [tok.decode(row, skip_special_tokens=True) for row in out]
    for text in texts:
        print("---")
        print(text)
    return {"tokens": out, "texts": texts}


def _rank(rank: int, world: int, args) -> dict:
    with common.rank_output(rank):
        return run(args, None)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = common.device_of(args, "run")
    if args.tp * args.dp > 1:
        return common.over_ranks(_rank, args.tp * args.dp, device, args)[0]
    return run(args, device)


if __name__ == "__main__":
    main()
