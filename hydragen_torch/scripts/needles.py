"""Needle-in-a-haystack long-context benchmark.

Port of the JAX package's ``scripts/needles.py``: prefill a long haystack
document once into a shared cache level (``append_shared``), then answer
2..N questions batched as unique suffixes with ``shared_cache_op=PRESERVE``,
measuring the shared prefill and the decode time and the accuracy bucketed
by needle depth decile.

Needs a real instruction-following checkpoint (``--pretrained DIR`` with its
tokenizer) for meaningful accuracy; with ``--preset`` and random weights it
measures speed (the document is then ~4 characters a token of random ids).
``--tp`` runs one process a rank (rank 0 writes the YAMLs).

    python -m hydragen_torch.scripts.needles OUTDIR --preset yi-6b-200k \\
        --haystack-chars 65536 --num-questions 2:64:x2
"""

from __future__ import annotations

import argparse
import re
import time
from pathlib import Path

import numpy as np

from hydragen_torch.core.engine import HydragenLlama, SharedCacheOp
from hydragen_torch.data.haystack import make_needle_haystack
from hydragen_torch.models.config import PRESETS
from hydragen_torch.models.llama import init_params
from hydragen_torch.scripts import common
from hydragen_torch.utils import NeedlesBenchmarkResult, save_yaml_dataclass, split_range
from hydragen_torch.utils.timing import fence

PROMPT_TEMPLATE = (
    "Answer the question using the document above. "
    "Reply with just the answer between ###answer### markers.\n"
    "Question: {question}\nAnswer: ###"
)

ANSWER_RE = re.compile(r"###\s*(?:answer\s*###\s*)?([A-Za-z]+)")


def extract_answer(text: str):
    """The one-word answer of '###answer### Blue ...'-style output, lower
    case, or None."""
    m = ANSWER_RE.search(text)
    return m.group(1).strip().lower() if m else None


def score_answers(texts, needles):
    """Score decoded answers against their needles, bucketed by depth decile.

    texts: decoded model outputs, question ``i`` asked about needle
    ``i % len(needles)``. Returns (num_correct, correct_by_decile,
    count_by_decile), deciles from each needle's fractional position in the
    document.
    """
    correct_by_dec = [0] * 10
    count_by_dec = [0] * 10
    num_correct = 0
    for i, text in enumerate(texts):
        needle = needles[i % len(needles)]
        got = extract_answer("###" + text)
        dec = min(int((needle.position_in_doc or 0.0) * 10), 9)
        count_by_dec[dec] += 1
        if got == needle.answer.lower():
            correct_by_dec[dec] += 1
            num_correct += 1
    return num_correct, correct_by_dec, count_by_dec


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("outdir", type=Path)
    p.add_argument("--pretrained", default=None,
                   help="a local HF checkpoint directory with its tokenizer")
    p.add_argument("--preset", default="yi-6b-200k")
    p.add_argument("--haystack-chars", type=int, default=50_000)
    p.add_argument("--num-needles", type=int, default=64)
    p.add_argument("--num-questions", default="2:64:x2")
    p.add_argument("--max-new-tokens", type=int, default=12)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantization", default=None,
                   choices=[None, "int8", "w8a8", "int4", "w4a8"])
    p.add_argument("--kv-quant", default=None, choices=[None, "int8", "int4"])
    p.add_argument("--corpus", default=None, help="filler text file")
    p.add_argument("--tp", type=int, default=1)
    common.add_device_arg(p)
    return p.parse_args(argv)


def run(args, device, mesh=None, rank: int = 0) -> list:
    """The benchmark on this process. Returns the results of the question
    counts run."""
    if mesh is not None:
        device = mesh.device
    kw = dict(mesh=mesh) if mesh is not None else dict(device=device)
    doc, needles = make_needle_haystack(
        args.haystack_chars, args.num_needles, corpus_path=args.corpus
    )

    tok = None
    if args.pretrained:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.pretrained)
        engine = HydragenLlama.from_pretrained(
            args.pretrained, dtype=args.dtype, quantization=args.quantization, **kw)
        doc_ids = np.asarray([tok.encode(doc)], dtype=np.int32)
    else:
        cfg = PRESETS[args.preset]
        engine = HydragenLlama(
            cfg, init_params(cfg, common.generator(device),
                             quantized=args.quantization or False, device=device),
            quantization=args.quantization, **kw)
        # ~4 chars/token synthetic tokenization for speed-only runs.
        rng = np.random.RandomState(0)
        doc_ids = rng.randint(
            1, engine.config.vocab_size, size=(1, args.haystack_chars // 4)
        ).astype(np.int32)

    if rank == 0:
        args.outdir.mkdir(parents=True, exist_ok=True)
    q_counts = split_range(args.num_questions)
    todo = [n for n in q_counts if not (args.outdir / f"needles_q{n}.yaml").exists()]

    # Questions right-padded to one width; seq_lens keep the positions right.
    def question_ids(n):
        qs = [PROMPT_TEMPLATE.format(question=needles[i % len(needles)].question)
              for i in range(n)]
        if tok is not None:
            enc = [tok.encode(q, add_special_tokens=False) for q in qs]
        else:
            rng = np.random.RandomState(1)
            enc = [rng.randint(1, engine.config.vocab_size, size=(24,)).tolist()
                   for _ in qs]
        width = max(len(e) for e in enc)
        arr = np.zeros((n, width), dtype=np.int32)
        lens = np.zeros((n,), dtype=np.int32)
        for i, e in enumerate(enc):
            arr[i, : len(e)] = e
            lens[i] = len(e)
        return arr, lens

    q_arr_max, _ = question_ids(max(q_counts))
    engine.setup_caches(
        max_unique_batch_size=max(q_counts),
        max_unique_seq_length=q_arr_max.shape[1] + args.max_new_tokens + 8,
        max_shared_batch_sizes=[1],
        max_shared_seq_lengths=[doc_ids.shape[1] + 8],
        kv_quant=args.kv_quant,
    )

    # The shared prefill, once.
    fence(engine.device)
    t0 = time.perf_counter()
    engine.append_shared(doc_ids)
    fence(engine.device)
    shared_prefill_time = time.perf_counter() - t0
    print(f"shared prefill ({doc_ids.shape[1]} tok): {shared_prefill_time:.2f}s")

    results = []
    for n in q_counts:
        path = args.outdir / f"needles_q{n}.yaml"
        if n not in todo:
            print(f"skip (exists): {path}")
            continue
        arr, lens = question_ids(n)

        def gen():
            return engine.generate(
                input_ids=[arr],
                seq_lens=[lens],
                max_new_tokens=args.max_new_tokens,
                temperature=0.0,
                shared_cache_op=SharedCacheOp.PRESERVE,
            )

        gen()  # warm: captures the count's decode graph
        fence(engine.device)
        t0 = time.perf_counter()
        out = gen().cpu().numpy()
        decode_time = time.perf_counter() - t0

        correct_by_dec = [0] * 10
        count_by_dec = [0] * 10
        num_correct = 0
        if tok is not None:
            texts = [tok.decode(out[i], skip_special_tokens=True) for i in range(n)]
            num_correct, correct_by_dec, count_by_dec = score_answers(texts, needles)
        res = NeedlesBenchmarkResult(
            num_questions=n,
            haystack_chars=args.haystack_chars,
            num_correct=num_correct,
            accuracy_by_decile=[
                (c / t if t else 0.0) for c, t in zip(correct_by_dec, count_by_dec)
            ],
            counts_by_decile=count_by_dec,
            shared_prefill_time=shared_prefill_time,
            decode_times=[decode_time],
        )
        tput = n * args.max_new_tokens / decode_time
        print(f"q={n}: {decode_time:.2f}s ({tput:.0f} tok/s), acc={res.accuracy:.2f}")
        if rank == 0:
            save_yaml_dataclass(res, path)
        results.append(res)
    return results


def _rank(rank: int, world: int, args) -> list:
    with common.rank_output(rank):
        return run(args, None, mesh=common.rank_mesh(args, args.tp), rank=rank)


def main(argv=None) -> list:
    args = parse_args(argv)
    device = common.device_of(args, "needles")
    if args.tp > 1:
        return common.over_ranks(_rank, args.tp, device, args,
                                 points=len(split_range(args.num_questions)))[0]
    return run(args, device)


if __name__ == "__main__":
    main()
