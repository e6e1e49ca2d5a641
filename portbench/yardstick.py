"""The benchmark's frozen yardstick: the card's peaks, the roofline bound, the
operations and bytes of each kernel family counted from shapes, the grouping
of the port's kernel names, the idle share of a device timeline, and the
percentiles the end-to-end metrics use.

These are copies (``hydragen_torch/utils/timing.py``'s peaks and
``bound_ms``, ``utils/profiling.py``'s ``fold_name`` and grouping), kept
here so that a change to the program cannot move the measure it is judged
by. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# One H100 SXM, NVIDIA's data sheet, dense rates, at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}

# The port's hand-written kernels by their folded device names (csrc/*.cu).
# "other" is every kernel that is none of these.
KERNEL_GROUPS = {
    "w8a8_kernel": "K1",
    "w4a8_kernel": "K6",
    "flash_kernel": "K2/K4",
    "flash_decode_kernel": "K5",
    "decode_kernel": "K3",
    "write_int4_kernel": "K7",
    "split_combine": "split_combine",
}
ATTENTION_KERNELS = ("flash_kernel", "flash_decode_kernel", "decode_kernel", "split_combine")


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least seconds the card could take: the larger of ``nbytes`` over
    its memory rate and ``ops`` over its peak for operand type ``kind``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind])


# -- operations and bytes, counted once each from the shapes ------------------


def gemm_w8a8(M: int, N: int, K: int) -> Tuple[float, float]:
    """(operations, bytes) of one w8a8 product ``[M, K] x [K, N]``: s8
    activations and row scales read, s8 weight and f32 column scales read,
    bf16 out written."""
    return 2.0 * M * N * K, M * K + 4 * M + N * K + 4 * N + 2 * M * N


def attention(queries: int, keys: float, heads: int, kv_heads: int, head_dim: int,
              kv_bytes_per_elem: float, kv_scale_bytes: float = 0.0,
              pairs: Optional[float] = None) -> Tuple[float, float]:
    """(operations, bytes) of one attention read: ``queries`` query rows of
    ``heads`` heads against ``keys`` key rows of ``kv_heads`` heads.
    ``pairs`` is the count of (query, key) pairs computed (default all of
    them; a causal read passes its triangle). Bytes: q read and out written
    in bf16, the f32 LSE written, each key and value element read once at
    ``kv_bytes_per_elem`` with ``kv_scale_bytes`` a (token, head)."""
    if pairs is None:
        pairs = queries * keys
    ops = 4.0 * pairs * heads * head_dim
    nbytes = (2 * 2 * queries * heads * head_dim + 4 * queries * heads
              + 2 * keys * kv_heads * (head_dim * kv_bytes_per_elem + kv_scale_bytes))
    return ops, nbytes


def causal_pairs(t: int) -> float:
    return t * (t + 1) / 2.0


class Model:
    """The widths a cell's model runs at, from its configuration file."""

    def __init__(self, cfg: dict):
        self.H = int(cfg["hidden_size"])
        self.I = int(cfg["intermediate_size"])
        self.L = int(cfg["num_hidden_layers"])
        self.nh = int(cfg["num_attention_heads"])
        self.nkv = int(cfg["num_key_value_heads"])
        self.V = int(cfg["vocab_size"])
        self.hd = self.H // self.nh

    def projections(self) -> List[Tuple[int, int]]:
        """(N, K) of the seven projections of a layer, in the port's order."""
        H, I, q, kv = self.H, self.I, self.nh * self.hd, self.nkv * self.hd
        return [(q, H), (kv, H), (kv, H), (H, q), (I, H), (I, H), (H, I)]

    def lm_head(self, rows: int) -> Tuple[float, float]:
        """(operations, bytes) of the LM head over ``rows`` rows: the port's
        weight-only product (int8 weight read, bf16 arithmetic, f32 logits)."""
        return 2.0 * rows * self.H * self.V, self.H * self.V + 4 * self.V + 2 * rows * self.H \
            + 4 * rows * self.V

    def attn(self, queries: int, keys: float, pairs: Optional[float] = None,
             int8: bool = True) -> Tuple[float, float]:
        """One layer's attention read (:func:`attention`) at this model's
        heads; ``int8`` keys and values carry an f32 scale a (token, head)."""
        return attention(queries, keys, self.nh, self.nkv, self.hd,
                         1 if int8 else 2, 4 if int8 else 0, pairs)


class Work:
    """Operations by operand type and roofline-bound seconds, summed."""

    def __init__(self):
        self.ops = {"int8": 0.0, "bf16": 0.0}
        self.bound = 0.0

    def add(self, ops: float, nbytes: float, kind: str, times: float = 1.0) -> "Work":
        self.ops[kind] += ops * times
        self.bound += bound_s(nbytes, ops, kind) * times
        return self

    def at_peak_s(self) -> float:
        """Seconds the operations take at the card's peaks (each type at its own)."""
        return sum(o / PEAK_OPS[k] for k, o in self.ops.items())


# -- the work of a cell's calls, by phase ---------------------------------------


def generate_work(m: Model, shared: int, rows: int, suffix: int, new: int) -> Dict[str, dict]:
    """The work of one ``generate`` call of the generate driver, by phase
    (``shared``: the prompt's prefill into its level; ``unique``: the
    suffixes' prefill against the level; ``decode``: the ``new - 1`` decode
    steps): ``{"gemm": Work, "attn": Work, "head": Work, "k1": launches}``.
    Attention is counted from lengths, whichever kernel reads it: a prefill
    reads its own tokens in bf16, the level and the unique cache are int8
    with a scale a (token, head)."""
    L = m.L

    def phase(M, head_rows, attn_parts, forwards=1):
        gemm = Work()
        for N, K in m.projections():
            go, gb = gemm_w8a8(M, N, K)
            gemm.add(go, gb, "int8", L * forwards)
        attn = Work()
        for (ops, nbytes), times in attn_parts:
            attn.add(ops, nbytes, "bf16", L * times)
        head = Work().add(*m.lm_head(head_rows), "bf16", forwards)
        return {"gemm": gemm, "attn": attn, "head": head, "k1": 7 * L * forwards}

    out = {
        "shared": phase(shared, 1, [(m.attn(shared, shared, causal_pairs(shared), int8=False), 1)]),
        "unique": phase(rows * suffix, rows, [
            (m.attn(rows * suffix, shared), 1),
            (m.attn(suffix, suffix, causal_pairs(suffix), int8=False), rows)]),
    }
    steps = new - 1
    dec = phase(rows, rows, [(m.attn(rows, shared), steps)], forwards=steps)
    for i in range(steps):  # row history: the suffix, the tokens before, its own
        u = suffix + i + 1
        dec["attn"].add(*m.attn(rows, rows * u, rows * u), "bf16", L)
    out["decode"] = dec
    return out


def decode_token_work(m: Model, context: int) -> Work:
    """The model's work for one row's decode step at ``context`` tokens of
    history (its own included): its share of the seven products, the
    attention over its context, its LM head row."""
    w = Work()
    for N, K in m.projections():
        w.ops["int8"] += gemm_w8a8(1, N, K)[0] * m.L
    o, _ = m.attn(1, context)
    w.ops["bf16"] += o * m.L + m.lm_head(1)[0]
    return w


# -- device names ----------------------------------------------------------------


def fold_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameter list:
    ``void (anonymous namespace)::flash_kernel<128, true>(Params)`` ->
    ``flash_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    if name.startswith("std::enable_if<") and ">::type " in name:  # a SFINAE return type
        name = name.split(">::type ", 1)[1]
    cuts = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cuts)] if cuts else name).strip()


def group_of(name: str) -> str:
    """The port kernel a device name belongs to (its folded name, one of
    ``KERNEL_GROUPS``), else ``"other"``."""
    folded = fold_name(name)
    return folded if folded in KERNEL_GROUPS else "other"


# -- timelines ----------------------------------------------------------------------

Interval = Tuple[float, float]  # (start s, end s)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged where they overlap or touch, in order."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(intervals: Iterable[Interval], lo: float = -math.inf, hi: float = math.inf) -> float:
    """Seconds inside ``[lo, hi]`` in which some interval runs."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def idle_gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of ``[lo, hi]`` in which no interval runs."""
    gaps, t = [], lo
    for a, b in union(intervals):
        if b <= lo or a >= hi:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_share(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Share of ``[lo, hi]`` with no interval running."""
    return 1.0 - busy_s(intervals, lo, hi) / (hi - lo)


# -- statistics ---------------------------------------------------------------------


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between the
    order statistics around rank ``q/100 * (n - 1)``."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    r = q / 100.0 * (len(v) - 1)
    i = int(math.floor(r))
    j = min(i + 1, len(v) - 1)
    return v[i] + (v[j] - v[i]) * (r - i)


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries of ``items`` as ``[[name, value], ...]``."""
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]
