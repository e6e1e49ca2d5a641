"""The ``serve`` driver: an open loop of requests through one
``ContinuousBatcher`` over a shared system prompt.

Traffic parameters: ``shared_tokens`` (the system prompt, appended in
set-up), ``pool_rows`` and ``ring_slots`` (the unique cache), ``chunk``,
``bucket``, ``admit_policy``, ``lookahead`` (the batcher's), ``suffix_tokens``
and ``new_tokens`` (each request's own prompt and its budget, no EOS: an
inclusive range ``[lo, hi]``, or a lognormal ``{"median", "sigma", "min",
"max"}`` clipped to ``[min, max]``),
``rate_per_s`` (the offered load), ``drain_s`` (how long past the window a
request may take to come back), ``sample_requests`` (requests compared with
the reference, the longest among them), ``trace_from`` and ``trace_s`` (the
slice of the window a traced run profiles, from that share of the window).

The load is fixed by the seed's order, not its amount: a window of ``T``
seconds offers ``round(rate * T)`` requests whose gaps are the quantiles of
an exponential distribution at the rate (a Poisson stream's gaps) and whose
suffix lengths and budgets are spread evenly over their ranges or are the
quantiles of their lognormals, each list in an order drawn from the seed. Every seed thus offers the same work.

The host submits a request when it is due, between the batcher's steps; a
token is seen when a step's readback returns it. End to end: ``ttft_p95_s``
(first token seen minus the request's due time, 95th percentile over all
requests offered; a request that never comes back counts with the run's
end) and ``tpot_p95_ms`` (last token seen minus first, over the tokens
after the first, 95th percentile over the requests with two tokens or more).
"""

from __future__ import annotations

import contextlib
import math
import time
from statistics import NormalDist
from typing import List, Optional

import numpy as np

from portbench import port, yardstick
from portbench.cell import make_weights, rng, token_ids
from portbench.check import Sample


class Request:
    __slots__ = ("due", "ids", "budget", "submitted", "first", "last", "n", "rec")

    def __init__(self, due: float, ids: np.ndarray, budget: int):
        self.due, self.ids, self.budget = due, ids, budget
        self.submitted: Optional[float] = None
        self.first: Optional[float] = None
        self.last: Optional[float] = None
        self.n = 0
        self.rec = None  # the batcher's own record of the request


def spread_evenly(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over ``[lo, hi]``."""
    return lo + (np.arange(n) * (hi - lo + 1)) // max(n, 1)


def lengths(spec, n: int) -> np.ndarray:
    """``n`` lengths of a mix's ``suffix_tokens`` or ``new_tokens``: spread
    evenly over ``[lo, hi]``, or the ``n`` quantiles of a lognormal clipped
    to ``[min, max]``."""
    if not isinstance(spec, dict):
        return spread_evenly(*spec, n)
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.rint(float(spec["median"]) * np.exp(float(spec["sigma"]) * z))
    return np.clip(x, int(spec["min"]), int(spec["max"])).astype(np.int64)


def length_range(spec) -> tuple:
    """The shortest and the longest length a spec can give."""
    return (int(spec["min"]), int(spec["max"])) if isinstance(spec, dict) else tuple(spec)


def requests(traffic: dict, seed: int, seconds: float, vocab: int, rate: float = None) -> list:
    """The window's requests, due times ascending (see the module docstring)."""
    rate = float(traffic["rate_per_s"] if rate is None else rate)
    n = max(1, round(rate * seconds))
    r = rng(seed, "arrivals", rate)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.concatenate([[0.0], np.cumsum(r.permutation(gaps))[:-1]])
    lens = r.permutation(lengths(traffic["suffix_tokens"], n))
    budgets = r.permutation(lengths(traffic["new_tokens"], n))
    return [Request(float(d), token_ids(r, (int(s),), vocab), int(b))
            for d, s, b in zip(due, lens, budgets)]


class Driver:
    def __init__(self, cell, seed: int, device, tracer=None):
        self.cell, self.seed, self.device, self.tracer = cell, seed, device, tracer
        self.t = cell.traffic
        self.V = int(cell.config["vocab_size"])
        self.P = int(self.t["shared_tokens"])
        self.prompt = token_ids(rng(seed, "system prompt"), (self.P,), self.V)
        self.reqs: List[Request] = []
        self.records: dict = {}
        self.end = 0.0
        self.eng = self.cb = None

    def setup(self) -> None:
        """Weights, engine, pool and the system prompt's level; the batcher,
        warmed by a few requests that admit at every bucket width and capture
        its decode step's graph."""
        from hydragen_torch import ContinuousBatcher

        cfg, t = self.cell.config, self.t
        self.eng = port.engine(cfg, make_weights(cfg, self.seed, self.device), self.device)
        self.eng.setup_caches(int(t["pool_rows"]), int(t["ring_slots"]), [1], [self.P],
                              kv_quant=cfg["serving"]["kv_cache"])
        self.eng.append_shared(self.prompt[None])
        self.cb = ContinuousBatcher(self.eng, chunk=int(t["chunk"]), bucket=int(t["bucket"]),
                                    temperature=0.0, admit_policy=t["admit_policy"],
                                    lookahead=int(t["lookahead"]))
        # One request at each prompt width the admissions pad to (bucket
        # multiples over the suffix range), each decoding one chunk.
        r = rng(self.seed, "warm-up")
        lo, hi = length_range(t["suffix_tokens"])
        bucket = int(t["bucket"])
        for tb in range(-(-lo // bucket) * bucket, hi + bucket, bucket):
            s = max(lo, min(tb, hi))
            self.cb.submit(token_ids(r, (s,), self.V), max_new_tokens=int(t["chunk"]) + 1)
        # Each needs one chunk after its admission and the readback's lag; a
        # broken program's may never finish, and then the window's fail.
        for _ in range(3 + int(t["lookahead"])):
            if not self.cb.step():
                break

    def run(self, seconds: float, rate: float = None) -> None:
        """The open loop: each request submitted once due, between steps; then
        the drain, with no new arrivals, for at most ``drain_s``."""
        self.reqs = reqs = requests(self.t, self.seed, seconds, self.V, rate)
        cb, tr = self.cb, self.tracer
        tr_lo, tr_s = float(self.t["trace_from"]) * seconds, float(self.t["trace_s"])
        tr_hi = None
        stack = contextlib.ExitStack()
        open_: List[Request] = []
        i, live = 0, False
        self._t0 = t0 = time.perf_counter()
        limit = seconds + float(self.t["drain_s"])
        with stack:
            while True:
                now = time.perf_counter() - t0
                if tr is not None and not tr.active and now >= tr_lo and "slice" not in self.records:
                    self._trace_start(stack)
                    tr_hi = time.perf_counter() - t0 + tr_s
                elif tr is not None and tr.active and now >= tr_hi:
                    self._trace_stop(stack)
                fresh = False
                while i < len(reqs) and reqs[i].due <= now:
                    q = reqs[i]
                    cb.submit(q.ids, max_new_tokens=q.budget)
                    q.rec = cb._queue[-1]
                    q.submitted = time.perf_counter() - t0
                    open_.append(q)
                    i, fresh = i + 1, True
                if live or fresh:
                    live = cb.step()
                    seen = time.perf_counter() - t0
                    for q in open_:
                        n = len(q.rec.tokens)
                        if n > q.n:
                            q.first = seen if q.first is None else q.first
                            q.last, q.n = seen, n
                    open_ = [q for q in open_ if not q.rec.done]
                elif i < len(reqs):
                    time.sleep(max(0.0, min(reqs[i].due - now, 0.01)))
                else:
                    break
                if now > limit:
                    break
            if tr is not None and tr.active:
                self._trace_stop(stack)
        self.end = time.perf_counter() - t0

    def _trace_start(self, stack) -> None:
        tr = self.tracer
        self.records["slice_s"] = [time.perf_counter() - self._t0]
        stack.enter_context(tr.window())
        stack.enter_context(tr.wrapped(self.eng, {"_decode_steps": "decode"}, fence=False))
        self.records["slice"] = {"launches": port.launches(), "stats": dict(self.cb.stats),
                                 "tokens": {id(q): q.n for q in self.reqs}}

    def _trace_stop(self, stack) -> None:
        before = self.records["slice"]
        stack.close()
        self.records["slice_s"].append(time.perf_counter() - self._t0)
        after = port.launches()
        before["launches"] = {k: after[k] - before["launches"][k] for k in after}
        before["stats"] = {k: v - before["stats"][k] for k, v in self.cb.stats.items()}
        # Tokens seen in the slice: (request, tokens seen before, after).
        before["tokens"] = [(q, before["tokens"].get(id(q), 0), q.n) for q in self.reqs
                            if q.n > before["tokens"].get(id(q), 0)]

    def _ok(self, q: Request) -> bool:
        toks = q.rec.tokens if q.rec is not None else []
        return (q.rec is not None and q.rec.done and len(toks) == q.budget
                and min(toks) >= 0 and max(toks) < self.V)

    def end_to_end(self) -> dict:
        ttft = [(q.first if q.first is not None and self._ok(q) else self.end) - q.due
                for q in self.reqs]
        tpot = [(q.last - q.first) / (q.n - 1) for q in self.reqs
                if self._ok(q) and q.n >= 2]
        return {"ttft_p95_s": yardstick.percentile(ttft, 95),
                "tpot_p95_ms": 1e3 * yardstick.percentile(tpot, 95) if tpot else math.inf}

    def attempted_failed(self) -> tuple:
        return len(self.reqs), sum(not self._ok(q) for q in self.reqs)

    def submit_lags(self) -> list:
        """Each submitted request's lag, but those due while the profiler
        traced a slice of the window (its start and stop stall the loop)."""
        lo, hi = self.records.get("slice_s", (0.0, 0.0))
        return [q.submitted - q.due for q in self.reqs
                if q.submitted is not None and not lo <= q.due <= hi]

    def sample(self) -> Sample:
        """``sample_requests`` of the finished requests, drawn from the seed,
        the longest (prompt and budget) among them."""
        done = [q for q in self.reqs if self._ok(q)]
        k = min(int(self.t["sample_requests"]), len(done))
        longest = max(range(len(done)), key=lambda j: len(done[j].ids) + done[j].budget)
        rest = [j for j in range(len(done)) if j != longest]
        r = rng(self.seed, "sample")
        pick = [longest] + sorted(r.choice(rest, size=k - 1, replace=False).tolist())
        served = [np.asarray(done[j].rec.tokens, dtype=np.int64) for j in pick]
        return Sample(self.prompt, [np.concatenate([done[j].ids, s[:-1]])
                                    for j, s in zip(pick, served)], served)

    def close(self) -> None:
        self.eng = self.cb = None
        port.free()
