"""The ``generate`` driver: back-to-back ``HydragenLlama.generate`` calls,
each over a new shared prompt and its own rows of suffixes, greedy, the
shared level wiped by each call (``SharedCacheOp.WIPE``).

Traffic parameters: ``shared_tokens`` (the prompt), ``rows`` and
``suffix_tokens`` (each row's own suffix), ``new_tokens`` (each row's
budget; no EOS), ``sample_rows`` (rows compared with the reference, one
from each of as many equal parts of the batch), ``trace_call`` (the call a
traced run profiles).

End to end: ``gen_tok_s``, every new token of every whole call started in
the window over the time from the first call's start to the last call's end.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench import port, yardstick
from portbench.cell import make_weights, rng, token_ids
from portbench.check import Sample
from portbench.timeline import fence

SPANS = {"append_shared": "shared_prefill", "_prefill_unique": "unique_prefill",
         "_decode_steps": "decode"}


class Driver:
    def __init__(self, cell, seed: int, device, tracer=None):
        t = cell.traffic
        self.cell, self.seed, self.device, self.tracer = cell, seed, device, tracer
        self.P, self.b = int(t["shared_tokens"]), int(t["rows"])
        self.t, self.n = int(t["suffix_tokens"]), int(t["new_tokens"])
        self.V = int(cell.config["vocab_size"])
        self.trace_call = int(t.get("trace_call", 1))
        self.calls, self.tokens = [], []
        self.records: dict = {}
        self.eng = None

    def inputs(self, call: int):
        """The prompt ``[1, P]`` and suffixes ``[rows, t]`` of call ``call``
        (the warm-up is call -1)."""
        r = rng(self.seed, "call", call)
        return token_ids(r, (1, self.P), self.V), token_ids(r, (self.b, self.t), self.V)

    def _call(self, call: int, new: int) -> np.ndarray:
        from hydragen_torch import SharedCacheOp

        prompt, suffixes = self.inputs(call)
        toks = self.eng.generate(input_ids=[prompt, suffixes], max_new_tokens=new,
                                 temperature=0.0, shared_cache_op=SharedCacheOp.WIPE)
        return toks.cpu().numpy()

    def setup(self) -> None:
        """Weights, engine and caches; one call at the window's shapes with
        a short budget, which captures the decode step's graph."""
        cfg = self.cell.config
        self.eng = port.engine(cfg, make_weights(cfg, self.seed, self.device), self.device)
        self.eng.setup_caches(self.b, self.t + self.n, [1], [self.P],
                              kv_quant=cfg["serving"]["kv_cache"])
        self._call(-1, min(self.n, 4))

    def run(self, seconds: float) -> None:
        """Calls back to back while the window lasts (a traced run reaches
        its traced call whatever the length)."""
        tr = self.tracer
        t0 = time.perf_counter()
        c = 0
        while time.perf_counter() - t0 < seconds or (tr is not None and c <= self.trace_call):
            traced = tr is not None and c == self.trace_call
            with contextlib.ExitStack() as stack:
                if traced:
                    stack.enter_context(tr.window())
                    stack.enter_context(tr.wrapped(self.eng, SPANS))
                    before = port.launches()
                start = time.perf_counter()
                with tr.span("call") if traced else contextlib.nullcontext():
                    toks = self._call(c, self.n)
                end = time.perf_counter()
                if traced:
                    after = port.launches()
                    self.records["launches"] = {k: after[k] - before[k] for k in after}
            self.calls.append((start, end))
            self.tokens.append(toks)
            c += 1
        if tr is not None:  # the prefill's share of the traced call, on the host's clock
            walls = []
            for new in (1, self.n):
                fence(self.device)
                t = time.perf_counter()
                self._call(self.trace_call, new)
                walls.append(time.perf_counter() - t)
            self.records["prefill_share"] = walls[0] / walls[1]

    def end_to_end(self) -> dict:
        span = self.calls[-1][1] - self.calls[0][0]
        return {"gen_tok_s": sum(t.size for t in self.tokens) / span}

    def attempted_failed(self) -> tuple:
        """Completions (rows) attempted and failed: a row fails if it comes
        back with other than its budget of tokens or with a token out of
        range."""
        failed = 0
        for toks in self.tokens:
            if toks.shape != (self.b, self.n):
                failed += self.b
            else:
                failed += int(((toks < 0) | (toks >= self.V)).any(axis=1).sum())
        return self.b * len(self.tokens), failed

    def sample(self) -> Sample:
        """One call of the window drawn from the seed, and one row of each of
        ``sample_rows`` equal parts of its batch, drawn from the seed."""
        r = rng(self.seed, "sample")
        call = int(r.integers(len(self.calls)))
        k = int(self.cell.traffic["sample_rows"])
        rows = [i * self.b // k + int(r.integers(self.b // k)) for i in range(k)]
        prompt, suffixes = self.inputs(call)
        toks = self.tokens[call]
        return Sample(prompt[0], [np.concatenate([suffixes[i], toks[i, :-1]]) for i in rows],
                      [toks[i] for i in rows])

    def work(self) -> dict:
        """The work of one call by phase (``yardstick.generate_work``)."""
        return yardstick.generate_work(yardstick.Model(self.cell.config), self.P, self.b,
                                       self.t, self.n)

    def close(self) -> None:
        self.eng = None
        port.free()
