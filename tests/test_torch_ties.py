"""The tie rule of the port's quantized parity tests, the spies that apply it,
and tests of the rule itself.

Both engines quantize an activation row, or one token's K or V of a head,
against a scale from its amax: ``code = round(x / scale)``. Their ``x`` and
``scale`` differ in the last bits of XLA's and PyTorch's float sums
upstream (norm means, rsqrt, rope tables, the order of a dot's terms), so
where ``x / scale`` lies that close to a half code the two engines take
neighbouring codes, with no fault on either side. From there on they
compute on different codes, and a logit can move by a few 1e-2.

A code that differs between the engines is a **tie** when:

- the two codes are neighbours, and the half code between them lies
  between the engines' quotients ``x / scale`` (or on one of them);
- the gap between the two quotients is no wider than the float noise of
  the same call's agreeing elements: the largest gap among the elements
  whose codes agree;
- that noise is at most ``NOISE_CAP_ULPS``.

Gaps are counted in ulps of the row's full scale (the spacing of f32 at the
row's largest ``|x / scale|``, about 127 or 7): the engines' sums err by a
few ulps of the magnitudes they add, whatever the element's own size. The
tests print the noise they find beside the cap.

Two spies read the quantizers of both engines (``quantize_rows``,
``quantize_kv``, ``quantize_kv4``). The JAX side records every call through
host callbacks (unordered: under a mesh JAX allows no ordered effect). The
port side looks up each row of each of its calls among the JAX rows by its
content (the closest ``x`` row of the same kind and length: rows of other
calls are far away), so the match needs no call order and works inside the
gloo ranks of a mesh. ``Resolver`` checks each port call against the rule,
and its scales against JAX's (at most ``NOISE_CAP_ULPS`` ulps apart), and
then hands the port JAX's codes and scales for the matched rows: a tie no
longer splits the runs, and neither does a bf16 rounding of a GEMM's output
downstream (K1's and K6's bf16 partials round the same f32 products). A
parity test then holds every forward pass in full, ties or not, and fails
on any differing code that is not a tie. A row with no counterpart (none
within 1e-4 of its amax) keeps its own codes and is counted; the tests
print the count, and a real divergence shows in the outputs they hold.
"""

from __future__ import annotations

import contextlib
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

# The cap on the float noise between the engines' quotients, in ulps of the
# row's full scale. The noise seen at fp32 in these tests is a few ulps (the
# tests print it); a fault that moves every quotient (a wrong scale, a
# missing term) shows as noise far above the cap and as codes far apart.
NOISE_CAP_ULPS = 64

def quotients(x, scale) -> np.ndarray:
    """``x / scale`` as rows ``[r, n]`` (one scale a row), in f32."""
    x = np.asarray(x, np.float32)
    x2 = x.reshape(-1, x.shape[-1])
    return x2 / np.asarray(scale, np.float32).reshape(-1, 1)


def tie_check(vt, vj, qt, qj) -> dict:
    """Hold one quantization's codes (``qt`` the port's, ``qj`` JAX's, rows
    ``[r, n]`` beside the quotients ``vt``, ``vj``) to the tie rule. Returns
    ``ok``, the differing count, the call's noise and the widest gap of a
    differing code, in full-scale ulps."""
    qt = np.asarray(qt).reshape(vt.shape).astype(np.int32)
    qj = np.asarray(qj).reshape(vt.shape).astype(np.int32)
    diff = qt != qj
    full = np.maximum(np.abs(vt).max(-1, keepdims=True), np.abs(vj).max(-1, keepdims=True))
    unit = np.spacing(np.maximum(full, np.float32(1e-30)))
    gap = np.abs(vt.astype(np.float64) - vj.astype(np.float64)) / unit
    noise = float(gap[~diff].max()) if (~diff).any() else 0.0
    out = dict(ok=True, n_diff=int(diff.sum()), noise_ulps=noise, gap_ulps=0.0)
    if not diff.any():
        out["ok"] = noise <= NOISE_CAP_ULPS
        return out
    half = (qt + qj)[diff] / 2.0
    lo = np.minimum(vt, vj)[diff].astype(np.float64)
    hi = np.maximum(vt, vj)[diff].astype(np.float64)
    out["gap_ulps"] = float(gap[diff].max())
    out["ok"] = bool((np.abs(qt - qj)[diff] == 1).all() and ((lo <= half) & (half <= hi)).all()
                     and out["gap_ulps"] <= noise <= NOISE_CAP_ULPS)
    return out


# ---------------------------------------------------------------------------
# The JAX side: records
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched(pairs):
    """Set ``(module, name, value)`` attributes for the block, then restore
    them."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    try:
        for m, n, v in pairs:
            setattr(m, n, v)
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


@contextlib.contextmanager
def env(**kw):
    """Environment variables for the block (a module fixture's
    ``monkeypatch.setenv``)."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def jax_recorded(records: list):
    """Record every quantization the JAX package makes in the block into
    ``records`` as ``(kind, x f32, codes, scales)`` (host callbacks, in no
    particular order; under ``shard_map`` one record a shard). The jit caches
    are cleared on entry and exit, so programs are traced with the spy and
    none keeps it."""
    import jax
    import jax.numpy as jnp

    from hydragen_tpu.core import cache as jcache
    from hydragen_tpu.ops import gemm as jgemm
    from hydragen_tpu.ops import quant as jquant

    def spy(kind, fn):
        def wrapped(x):
            q, sc = fn(x)
            jax.debug.callback(
                lambda x, q, sc: records.append(
                    (kind, np.asarray(x), np.asarray(q), np.asarray(sc))),
                x.astype(jnp.float32), q, sc)
            return q, sc
        return wrapped

    pairs = [(jgemm, "quantize_rows", spy("rows", jgemm.quantize_rows))]
    for mod in (jquant, jcache):
        pairs += [(mod, "quantize_kv", spy("kv", mod.quantize_kv)),
                  (mod, "quantize_kv4", spy("kv4", mod.quantize_kv4))]
    jax.clear_caches()
    try:
        with patched(pairs):
            yield records
            jax.effects_barrier()
    finally:
        jax.clear_caches()


# ---------------------------------------------------------------------------
# The port side: matching and resolving
# ---------------------------------------------------------------------------


class Resolver:
    """The port's quantizations held to JAX's ``records`` by the tie rule.

    ``port(kind, x, q, scale)`` finds each row's JAX counterpart by content,
    checks the call's matched rows (``tie_check``) and returns the codes the
    port goes on with: JAX's where the call is a tie, its own otherwise.
    ``faults`` lists the calls that broke the rule, ``ties`` the tied calls,
    ``unmatched`` counts the rows with no counterpart (padded positions,
    which the engines fill differently and nothing reads: a real divergence
    shows in the outputs the tests hold), ``noise`` is the largest noise of
    any call, in full-scale ulps. ``substitute=False`` leaves the port's
    codes alone (``first_diff`` is then the first tie's call)."""

    def __init__(self, records, substitute: bool = True):
        self.substitute = substitute
        self.calls = self.rows = self.unmatched = 0
        self.ties, self.faults = [], []
        self.noise = self.scale_noise = 0.0
        self.first_diff = None  # (call, check) of the first call whose codes differ
        buckets = defaultdict(list)
        for kind, x, q, sc in records:
            n = x.shape[-1]
            buckets[(kind, n)].append((x.reshape(-1, n), q.reshape(-1, n), sc.reshape(-1)))
        self.index = {}
        rng = np.random.RandomState(0)
        for key, parts in buckets.items():
            X = np.concatenate([p[0] for p in parts]).astype(np.float32)
            w = rng.randn(key[1])
            keys = X.astype(np.float64) @ w
            order = np.argsort(keys)
            self.index[key] = (X[order], np.concatenate([p[1] for p in parts])[order],
                               np.concatenate([p[2] for p in parts])[order], keys[order], w)

    def _match(self, kind, x2):
        """The JAX row closest to each of the port's rows ``x2 [r, n]``: its
        index into the bucket's arrays, or -1 where no JAX row is within
        1e-4 of the row's amax (a padded position, which the engines fill
        differently and nothing reads)."""
        entry = self.index.get((kind, x2.shape[1]))
        rows = np.full(len(x2), -1, np.int64)
        if entry is None:
            return rows, entry
        X, _, _, keys, w = entry
        kp = x2.astype(np.float64) @ w
        tol = 1e-4 * (np.abs(x2).astype(np.float64) @ np.abs(w)) + 1e-30
        lo = np.searchsorted(keys, kp - tol, "left")
        hi = np.searchsorted(keys, kp + tol, "right")
        for r in range(len(x2)):
            cand = np.arange(lo[r], min(hi[r], lo[r] + 64))
            err = np.abs(X[cand] - x2[r]).max(-1) if len(cand) else np.array([np.inf])
            best = int(np.argmin(err))
            amax = max(float(np.abs(x2[r]).max()), 1e-30)
            if err[best] <= 1e-4 * amax:
                rows[r] = cand[best]
        return rows, entry

    def port(self, kind, x, q, sc):
        """One quantization of the port: ``(codes, scales)`` to go on with."""
        xt = np.asarray(x.detach().float().cpu(), np.float32)
        n = xt.shape[-1]
        x2 = xt.reshape(-1, n)
        qt = q.detach().cpu().numpy().reshape(-1, n)
        st = sc.detach().float().cpu().numpy().reshape(-1)
        call = self.calls
        self.calls += 1
        rows, entry = self._match(kind, x2)
        hit = rows >= 0
        self.rows += len(rows)
        self.unmatched += int((~hit).sum())
        if not hit.any():
            return q, sc
        X, Q, S = (a[rows[hit]] for a in entry[:3])
        check = tie_check(quotients(x2[hit], st[hit]), quotients(X, S), qt[hit], Q)
        scale_ulps = float((np.abs(st[hit].astype(np.float64) - S)
                            / np.spacing(np.maximum(np.abs(S), np.float32(1e-30)))).max())
        check["scale_ulps"] = scale_ulps
        check["ok"] = check["ok"] and scale_ulps <= NOISE_CAP_ULPS
        self.noise = max(self.noise, check["noise_ulps"])
        self.scale_noise = max(self.scale_noise, scale_ulps)
        if check["n_diff"] and self.first_diff is None:
            self.first_diff = (call, check)
        if not check["ok"]:
            self.faults.append((call, kind, tuple(x.shape), check))
            return q, sc
        if check["n_diff"]:
            self.ties.append((call, kind, check))
        if not self.substitute:
            return q, sc
        qo, so = qt.copy(), st.copy()
        qo[hit], so[hit] = Q, S
        return (torch.from_numpy(qo.reshape(q.shape)).to(q.device),
                torch.from_numpy(so.reshape(sc.shape)).to(sc.device, sc.dtype))

    def report(self) -> dict:
        return dict(calls=self.calls, rows=self.rows, unmatched=self.unmatched,
                    ties=self.ties, faults=self.faults,
                    noise_ulps=self.noise, scale_ulps=self.scale_noise,
                    first_diff=self.first_diff)


@contextlib.contextmanager
def port_resolved(resolver: Resolver):
    """Route every quantization of the port through ``resolver`` for the
    block (the quantizers' module names where the port imports them)."""
    from hydragen_torch.core import cache as tcache
    from hydragen_torch.models import llama as tllama
    from hydragen_torch.ops import decode as tdecode
    from hydragen_torch.ops import gemm as tgemm
    from hydragen_torch.ops import rope as trope

    def spy(kind, fn):
        def wrapped(x):
            return resolver.port(kind, x, *fn(x))
        return wrapped

    # Every activation quantization of the port on the CPU runs the plain
    # version (``gemm.quantize_rows`` and K8's entries call it there).
    pairs = [(tgemm, "quantize_rows_plain", spy("rows", tgemm.quantize_rows_plain))]
    for mod in (tcache, tdecode, tllama, trope):
        for name, kind in (("quantize_kv", "kv"), ("quantize_kv4", "kv4")):
            if hasattr(mod, name):
                pairs.append((mod, name, spy(kind, getattr(mod, name))))
    with patched(pairs):
        yield resolver


def assert_resolved(report: dict, label="") -> None:
    """No call broke the rule; print what was found."""
    print(f"[ties] {label}: {report['calls']} port quantizations ({report['rows']} rows, "
          f"{report['unmatched']} with no JAX counterpart), {len(report['ties'])} "
          f"tied (gaps {[round(t[2]['gap_ulps'], 3) for t in report['ties']]}), noise "
          f"{report['noise_ulps']:.3f} full-scale ulps and scales {report['scale_ulps']:.1f} "
          f"ulps apart, of the cap {NOISE_CAP_ULPS}")
    assert report["calls"] > 0 and report["unmatched"] < report["rows"], label
    assert not report["faults"], (label, report["faults"][:3])


# ---------------------------------------------------------------------------
# Tests of the rule
# ---------------------------------------------------------------------------


def _call(seed=0, rows=6, n=64, noise=2e-6):
    """A quantization of ``rows`` rows on both sides: JAX's x and the port's
    x a little apart (``noise`` relative to the row's amax)."""
    rng = np.random.RandomState(seed)
    xj = rng.randn(rows, n).astype(np.float32)
    amax = np.abs(xj).max(-1, keepdims=True)
    xt = (xj + rng.uniform(-1, 1, xj.shape) * noise * amax).astype(np.float32)

    def quant(x):
        sc = np.abs(x).max(-1, keepdims=True) * np.float32(1 / 127)
        return np.round(x / sc).astype(np.int8), sc
    return xt, xj, quant


def test_equal_codes_pass_and_report_the_noise():
    xt, xj, quant = _call()
    (qt, st), (qj, sj) = quant(xt), quant(xj)
    check = tie_check(quotients(xt, st), quotients(xj, sj), qt, qj)
    if check["n_diff"] == 0:
        assert check["ok"] and 0 < check["noise_ulps"] <= NOISE_CAP_ULPS
    else:  # the noise put a quotient on a half code: that too is a tie
        assert check["ok"] and check["gap_ulps"] <= check["noise_ulps"]


def test_a_tie_is_accepted():
    """One element just either side of a half code in the two engines."""
    xt, xj, quant = _call(noise=1e-6)
    (_, st), (_, sj) = quant(xt), quant(xj)
    xj[2, 5] = np.float32(10.5 * (1 - 1e-6)) * sj[2, 0]
    xt[2, 5] = np.float32(10.5 * (1 + 1e-6)) * st[2, 0]
    (qt, st), (qj, sj) = quant(xt), quant(xj)
    check = tie_check(quotients(xt, st), quotients(xj, sj), qt, qj)
    assert check["n_diff"] >= 1 and check["ok"], check


@pytest.mark.parametrize("fault", ["two_codes", "no_straddle", "gap_above_noise",
                                   "noise_above_cap"])
def test_what_is_not_a_tie(fault):
    """A code two apart; a code apart with both quotients on one side of the
    half code; a gap wider than the call's noise; a call whose noise passes
    the cap: each fails the rule."""
    xt, xj, quant = _call(noise=1e-6 if fault != "noise_above_cap" else 1e-3)
    (qt, st), (qj, sj) = quant(xt), quant(xj)
    vt, vj = quotients(xt, st), quotients(xj, sj)
    if fault == "two_codes":
        qt = qt.copy()
        qt[1, 3] += 2 if qt[1, 3] < 120 else -2
    elif fault == "no_straddle":
        qt = qt.copy()
        qt[1, 3] += 1 if qt[1, 3] < 120 else -1
    elif fault == "gap_above_noise":
        v = np.float32(20.4)
        vj[0, 0], vt[0, 0] = v, np.float32(20.6)
        qj, qt = qj.copy(), qt.copy()
        qj[0, 0], qt[0, 0] = 20, 21
    check = tie_check(vt, vj, qt, qj)
    assert not check["ok"], check


def test_resolver_matches_rows_by_content_and_resolves_a_tie():
    """Port calls in another order and split otherwise than JAX's records
    (as a tp rank's calls are): each row finds its counterpart; a tie is
    resolved to JAX's codes; a row with no counterpart is a fault."""
    xt, xj, quant = _call(seed=3, rows=8, noise=1e-6)
    xt[5] = xj[5]  # the same amax and scale in row 5, and one element apart
    (_, sj) = quant(xj)
    xj[5, 7] = np.float32(-3.5 * (1 - 4e-7)) * sj[5, 0]
    xt[5, 7] = np.float32(-3.5 * (1 + 4e-7)) * sj[5, 0]
    (qj, sj) = quant(xj)
    assert quant(xt)[0][5, 7] == -4 and qj[5, 7] == -3
    records = [("rows", xj[:4], qj[:4], sj[:4]), ("rows", xj[4:], qj[4:], sj[4:])]
    res = Resolver(records)
    for part in (slice(4, 8), slice(0, 4)):
        x = torch.from_numpy(xt[part].copy())
        qt, st = quant(xt[part])
        out, sc = res.port("rows", x, torch.from_numpy(qt), torch.from_numpy(st))
        np.testing.assert_array_equal(out.numpy(), qj[part])
        np.testing.assert_array_equal(sc.numpy(), sj[part])
    res.port("rows", torch.ones(2, 64), torch.ones(2, 64, dtype=torch.int8),
             torch.ones(2, 1))
    rep = res.report()
    assert rep["calls"] == 3 and rep["rows"] == 10 and rep["unmatched"] == 2
    assert not rep["faults"] and len(rep["ties"]) == 1 and rep["ties"][0][0] == 0
