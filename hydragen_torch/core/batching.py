"""Continuous batching over a shared-prefix cache, in PyTorch.

Port of ``hydragen_tpu.core.batching``. Requests arrive and finish at
different times while all share the same prefix stack: admission prefills
only each request's suffix, and the prefix KV is never touched.

- **Ring-slot KV pool.** The unique cache's ``U`` positions are a ring
  addressed by one global cursor shared by every row: at global step ``g``
  every row's new KV lands in slot ``g % U``, one uniform write a step. A
  row's valid tokens are the absolute window ``[start_r, g)``; wrapped into
  slot space it is no prefix, so the unique read masks with a per-row
  ``[B, U]`` ``ring_mask`` built once a step.
- **Admission** prefills K requests' right-padded suffixes (one dispatch a
  prompt-width bucket and prefix group) and scatters each one's KV
  right-aligned into slots ``[(g - p) % U, g % U)``, so its window stays
  contiguous with the decode tokens that follow. It runs eagerly.
- **A decode chunk** advances every row by ``steps`` steps; inactive rows
  compute garbage into their own dead slots, and eos/budget masking retires
  rows exactly. On the card each step is one captured CUDA graph (the
  engine's pool, capture stream and launch accounting), replayed ``steps``
  times a chunk: the step reads the batch state from static buffers and
  writes it back in place, as the JAX scan carries it. With
  ``engine.graph(False)``, or on the CPU, the same step body runs eagerly.
- The host loop admits between chunks and parses a chunk's tokens
  ``lookahead`` chunks later, so the device keeps working meanwhile.

Where the JAX batcher makes new arrays (``.at[].set``, ``_replace``), this
one writes the static buffers in place (``index_copy_``, ``index_fill_``):
a graph reads fixed addresses. What outlives the next chunk's replays (a
chunk's tokens, the admitted rows' first tokens) is copied on the device,
enqueued before those replays. JAX's ``mode="drop"`` padding (sentinel rows
and slots) becomes host-side filtering: only real entries are scattered.

Ring safety: a row's window is at most ``prompt + max_new_tokens`` long
(checked at submit) and advances with the global cursor, so the slot
overwritten at step ``g`` (absolute ``g - U``) is in no active row's window.

Under a ``kv_mask`` the unique read is the plain path, as in the JAX
package (``hydragen_tpu/ops/hydragen.py:_attention``): no Pallas kernel
computes it.

**Under a mesh** (an engine with a ``parallel.Mesh``; the JAX batcher runs
on a mesh engine through GSPMD) every rank is one process running the same
batcher over the same submitted requests. The host side stays global and
identical on every rank: the queue, the row table, the admission order,
the tail shrink and the readback parse, so every rank makes the same
decisions. The device side holds the rank's rows ``[i B/dp, (i+1) B/dp)``
of the pool, the rows its unique cache holds (all of them without a dp
split): the batch state, the ring scatter and the deactivations take the
rank's own rows at local indices. An admission dispatch's members may span
dp ranks: each rank prefills its own (a rank with none skips the forward,
and its tp and sp group with it), and the members' last-token logits are
gathered over dp in the dispatch's order and sampled on every rank, as the
meshless batcher samples them. A chunk's tokens (and the fresh rows' first
tokens) are gathered over dp before the parse. Sampling steps gather the
logits over dp and draw for every row (``HydragenLlama._sample_rows``), so
the generator state stays equal on every rank and to the meshless
batcher's. Under NCCL each decode step is a captured graph holding its
collectives; under gloo the steps run eagerly.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from hydragen_torch.core.cache import KVWrite
from hydragen_torch.core.engine import HydragenLlama, sample_from_logits
from hydragen_torch.models.llama import ForwardSpec, logits_from_hidden, model_forward
from hydragen_torch.parallel import mesh as mesh_lib

# Each batcher's graph key is its own: its graph reads its own buffers.
_SERIAL = itertools.count()


class BatchState(NamedTuple):
    cur_token: torch.Tensor  # [B, 1] int32: next input token per row
    pos: torch.Tensor        # [B] int32: RoPE position of cur_token
    start: torch.Tensor      # [B] int32: absolute index of the first valid token
    remaining: torch.Tensor  # [B] int32: tokens left to generate
    active: torch.Tensor     # [B] bool
    cursor: torch.Tensor     # [] int32: global absolute write index


def ring_mask(start: torch.Tensor, cursor: torch.Tensor, U: int) -> torch.Tensor:
    """[B, U] validity of each ring slot for each row.

    Slot ``s`` last held the token of absolute step
    ``a(s) = cursor-1 - ((cursor-1-s) mod U)``; it is valid for row ``r``
    iff ``a(s) >= start_r`` (never-written slots get ``a < 0``)."""
    s = torch.arange(U, dtype=torch.int32, device=start.device)[None, :]
    a = (cursor - 1) - torch.remainder(cursor - 1 - s, U)
    return a >= start[:, None]


class ChunkKey(NamedTuple):
    """What a batcher's decode-step graph bakes in: the JAX
    ``_decode_chunk``'s static arguments but ``steps`` (the chunk length is
    a replay count), and the batcher it belongs to."""

    spec: ForwardSpec
    batch: int
    temperature: float
    top_p: Optional[float]
    eos: int
    batcher: int


class ChunkStep:
    """A batcher's static buffers (the batch state, the chunk's token output
    ``out [B, chunk]`` and its column counter ``i``; ``B`` the rank's rows
    under a mesh) and, on the card, the graph of one decode step over them
    (the engine's graph holder)."""

    def __init__(self, key: ChunkKey, U: int, chunk: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        B = key.batch
        self.key = key
        # The cursor starts at U, so never-written slots (a < 0 in
        # ring_mask) stay invalid without special-casing the first lap.
        self.state = BatchState(
            cur_token=torch.zeros((B, 1), **i32),
            pos=torch.zeros((B,), **i32),
            start=torch.full((B,), U, **i32),
            remaining=torch.zeros((B,), **i32),
            active=torch.zeros((B,), dtype=torch.bool, device=device),
            cursor=torch.full((), U, **i32),
        )
        self.out = torch.zeros((B, chunk), **i32)
        self.i = torch.zeros((), **i32)
        self.logits = None  # the engine's holder interface: no logits kept
        self.reset_graph()

    def reset_graph(self) -> "ChunkStep":
        self.warm = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}
        self.capture_s = 0.0
        return self


@dataclass
class _Request:
    rid: int
    ids: np.ndarray
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    group: int = 0  # finest-level prefix index (sb > 1 pools)
    # Per-request stop token-id sequences, matched on the host against the
    # generated tail at each readback.
    stops: tuple = ()


def _hit_stop(tokens: List[int], stops: tuple) -> bool:
    return any(
        len(s) > 0 and len(tokens) >= len(s) and tokens[-len(s):] == list(s)
        for s in stops
    )


class ContinuousBatcher:
    """Iteration-level scheduler over a ``HydragenLlama``'s unique-row pool.

    Usage::

        engine.setup_caches(max_unique_batch_size=B, ...)
        engine.append_shared(prefix_ids)       # the shared context
        cb = ContinuousBatcher(engine, chunk=8, bucket=32)
        ids = [cb.submit(prompt, max_new_tokens=64) for prompt in prompts]
        results = cb.run()                     # {rid: [token, ...]}

    The batch state lives on the engine's device. ``stats`` counts the
    dispatches: admission prefills, chunks and decode steps. A batcher's
    decode-step graph lives in the engine's graph table as long as the
    engine's cache and parameters do. Sampling draws from the engine's
    generator, seeded here.

    Under a mesh every rank constructs the batcher, submits the same
    requests and calls ``run``; each gets every request's tokens and equal
    ``stats``. ``admit_forwards`` counts the admission dispatches this rank
    prefilled (those with a member in its dp rows)."""

    def __init__(
        self,
        engine: HydragenLlama,
        chunk: int = 8,
        bucket: int = 32,
        temperature: float = 0.0,
        top_p: Optional[float] = None,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        admit_policy: str = "fifo",
        lookahead: int = 1,
    ):
        assert admit_policy in ("fifo", "lpt")
        assert lookahead >= 1
        assert engine.cache is not None, "call setup_caches first"
        assert engine.cache.unique_bits == 8, (
            "ContinuousBatcher needs kv_quant in (None, 'int8'): the ring "
            "pool's wrapped windows and per-row admissions would need "
            "sub-byte scatters under the int4 token-planar pack"
        )
        # The pool's global rows; dp rank i holds [i * nrows, (i + 1) * nrows).
        dp, self._dpi = engine._dp()
        B_pool = engine.cache.max_unique_batch_size * dp
        self._dp = dp
        self._row0, self._nrows = engine._dp_rows(B_pool)
        # sb > 1 levels: the pool's rows are grouped by position (row r
        # attends level i's prefix r // (B // sb_i)); requests target a group
        # of the FINEST level, and an admission dispatch reads one prefix row
        # of each level, so the query fold stays exact.
        sbs = [
            (engine.level_batch[i] if engine.level_batch else lv.max_batch_size)
            for i, lv in enumerate(engine.cache.shared[: engine.num_used_levels])
        ]
        self._sbs = sbs
        self._finest = max(sbs, default=1)
        for sb in sbs:
            assert self._finest % sb == 0 and B_pool % sb == 0, (
                f"level batch sizes {sbs} must nest and divide the pool {B_pool}"
            )
        assert B_pool % self._finest == 0
        self.engine = engine
        self.chunk = chunk
        self.bucket = bucket
        # "lpt": longest-budget-first admission. Rows advance in lockstep
        # chunks, so a short request admitted beside long ones burns masked
        # steps; starting long requests first aligns finish times and cuts
        # the drain. "fifo" keeps strict arrival order.
        self.admit_policy = admit_policy
        self.temperature = float(temperature)
        self.top_p = top_p
        self.eos = -1 if eos_token_id is None else int(eos_token_id)
        engine._generator.manual_seed(seed)

        self.B = B_pool
        self.U = engine.cache.max_unique_seq_len
        self._key = ChunkKey(
            engine._spec("decode", unique_history=True,
                         rows=(self._row0, B_pool) if dp > 1 else ()),
            self._nrows, self.temperature, top_p, self.eos, next(_SERIAL),
        )
        self._chunk = ChunkStep(self._key, self.U, chunk, engine.device)
        self.state = self._chunk.state
        self._queue: List[_Request] = []
        self._rows: Dict[int, Optional[_Request]] = {r: None for r in range(B_pool)}
        self._done: Dict[int, _Request] = {}
        self._next_rid = 0
        # Rows admitted since the last chunk: their first (prefill-sampled)
        # token is read back with that chunk's tokens; admission never
        # syncs with the host.
        self._fresh_rows: List[int] = []
        # Records of the dispatched chunks not yet parsed: (tokens, with the
        # fresh rows' first tokens as a last column where there are fresh
        # rows; the fresh rows; row -> request at dispatch). They are parsed
        # once MORE than ``lookahead`` chunks are in flight.
        self.lookahead = lookahead
        self._pending: List[tuple] = []
        self.stats = {"admit_dispatches": 0, "admitted": 0, "chunks": 0, "decode_steps": 0}
        self.admit_forwards = 0

    # -- submission ----------------------------------------------------------

    def submit(self, ids, max_new_tokens: int = 32, group: int = 0,
               stop_sequences=None) -> int:
        """``group`` picks the shared-prefix stack (finest level's prefix
        index) the request decodes under. ``stop_sequences``: per-request
        token-id sequences ending the request early; its tokens run up to
        and including the completed stop sequence. Matched on the host at
        readbacks, so a stopped row may compute up to one lookahead chunk of
        masked garbage before its row frees."""
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        assert ids.size + max_new_tokens <= self.U, (
            f"request needs {ids.size + max_new_tokens} ring slots, "
            f"the pool holds {self.U}"
        )
        assert 0 <= group < self._finest, (
            f"group {group} out of range (finest level has {self._finest})"
        )
        rid = self._next_rid
        self._next_rid += 1
        stops = tuple(tuple(int(t) for t in s) for s in (stop_sequences or ()))
        self._queue.append(_Request(rid, ids, max_new_tokens, group=group, stops=stops))
        return rid

    # -- internals -----------------------------------------------------------

    def _row_group(self, row: int) -> int:
        return row // (self.B // self._finest)

    def _free_rows(self) -> List[int]:
        return [r for r, req in self._rows.items() if req is None]

    def _all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (this rank's rows first on dim 0),
        gathered over dp in rank order: the pool's global rows."""
        return mesh_lib.all_gather(x, self.engine.mesh, "dp", dim=0) if self._dp > 1 else x

    def _admit_batch(self, pairs: List) -> None:
        """Admit [(row, req), ...]: one dispatch a (prompt bucket, group).
        No host readback: first tokens are collected at the next chunk's
        parse."""
        groups: Dict[tuple, List] = {}
        for row, req in pairs:
            tb = min(-(-max(1, len(req.ids)) // self.bucket) * self.bucket, self.U)
            groups.setdefault((tb, self._row_group(row)), []).append((row, req))
        for (tb, g), members in groups.items():
            self._admit_step(members, tb, tuple(g // (self._finest // sb) for sb in self._sbs))
            for row, req in members:
                self._rows[row] = req
                self._fresh_rows.append(row)

    @torch.no_grad()
    def _admit_step(self, members: List, tb: int, level_rows: tuple) -> None:
        """Prefill ``members``' suffixes (right-padded to ``tb``) into their
        rows' ring slots, sample their first tokens and write their rows'
        state, in place (``hydragen_tpu/core/batching.py:_admit_step``).
        ``level_rows``: the prefix row of each active level that every
        member attends. Under dp this rank prefills the members in its rows
        (none: no forward), and the first tokens are sampled on every rank
        from every member's logits, gathered over dp in the members' order."""
        eng = self.engine
        ranks = [row // self._nrows for row, _ in members]  # each member's dp rank
        here = [j for j, i in enumerate(ranks) if i == self._dpi]
        written = None
        if here:
            own = [(members[j][0] - self._row0, members[j][1]) for j in here]
            logits, written = self._admit_forward(own, tb, level_rows)
        if self._dp > 1:
            # Every rank's members' logits, padded to the largest count, then
            # put in the members' order.
            width = max(ranks.count(i) for i in range(self._dp))
            pad = torch.zeros((width, eng.config.vocab_size), dtype=torch.float32,
                              device=eng.device)
            if here:
                pad[: len(here)] = logits
            order = [i * width + ranks[:j].count(i) for j, i in enumerate(ranks)]
            logits = self._all_rows(pad).index_select(0, self._on_device(order, torch.long))
        first = sample_from_logits(logits, eng._generator, self.temperature, self.top_p, 1)
        self.stats["admit_dispatches"] += 1
        self.stats["admitted"] += len(members)
        if written is None:
            return
        self.admit_forwards += 1
        if self._dp > 1:
            first = first.index_select(0, self._on_device(here, torch.long))
        rows, seq_lens, max_news, shared_len = written
        st = self.state
        st.cur_token.index_copy_(0, rows, first)
        st.pos.index_copy_(0, rows, shared_len + seq_lens)
        st.start.index_copy_(0, rows, st.cursor - seq_lens)
        st.remaining.index_copy_(0, rows, max_news - 1)
        st.active.index_copy_(0, rows, max_news > 1)

    def _admit_forward(self, members: List, tb: int, level_rows: tuple):
        """The prefill of ``members`` [(local row, request)] and their ring
        scatter; returns their last-token logits ``[K, V]`` and what the
        state writes need: (local rows, suffix lengths, budgets, the
        prefix length)."""
        eng, cache = self.engine, self.engine.cache
        dev, U, K = eng.device, self.U, len(members)
        ids = np.zeros((K, tb), dtype=np.int32)
        lens = np.zeros((K,), dtype=np.int32)
        for i, (_, req) in enumerate(members):
            ids[i, : len(req.ids)] = req.ids
            lens[i] = len(req.ids)
        rows = self._on_device([row for row, _ in members], torch.long)
        max_news = self._on_device([req.max_new_tokens for _, req in members], torch.int32)
        seq_lens = self._on_device(lens, torch.int32)
        input_ids = self._on_device(ids, torch.int32)
        # One prefix row of each level (all of an sb == 1 pool's levels).
        spec = eng._spec("unique_prefill", unique_history=False)._replace(
            level_batch=(1,) * len(level_rows), level_row=level_rows)
        shared_len = torch.zeros((), dtype=torch.int32, device=dev)
        for lv, r in zip(cache.shared[: spec.num_used_levels], level_rows):
            shared_len = shared_len + lv.seq_lens[r]
        local_pos = torch.minimum(torch.arange(tb, dtype=torch.int32, device=dev)[None, :],
                                  seq_lens[:, None] - 1)
        pos = shared_len + local_pos
        # Right-aligned ring scatter: request i's token j < p_i lands in slot
        # (cursor - p_i + j) mod U. Only the valid (i, j) pairs are written
        # (the JAX batcher sends the padding out of bounds and drops it).
        ki, ji = np.nonzero(np.arange(tb)[None, :] < lens[:, None])
        ki, ji = self._on_device(ki, torch.long), self._on_device(ji, torch.long)
        slots = torch.remainder(self.state.cursor - seq_lens[ki] + ji, U).long()
        hidden = model_forward(
            eng.params, eng.config, cache, input_ids, pos, local_pos, spec,
            write=KVWrite.ring(cache, rows[ki], slots, (ki, ji)), mesh=eng.mesh)
        logits = logits_from_hidden(eng.params, eng.config, hidden, seq_lens, mesh=eng.mesh)
        return logits[:, -1], (rows, seq_lens, max_news, shared_len)

    def _on_device(self, x, dtype) -> torch.Tensor:
        """Host values on the engine's device; to a card through pinned
        memory, without waiting for the work already enqueued."""
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        if self.engine.device.type != "cuda":
            return t
        return t.pin_memory().to(self.engine.device, non_blocking=True)

    def _step_body(self) -> None:
        """One decode step over the static buffers (this rank's rows), every
        row at slot ``cursor % U`` (``hydragen_tpu/core/batching.py:
        _decode_chunk``'s scan body): no host value, no host sync."""
        eng, key, st = self.engine, self._key, self.state
        U, cache, mesh = self.U, eng.cache, eng.mesh
        mask = ring_mask(st.start, st.cursor, U)
        slot = torch.remainder(st.cursor, U)
        upos = slot.expand(st.pos.shape)
        hidden = model_forward(
            eng.params, eng.config, cache, st.cur_token, st.pos[:, None], upos[:, None],
            key.spec, history_mask=mask, write=KVWrite.slot(cache, key.batch, slot),
            mesh=mesh,
        )
        logits = logits_from_hidden(eng.params, eng.config, hidden, mesh=mesh)[:, 0]
        nxt = eng._sample_rows(logits, key.spec, key.temperature, key.top_p)[:, 0]
        active = st.active
        emitted = torch.where(active, nxt, -1)
        new_active = active & (st.remaining > 1)
        if key.eos >= 0:
            new_active = new_active & (nxt != key.eos)
        adv = active.to(torch.int32)
        ch = self._chunk
        ch.out.index_copy_(1, ch.i.long().reshape(1), emitted[:, None])
        ch.i.add_(1)
        st.cur_token.copy_(torch.where(active[:, None], nxt[:, None], st.cur_token))
        st.pos.add_(adv)
        # Inactive rows' windows slide with the cursor so their stale slots
        # age out instead of accumulating garbage in the mask.
        st.start.add_(1 - adv)
        st.remaining.sub_(adv)
        st.active.copy_(new_active)
        st.cursor.add_(1)

    def _graph_holder(self) -> ChunkStep:
        """This batcher's chunk step in the engine's graph table; after the
        engine dropped its graphs (a new cache or new parameters) it comes
        back without a graph and is captured anew."""
        return self.engine._graph_state(self._key, self._chunk.reset_graph)

    @torch.no_grad()
    def _decode_chunk(self, steps: int, firsts: bool = False) -> torch.Tensor:
        """Enqueue ``steps`` decode steps (graph replays, or the eager body);
        returns a device copy of the pool's ``[B, steps]`` tokens (-1 where a
        row was inactive), enqueued before the next chunk's replays, with
        ``firsts`` each row's input token before the chunk (a fresh row's
        first token) as one more column. Under dp the rows are gathered."""
        ch = self._graph_holder()
        before = self.state.cur_token.clone() if firsts else None
        ch.i.zero_()
        self.engine._decode_steps(ch, steps, body=self._step_body)
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += steps
        toks = ch.out[:, :steps]
        toks = toks.clone() if before is None else torch.cat([toks, before], dim=1)
        return self._all_rows(toks)

    def _retire(self, row: int) -> None:
        req = self._rows[row]
        if req is not None:
            req.done = True
            self._done[req.rid] = req
            self._rows[row] = None

    def _deactivate(self, rows: List[int]) -> None:
        """Rows the device must stop decoding from the next chunk on, in
        place (enqueued after the chunks already dispatched); this rank's
        own among them."""
        local = [r - self._row0 for r in rows if r // self._nrows == self._dpi]
        if local:
            self.state.active.index_fill_(0, self._on_device(local, torch.long), False)

    # -- main loop -------------------------------------------------------------

    def _collect_fresh(self, firsts, fresh_rows, snapshot) -> List[int]:
        """The newly admitted rows' first tokens; returns the rows that
        finished on their first token (eos, budget 1 or a stop).
        ``snapshot`` maps row -> request as of the chunk's dispatch."""
        finished = []
        for row, tok in zip(fresh_rows, firsts):
            req = snapshot[row]
            req.tokens.append(int(tok))
            if ((self.eos >= 0 and tok == self.eos) or req.max_new_tokens <= 1
                    or _hit_stop(req.tokens, req.stops)):
                finished.append(row)
        return finished

    def _process_readback(self, toks_dev, fresh_rows, snapshot):
        """Parse one dispatched chunk's results (the host waits for the
        device only here: one readback). ``snapshot`` maps row -> request AS
        OF that chunk's dispatch: a row retired and re-admitted since must
        not leak this chunk's tokens into the new request."""
        toks = toks_dev.cpu().numpy()
        if fresh_rows:
            firsts, toks = toks[fresh_rows, -1].tolist(), toks[:, :-1]
            first_finished = self._collect_fresh(firsts, fresh_rows, snapshot)
        else:
            first_finished = []
        if first_finished:
            # The rows stay active for the chunks already dispatched (their
            # garbage is masked by req.done below, their windows are their
            # own); deactivate them from the following chunk on.
            self._deactivate(first_finished)
            for row in first_finished:
                self._retire(row)
        stopped_rows = []
        for row, req in snapshot.items():
            if req is None or req.done:
                continue
            hit_stop = False
            for tok in toks[row]:
                if tok < 0:
                    break
                req.tokens.append(int(tok))
                if self.eos >= 0 and tok == self.eos:
                    break
                if _hit_stop(req.tokens, req.stops):
                    hit_stop = True
                    break
                if len(req.tokens) >= req.max_new_tokens:
                    break
            # Budget and eos retirement mirror the device's own (the row went
            # inactive at the same step). A stop the device cannot see: the
            # row is deactivated below, or it would decode garbage until its
            # re-admission.
            if (len(req.tokens) >= req.max_new_tokens
                    or (self.eos >= 0 and req.tokens and req.tokens[-1] == self.eos)
                    or hit_stop):
                if hit_stop and self._rows.get(row) is req:
                    stopped_rows.append(row)
                self._retire(row)
        if stopped_rows:
            self._deactivate(stopped_rows)

    def _drain_pending(self, to_depth: int = 0) -> None:
        while len(self._pending) > to_depth:
            self._process_readback(*self._pending.pop(0))

    def step(self) -> bool:
        """Admit from the queue, dispatch one decode chunk, then parse the
        chunk dispatched ``lookahead`` chunks ago while the device runs this
        one. True while work remains (queue, live rows or unparsed chunks)."""
        pairs = []
        free_by_group: Dict[int, List[int]] = {}
        for r in self._free_rows():
            free_by_group.setdefault(self._row_group(r), []).append(r)
        order = self._queue
        if self.admit_policy == "lpt":
            order = sorted(self._queue, key=lambda req: -req.max_new_tokens)  # stable
        taken = set()
        for req in order:
            rows = free_by_group.get(req.group)
            if rows:
                pairs.append((rows.pop(0), req))
                taken.add(req.rid)
        self._queue = [req for req in self._queue if req.rid not in taken]
        if pairs:
            self._admit_batch(pairs)

        # Tail shrink: once the queue is empty, a chunk longer than every live
        # row's remaining budget only computes masked garbage; halve it down
        # a power-of-two ladder (not below 8). len(req.tokens) lags the
        # pending chunks, so the bound only over-estimates (safe).
        steps = self.chunk
        if not self._queue:
            live_rem = [req.max_new_tokens - len(req.tokens)
                        for req in self._rows.values() if req is not None and not req.done]
            bound = max(live_rem, default=steps)
            while steps >= 16 and steps // 2 >= bound:
                steps //= 2

        fresh, self._fresh_rows = self._fresh_rows, []
        # The fresh rows' first tokens come back with the chunk's tokens,
        # copied before this chunk overwrites cur_token.
        toks = self._decode_chunk(steps, firsts=bool(fresh))
        self._pending.append((toks, fresh, dict(self._rows)))
        self._drain_pending(to_depth=self.lookahead)

        def live():
            return bool(self._queue) or any(req is not None for req in self._rows.values())

        if not live():
            # The drain's tail: only the in-flight chunks' results are left.
            self._drain_pending()
        return live()

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {request_id: generated tokens}."""
        while self.step():
            pass
        return {rid: req.tokens for rid, req in sorted(self._done.items())}
