"""HydragenLlama: the generation engine, in PyTorch.

Port of ``hydragen_tpu.core.engine`` (single device): ``setup_caches`` /
``append_shared`` / ``process_unique`` / ``generate`` with
``shared_cache_op``, ``starting_logits``, ``return_logits``,
``token_overrides``, temperature and top-p sampling, EOS and stop sequences.

Where the JAX engine jit-compiles one program per mode and scans the decode
loop, this engine runs eagerly: the steps are plain functions and the decode
loop is a Python loop (CUDA graphs are later work). It runs on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from hydragen_torch.core.cache import (
    KVCache,
    allocate_cache,
    repeat_unique_for_samples,
    set_shared_level_buffers,
    shared_len_for_batch,
    update_unique_decode,
    update_unique_prefill,
)
from hydragen_torch.models.config import ModelConfig
from hydragen_torch.models.llama import (
    ForwardSpec,
    is_quantized_params,
    logits_from_hidden,
    model_forward,
)


class SharedCacheOp:
    WIPE = "wipe"
    EXTEND = "extend"
    PRESERVE = "preserve"


def resolve_device(device) -> torch.device:
    """``None`` means the card; with no card present this raises rather than
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "HydragenLlama runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def _finished_mask(tokens_np, eos_token_id, stop_sequences):
    """``[b, T]`` bool: row i has finished at or before column j (EOS, or a
    stop sequence completed as a suffix of the generated stream)."""
    b, T = tokens_np.shape
    fin = np.zeros((b, T), dtype=bool)
    if eos_token_id is not None:
        fin |= tokens_np == eos_token_id
    for s in stop_sequences or ():
        s = np.asarray(s, dtype=tokens_np.dtype)
        L = len(s)
        if L == 0 or L > T:
            continue
        win = np.lib.stride_tricks.sliding_window_view(tokens_np, L, axis=1)
        fin[:, L - 1:] |= (win == s).all(axis=-1)
    return np.logical_or.accumulate(fin, axis=1)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest set of top tokens with cumulative prob > top_p."""
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1)  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = cum <= (1.0 - top_p)
    remove_sorted[..., -1] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, sorted_idx, remove_sorted)
    return logits.masked_fill(remove, -float("inf"))


def sample_from_logits(logits: torch.Tensor, generator: torch.Generator,
                       temperature: float, top_p: Optional[float],
                       num_samples: int = 1) -> torch.Tensor:
    """``[b, num_samples]`` int32 token ids."""
    if top_p is not None:
        logits = apply_top_p(logits, top_p)
    if temperature == 0:
        return logits.argmax(dim=-1, keepdim=True).repeat(1, num_samples).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, num_samples, replacement=True,
                             generator=generator).to(torch.int32)


def _pad_to_bucket(input_ids, seq_lens, bucket: int, cap: int):
    """Right-pad ``input_ids`` to a bucket multiple (clamped to ``cap``),
    making up ``seq_lens`` if absent. Returns (ids, seq_lens, padded)."""
    t = int(input_ids.shape[1])
    if not bucket or t % bucket == 0:
        return input_ids, seq_lens, False
    tb = min(-(-t // bucket) * bucket, cap)
    if tb <= t:
        return input_ids, seq_lens, False
    if seq_lens is None:
        seq_lens = torch.full((input_ids.shape[0],), t, dtype=torch.int32,
                              device=input_ids.device)
    return torch.nn.functional.pad(input_ids, (0, tb - t)), seq_lens, True


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(x.to(device) for x in tree))
    return tree.to(device)


class HydragenLlama:
    """Stateful wrapper: params + cache + the host-side level stack."""

    def __init__(
        self,
        config: ModelConfig,
        params: dict,
        impl: Optional[str] = None,
        quantization: Optional[str] = None,
        prefill_bucket: int = 128,
        eos_chunk: int = 32,
        device=None,
    ):
        self.device = resolve_device(device)
        if quantization is not None:
            assert quantization in ("int8", "w8a8"), f"unknown quantization {quantization!r}"
            if not is_quantized_params(params):
                from hydragen_torch.ops.quant import quantize_params

                params = quantize_params(params, pad_mlp=quantization == "w8a8")
        self.config = config
        self.params = _params_to(params, self.device)
        self.impl = impl
        # "w8a8": activations quantized per row and products on the s8 GEMM.
        self.matmul_impl = "w8a8" if quantization == "w8a8" else "dq"
        self.cache: Optional[KVCache] = None
        self.num_used_levels = 0
        self.level_filled: List[int] = []
        self.level_batch: List[int] = []
        # Shared-prefill inputs are right-padded to a multiple of
        # prefill_bucket (seq_lens mask the padding). 0 disables.
        self.prefill_bucket = prefill_bucket
        # With stops active, decode checks for finished rows every eos_chunk
        # steps. 0 disables.
        self.eos_chunk = eos_chunk
        self._disable_attention = False

    # -- cache management ----------------------------------------------------

    def setup_caches(
        self,
        max_unique_batch_size: int,
        max_unique_seq_length: int,
        max_shared_batch_sizes: Sequence[int] = (),
        max_shared_seq_lengths: Sequence[int] = (),
        cache_dtype=None,
        kv_quant: Optional[str] = None,
        unique_bshd: Optional[bool] = None,
        shared_kv_quant: str = "follow",
    ):
        """Allocate all cache buffers. ``kv_quant="int8"`` stores payloads
        int8 with per-(token, head) f32 scales; ``shared_kv_quant`` "follow"
        (levels match kv_quant), "none" or "int8"."""
        assert kv_quant in (None, "int8"), f"unknown kv_quant {kv_quant!r}"
        assert shared_kv_quant in ("follow", "none", "int8")
        shared_quantized = None if shared_kv_quant == "follow" else (
            shared_kv_quant == "int8")
        cfg = self.config
        max_unique_seq_length = -(-max_unique_seq_length // 16) * 16
        self.cache = allocate_cache(
            cfg.num_hidden_layers, max_unique_batch_size, max_unique_seq_length,
            list(max_shared_batch_sizes), list(max_shared_seq_lengths),
            cfg.num_key_value_heads, cfg.head_dim,
            dtype=cache_dtype or cfg.torch_dtype, quantized=kv_quant == "int8",
            unique_bshd=unique_bshd, shared_quantized=shared_quantized,
            device=self.device,
        )
        self.num_used_levels = 0
        self.level_filled = []
        self.level_batch = []

    def empty_shared_cache(self):
        self.truncate_shared_caches(0)

    def truncate_shared_caches(self, new_num: int):
        assert new_num <= len(self.cache.shared)
        self.num_used_levels = min(new_num, self.num_used_levels)
        self.level_filled = self.level_filled[: self.num_used_levels]
        self.level_batch = self.level_batch[: self.num_used_levels]

    def get_shared_cache_len(self, batch_size: int) -> torch.Tensor:
        return shared_len_for_batch(self.cache, self.num_used_levels, batch_size,
                                    tuple(self.level_batch) or None)

    def get_num_used_shared_caches(self) -> int:
        return self.num_used_levels

    def _spec(self, mode: str, unique_history: bool) -> ForwardSpec:
        return ForwardSpec(
            mode=mode,
            num_used_levels=self.num_used_levels,
            level_filled=tuple(self.level_filled),
            unique_history=unique_history,
            unique_filled=self.cache.max_unique_seq_len if unique_history else 0,
            disable_hydragen=False,
            disable_attention=self._disable_attention,
            impl=self.impl,
            matmul=self.matmul_impl,
            level_batch=tuple(self.level_batch),
        )

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.int32).to(self.device)

    # -- prefill entry points ------------------------------------------------

    @torch.no_grad()
    def append_shared(self, input_ids, seq_lens=None, full_logits: bool = False):
        """Prefill a new shared level; returns its last-token logits."""
        assert self.cache is not None, "call setup_caches first"
        assert self.num_used_levels < len(self.cache.shared), "no free shared level"
        input_ids = self._ids(input_ids)
        level = self.cache.shared[self.num_used_levels]
        b, t = input_ids.shape
        assert b <= level.max_batch_size, (
            f"level {self.num_used_levels} allocated for {level.max_batch_size} "
            f"prefixes, got {b}")
        assert t <= level.max_seq_len, (
            f"level {self.num_used_levels} holds {level.max_seq_len} tokens, got {t}")
        if seq_lens is not None:
            seq_lens = self._ids(seq_lens)
        input_ids, seq_lens, padded = _pad_to_bucket(
            input_ids, seq_lens, self.prefill_bucket, level.max_seq_len)
        has_pad = seq_lens is not None
        orig_t, t = t, int(input_ids.shape[1])
        spec = self._spec("shared_prefill", unique_history=False)
        shared_lens = shared_len_for_batch(self.cache, spec.num_used_levels, b,
                                           spec.level_batch or None)
        ar = torch.arange(t, device=self.device, dtype=torch.int32)[None, :]
        if has_pad:
            local_pos = torch.minimum(ar, seq_lens[:, None] - 1)
        else:
            seq_lens = torch.full((b,), t, dtype=torch.int32, device=self.device)
            local_pos = ar.expand(b, t)
        pos = shared_lens[:, None] + local_pos
        # The layer loop writes each layer's KV straight into the level.
        hidden, self.cache = model_forward(
            self.params, self.config, self.cache, input_ids, pos, local_pos, spec,
            fill_level=self.num_used_levels,
        )
        set_shared_level_buffers(self.cache, self.num_used_levels, seq_lens)
        logits = logits_from_hidden(self.params, self.config, hidden,
                                    seq_lens if has_pad else None, full_logits)
        self.num_used_levels += 1
        self.level_filled.append(t)
        self.level_batch.append(b)
        if full_logits and padded:
            logits = logits[:, :orig_t]
        return logits

    @torch.no_grad()
    def process_unique(self, input_ids, seq_lens=None):
        """Prefill per-sequence suffixes into the unique cache."""
        assert self.cache is not None
        input_ids = self._ids(input_ids)
        has_pad = seq_lens is not None
        if has_pad:
            seq_lens = self._ids(seq_lens)
        b, t = input_ids.shape
        spec = self._spec("unique_prefill", unique_history=False)
        shared_lens = shared_len_for_batch(self.cache, spec.num_used_levels, b,
                                           spec.level_batch or None)
        ar = torch.arange(t, device=self.device, dtype=torch.int32)[None, :]
        pos = shared_lens[:, None] + ar
        unique_pos = ar.expand(b, t)
        hidden, nk, nv = model_forward(
            self.params, self.config, self.cache, input_ids, pos, unique_pos, spec,
            quantize_new_kv=8 if self.cache.quantized else None,
        )
        update_unique_prefill(self.cache, nk, nv)
        return logits_from_hidden(self.params, self.config, hidden,
                                  seq_lens if has_pad else None)

    # -- generation ------------------------------------------------------------

    def _decode_steps(self, first_token, start_pos, start_unique_pos, uniform_slot,
                      generator, overrides, steps, temperature, top_p, return_logits):
        """``steps`` decode steps from ``first_token``; returns (tokens
        [b, steps], logits list, next input token)."""
        spec = self._spec("decode", unique_history=True)
        inplace = uniform_slot is not None and is_quantized_params(self.params)
        tok = first_token
        toks, logits_seq = [], []
        for i in range(steps):
            pos = (start_pos + i)[:, None]
            upos = start_unique_pos + i
            if inplace:
                hidden, self.cache = model_forward(
                    self.params, self.config, self.cache, tok, pos, upos[:, None], spec,
                    history_lens=upos, inplace_slot=uniform_slot + i,
                )
            else:
                hidden, nk, nv = model_forward(
                    self.params, self.config, self.cache, tok, pos, upos[:, None], spec,
                    history_lens=upos,
                )
                update_unique_decode(
                    self.cache, upos, nk, nv,
                    uniform=None if uniform_slot is None else uniform_slot + i,
                )
            logits = logits_from_hidden(self.params, self.config, hidden)[:, 0]
            nxt = sample_from_logits(logits, generator, temperature, top_p, 1)
            toks.append(nxt[:, 0])
            if return_logits:
                logits_seq.append(logits)
            tok = overrides[i][:, None] if overrides is not None else nxt
        return torch.stack(toks, dim=1), logits_seq, tok

    @torch.no_grad()
    def generate(
        self,
        input_ids=None,
        seq_lens=None,
        starting_logits=None,
        num_return_sequences: int = 1,
        max_new_tokens: int = 5,
        temperature: float = 1.0,
        top_p: Optional[float] = None,
        eos_token_id: Optional[int] = None,
        stop_sequences: Optional[Sequence[Sequence[int]]] = None,
        return_logits: bool = False,
        shared_cache_op: str = SharedCacheOp.PRESERVE,
        disable_attention: bool = False,
        token_overrides=None,
        seed: int = 0,
    ):
        """Generate ``max_new_tokens`` per sequence.

        ``input_ids``: a list of levels (each ``[b_i, t_i]``), the last one the
        per-sequence suffixes unless ``num_return_sequences > 1``, in which
        case every given level is shared and the samples are the unique rows.
        Returns tokens ``[b, T]`` int32 (and the per-step logits when
        ``return_logits``)."""
        assert self.cache is not None, "call setup_caches first"
        assert (input_ids is None) or (starting_logits is None)
        assert not (input_ids is None and starting_logits is None)
        if temperature < 0:
            raise ValueError(f"temperature must be non-negative, got {temperature}")
        stop_sequences = tuple(
            tuple(int(t) for t in s) for s in stop_sequences
        ) if stop_sequences is not None else ()
        if input_ids is None:
            input_ids = []
        if isinstance(input_ids, (np.ndarray, torch.Tensor)):
            input_ids = [input_ids]
        input_ids = [self._ids(x) for x in input_ids]
        if disable_attention:
            self._disable_attention = True
        if shared_cache_op == SharedCacheOp.WIPE:
            self.empty_shared_cache()
        og_levels = self.num_used_levels

        if seq_lens is None:
            seq_lens = [None] * len(input_ids)
        elif isinstance(seq_lens, (np.ndarray, torch.Tensor)):
            seq_lens = [seq_lens]
        if input_ids:
            total_batch = int(input_ids[-1].shape[0]) * num_return_sequences
        else:
            total_batch = int(starting_logits.shape[0]) * num_return_sequences

        if num_return_sequences > 1:
            shared_ids, shared_lens_in = input_ids, seq_lens
            suffix_ids, suffix_lens = None, None
        elif input_ids:
            shared_ids, shared_lens_in = input_ids[:-1], seq_lens[:-1]
            suffix_ids, suffix_lens = input_ids[-1], seq_lens[-1]
        else:
            shared_ids, shared_lens_in, suffix_ids, suffix_lens = [], [], None, None

        if starting_logits is not None:
            starting_logits = torch.as_tensor(starting_logits).to(self.device)[:, None, :]
        for sid, slen in zip(shared_ids, shared_lens_in):
            starting_logits = self.append_shared(sid, slen)

        suffix_lens_np = None if suffix_lens is None else np.asarray(
            suffix_lens.cpu() if torch.is_tensor(suffix_lens) else suffix_lens)
        suffix_uniform = suffix_lens_np is None or bool(
            np.all(suffix_lens_np == suffix_lens_np.flat[0]))
        if suffix_ids is not None:
            suffix_ids, suffix_lens, _ = _pad_to_bucket(
                suffix_ids, None if suffix_lens is None else self._ids(suffix_lens),
                self.prefill_bucket, self.cache.max_unique_seq_len,
            )
            starting_logits = self.process_unique(suffix_ids, suffix_lens)
            if num_return_sequences > 1:
                repeat_unique_for_samples(self.cache, int(suffix_ids.shape[0]),
                                          num_return_sequences)

        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        prefill_logits = starting_logits[:, -1]
        first_token = sample_from_logits(
            prefill_logits, generator, temperature, top_p, num_return_sequences
        ).reshape(-1, 1)
        logits_out = None
        if return_logits:
            logits_out = [prefill_logits.repeat_interleave(num_return_sequences, dim=0)]

        start_pos = self.get_shared_cache_len(total_batch)
        uniform_slot = None
        if suffix_ids is not None:
            if suffix_lens is not None:
                sl = suffix_lens.to(self.device, torch.int32)
                first_len = int(sl[0])
            else:
                first_len = int(suffix_ids.shape[1])
                sl = torch.full((suffix_ids.shape[0],), first_len, dtype=torch.int32,
                                device=self.device)
            sl = sl.repeat_interleave(num_return_sequences)
            start_pos = start_pos + sl
            start_unique_pos = sl
            if suffix_uniform:
                uniform_slot = first_len
        else:
            start_unique_pos = torch.zeros((total_batch,), dtype=torch.int32,
                                           device=self.device)
            uniform_slot = 0

        use_overrides = token_overrides is not None
        if use_overrides:
            token_overrides = self._ids(token_overrides)
            cur_tok = token_overrides[:, 0:1]
            overrides_t = token_overrides[:, 1:max_new_tokens].T
        else:
            cur_tok = first_token
            overrides_t = None

        steps = max_new_tokens - 1
        tokens = first_token
        if steps > 0:
            # With stops active, decode in chunks with a host check between,
            # so a batch that finishes early skips the rest of the budget.
            stops_active = (eos_token_id is not None or stop_sequences) and not use_overrides
            chunk = self.eos_chunk if stops_active else 0
            if not chunk or chunk >= steps:
                plan = [steps]
            else:
                plan = [chunk] * (steps // chunk) + ([steps % chunk] if steps % chunk else [])
            tok_chunks = [first_token]
            done = 0
            fin_rows = None
            max_l = max((len(s) for s in stop_sequences), default=1)
            tail = first_token.cpu().numpy()
            for c in plan:
                toks, step_logits, cur_tok = self._decode_steps(
                    cur_tok, start_pos + done, start_unique_pos + done,
                    None if uniform_slot is None else uniform_slot + done, generator,
                    None if overrides_t is None else overrides_t[done:done + c],
                    c, temperature, top_p, return_logits,
                )
                done += c
                tok_chunks.append(toks)
                if return_logits:
                    logits_out.extend(step_logits)
                if stops_active and len(plan) > 1:
                    window = np.concatenate([tail, toks.cpu().numpy()], axis=1)
                    hit = _finished_mask(window, eos_token_id, stop_sequences)[:, -1]
                    fin_rows = hit if fin_rows is None else (fin_rows | hit)
                    if fin_rows.all():
                        break
                    tail = window[:, window.shape[1] - (max_l - 1):] if max_l > 1 \
                        else window[:, :0]
            tokens = torch.cat(tok_chunks, dim=1)

        # Truncate at the first column where every row has finished.
        if (eos_token_id is not None or stop_sequences) and tokens.shape[1] > 1:
            fin = _finished_mask(tokens.cpu().numpy(), eos_token_id, stop_sequences)
            all_done = fin.all(axis=0)
            if all_done.any():
                keep = max(1, int(np.argmax(all_done)))
                tokens = tokens[:, :keep]
                if return_logits:
                    logits_out = logits_out[:keep]

        if shared_cache_op == SharedCacheOp.PRESERVE:
            self.truncate_shared_caches(og_levels)
        if disable_attention:
            self._disable_attention = False
        if return_logits:
            return tokens, logits_out
        return tokens
