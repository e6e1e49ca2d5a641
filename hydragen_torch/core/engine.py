"""HydragenLlama: the generation engine, in PyTorch.

Port of ``hydragen_tpu.core.engine``: ``from_pretrained`` /
``from_hf_model`` / ``setup_caches`` / ``append_shared`` / ``process_unique``
/ ``generate`` with ``shared_cache_op``, ``starting_logits``,
``return_logits``, ``token_overrides``, temperature and top-p sampling, EOS
and stop sequences, and the ``disable_hydragen`` and ``disable_hierarchy``
ablations.

Where the JAX engine jit-compiles one program per mode, the prefills here
run eagerly. The decode loop, which the JAX engine compiles into one
``lax.scan`` over the steps (``hydragen_tpu/core/engine.py:_decode_steps``),
is one step body over static buffers: it reads its input token, base
positions, step counter and forced tokens from device memory and writes its
sampled token, logits and next input back, and the unique slot it writes is
computed on the device (``start_unique_pos + i``), as the JAX step passes a
traced slot. On the card that body is captured once as a CUDA graph a key
(the JAX ``static_argnames`` and whether each row writes its own slot) and
replayed once a step, with no host work inside an EOS chunk;
``graph(False)`` runs the same body eagerly. The engine runs on the card unless the caller passes
``device="cpu"``, where the body runs eagerly.

Under a ``parallel.Mesh`` (``mesh=``, ``shard(mesh)``, ``from_pretrained_tp``)
every rank is one process that holds its shards and is called with the same
global inputs; each runs its rows (dp), heads (tp) and level slices (sp)
and the collectives of ``parallel/``. The logits of the vocab-sharded head
are gathered over tp before sampling and every rank draws from the same
generator state, so all ranks give the same tokens; under dp each rank
decodes its rows, the finished flags are agreed by an all-reduce, and
``generate`` returns the whole batch on every rank. The step is captured as
a CUDA graph under NCCL; under gloo (ranks sharing a card, or the CPU) it
runs eagerly, and ``graph(True)`` raises there.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from hydragen_torch.core.cache import (
    KVCache,
    KVWrite,
    allocate_cache,
    copy_shared_to_unique,
    expand_unique_rows,
    repeat_unique_for_samples,
    set_shared_level_buffers,
    shared_len_for_batch,
)
from hydragen_torch.models.config import ModelConfig
from hydragen_torch.models.llama import (
    ForwardSpec,
    is_quantized_params,
    logits_from_hidden,
    model_forward,
)
from hydragen_torch.ops import cuda_lib
from hydragen_torch.parallel import mesh as mesh_lib
from hydragen_torch.parallel.shard_attn import gather_level
from hydragen_torch.parallel.sharding import (
    INT4_CACHE_WAITS,
    RankParams,
    cache_pspecs,
    shard_cache,
    shard_params,
    shard_plan,
)
from hydragen_torch.utils.profiling import span


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


class DecodeKey(NamedTuple):
    """What one decode graph bakes in: the JAX ``_decode_steps``'s static
    arguments (but ``steps``: a graph is one step) and whether each row
    writes its own slot (``per_row``: ragged suffixes) or every row the
    same one. The cache and the parameters a graph reads by address are not
    in the key: the engine drops every graph with its cache or
    parameters."""

    spec: ForwardSpec
    batch: int
    temperature: float
    top_p: Optional[float]
    use_overrides: bool
    return_logits: bool
    per_row: bool


class DecodeStep:
    """One decode step's static buffers and, on the card, its graph.

    The step body reads ``tok`` ``[b, 1]``, ``start_pos`` and ``start_upos``
    ``[b]``, the step counter ``i`` (an int32 scalar) and, with overrides,
    row ``i`` of ``overrides`` ``[cap, b]``; it writes its sampled token into
    column ``i`` of ``out`` ``[b, cap]``, its logits into ``logits`` ``[b,
    V]``, its next input into ``tok``, and ``i + 1`` into ``i``. ``cap`` is
    the unique cache's length, which bounds a call's decode steps."""

    def __init__(self, key: DecodeKey, cap: int, vocab: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        b = key.batch
        self.key = key
        self.tok = torch.zeros((b, 1), **i32)
        self.start_pos = torch.zeros((b,), **i32)
        self.start_upos = torch.zeros((b,), **i32)
        self.i = torch.zeros((), **i32)
        self.out = torch.zeros((b, cap), **i32)
        self.overrides = torch.zeros((cap, b), **i32) if key.use_overrides else None
        self.logits = (torch.zeros((b, vocab), dtype=torch.float32, device=device)
                       if key.return_logits else None)
        self.warm = False  # the first step ran eagerly on the capture stream
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}  # kernel launches one replay makes
        self.collectives: dict = {}  # counted collectives one replay makes
        self.collective_bytes: dict = {}  # and the bytes they are handed
        self.capture_s = 0.0


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
        mesh=None,
    ):
        """``mesh``: a ``parallel.Mesh``; ``params`` are then the GLOBAL
        parameters (on any device), quantized globally and sliced for this
        rank, slice by slice onto its device, or the rank's slices already
        (a ``RankParams``, as ``from_pretrained`` loads them under a mesh),
        which are placed as they are. ``device`` None is the mesh's device,
        else the card."""
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        rank_params = isinstance(params, RankParams)
        if rank_params and (mesh is None or params.plan != shard_plan(config, mesh)):
            raise ValueError(f"params are a rank's slices for {params.plan}, not for this "
                             f"engine's mesh {None if mesh is None else mesh.shape}")
        if quantization is not None:
            from hydragen_torch.ops.quant import (
                Quantized4Tensor,
                QuantizedTensor,
                quantize_params,
            )

            assert quantization in ("int8", "w8a8", "int4", "w4a8", "mixed"), (
                f"unknown quantization {quantization!r}")
            bits = 4 if quantization in ("int4", "w4a8") else 8
            want = Quantized4Tensor if bits == 4 else QuantizedTensor
            if not isinstance(params["layers"]["wq"], want):
                assert not is_quantized_params(params), (
                    f"params already quantized at a different width than {quantization!r}")
                assert not rank_params, "a rank's slices are quantized by their loader"
                # "mixed": int8 weights with an int4 ``down`` (the K-heavy
                # projection).
                params = quantize_params(
                    params, bits=bits, pad_mlp=quantization in ("w8a8", "w4a8", "mixed"),
                    bits4_families=("down",) if quantization == "mixed" else (),
                )
        self.config = config
        self.mesh = None
        self.load_stats: dict = {}  # from_pretrained's load seconds and host bytes
        # Tokens each prefill was given (rows x width) and computed (rows x the
        # width after bucket padding; this rank's rows under dp), summed.
        self.stats = dict.fromkeys(
            ("shared_tokens", "shared_tokens_run", "unique_tokens", "unique_tokens_run"), 0)
        if mesh is not None and not rank_params:
            params = shard_params(params, config, mesh, self.device)
        self.params = _params_to(params, self.device)
        self.impl = impl
        # "w8a8"/"w4a8": activations quantized per row and products on the s8
        # GEMMs ("mixed" runs w8a8, whose int4 family goes to w4a8).
        self.matmul_impl = (
            "w8a8" if quantization == "mixed"
            else quantization if quantization in ("w8a8", "w4a8") else "dq"
        )
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
        # Set by generate(disable_hydragen=True) for the call's duration.
        self._disable_hydragen = False
        # generate's sampler, re-seeded by each call: one generator, so the
        # graphs that sample can register it before capture.
        self._generator = torch.Generator(device=self.device)
        # Decode graphs by DecodeKey (static buffers alone on the CPU or
        # with graph(False)), one memory pool and one capture stream for all.
        # A graph lives only as long as its cache and the parameters it was
        # captured over: setup_caches and a change of params drop them all.
        self._use_graphs = self.device.type == "cuda"
        self._decode: dict = {}
        self._decode_params = None
        self._graph_pool = None
        self._graph_stream = None
        if mesh is not None:
            self._set_mesh(mesh)

    # -- meshes ----------------------------------------------------------------

    def _set_mesh(self, mesh) -> None:
        self.mesh = mesh
        self._drop_graphs()
        self._use_graphs = self._use_graphs and mesh.graphs_ok

    def shard(self, mesh) -> "HydragenLlama":
        """Keep this rank's slices of the (global) parameters and of the
        cache, if allocated, and run over ``mesh`` from now on."""
        assert self.mesh is None, "the engine is sharded already"
        if self.cache is not None and self.cache.unique_bits == 4:
            raise NotImplementedError(INT4_CACHE_WAITS)
        self.params = shard_params(self.params, self.config, mesh, self.device)
        if self.cache is not None:
            self.cache = shard_cache(self.cache, self.config, mesh)
        self._set_mesh(mesh)
        return self

    @property
    def graphs_enabled(self) -> bool:
        """Whether decode runs through captured CUDA graphs (off on the CPU,
        after ``graph(False)``, and under a gloo mesh)."""
        return self._use_graphs

    def _dp(self) -> tuple:
        """(dp ranks, this rank's dp index), (1, 0) without a dp split."""
        if self.mesh is None or not self.mesh.active("dp"):
            return 1, 0
        return self.mesh.size("dp"), self.mesh.index("dp")

    def _dp_rows(self, total: int) -> tuple:
        """(first row, rows) of this rank's share of a ``total``-row batch."""
        dp, i = self._dp()
        if total % dp:
            raise ValueError(f"a batch of {total} rows must divide over dp={dp}")
        return i * (total // dp), total // dp

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path, dtype: str = "bfloat16", **kw) -> "HydragenLlama":
        """An engine over a local HF Llama checkpoint directory
        (``models/hf.py:from_pretrained``). ``quantization`` goes to the
        conversion, which quantizes on the host, so bf16 originals never
        occupy device memory (f32 int8 scales, no MLP padding), and then to
        the engine, which finds the weights quantized. The device is checked
        before the checkpoint is read. With ``mesh``, each rank reads the
        checkpoint layer by layer, quantizes each layer whole and keeps only
        its slice, so a rank's host holds its own slices and one layer's
        transient, never the whole model; the engine places the slices as
        they are. ``load_stats`` of the engine: ``load_s`` (this call) and
        ``host_param_bytes`` (what the conversion allocated to keep)."""
        from hydragen_torch.models import hf

        mesh = kw.get("mesh")
        resolve_device(kw.get("device", None if mesh is None else mesh.device))
        stats: dict = {}
        t = time.perf_counter()
        cfg, params = hf.from_pretrained(path, dtype=dtype, quantization=kw.get("quantization"),
                                         mesh=mesh, stats=stats)
        eng = cls(cfg, params, **kw)
        stats["load_s"] = time.perf_counter() - t
        eng.load_stats = stats
        return eng

    @classmethod
    def from_pretrained_tp(cls, path, tp: int = 0, dp: int = 1, dtype: str = "bfloat16",
                           **kw) -> "HydragenLlama":
        """Load over a ``(dp, tp)`` mesh in one call, on every rank of an
        initialised default group (``torchrun`` or ``parallel.launch``):
        ``tp`` 0 takes the world size over ``dp``. ``device`` goes to the
        mesh (None: this rank's card)."""
        import torch.distributed as dist

        from hydragen_torch.parallel import make_mesh

        if tp <= 0:
            tp = dist.get_world_size() // dp
        mesh = make_mesh(tp=tp, dp=dp, device=kw.pop("device", None))
        return cls.from_pretrained(path, dtype=dtype, mesh=mesh, **kw)

    @classmethod
    def from_hf_model(cls, hf_model, dtype: str = "bfloat16", **kw) -> "HydragenLlama":
        """An engine over an in-memory transformers ``LlamaForCausalLM``. It
        converts unquantized; ``quantization`` goes to the engine, which runs
        ``quantize_params`` (bf16 scales, the MLP padded under w8a8 and
        w4a8)."""
        from hydragen_torch.models import hf

        cfg, params = hf.from_hf_model(hf_model, dtype=dtype)
        return cls(cfg, params, **kw)

    def graph(self, enabled: bool = True) -> "HydragenLlama":
        """Decode through captured CUDA graphs (the default on the card, as
        the JAX engine always runs its compiled scan), or with ``enabled=
        False`` through the eager loop over the same step body. On the CPU
        the loop is eager. Under a gloo mesh ``enabled`` raises: gloo's
        collectives go through the host and cannot be captured. Returns
        ``self`` (the JAX engine's shim sits at the same place in the
        API)."""
        if enabled and self.mesh is not None and not self.mesh.graphs_ok:
            raise RuntimeError(f"decode graphs need NCCL collectives; this mesh runs "
                               f"{self.mesh.backend}, so decode runs eagerly")
        self._use_graphs = enabled and self.device.type == "cuda"
        return self

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
        int8 with per-(token, head) f32 scales; ``"int4"`` nibble-packs the
        UNIQUE cache along the token axis (``quantize_kv4``).
        ``shared_kv_quant`` "follow" (levels match kv_quant; int8 under
        int4), "none" or "int8"."""
        assert kv_quant in (None, "int8", "int4"), f"unknown kv_quant {kv_quant!r}"
        assert shared_kv_quant in ("follow", "none", "int8")
        # A graph replayed over a freed cache would write freed memory.
        self._drop_graphs()
        if shared_kv_quant == "follow":
            shared_quantized = True if kv_quant == "int4" else None
        else:
            shared_quantized = shared_kv_quant == "int8"
        cfg = self.config
        max_unique_seq_length = -(-max_unique_seq_length // 16) * 16
        dtype = cache_dtype or cfg.torch_dtype
        quantized = kv_quant in ("int8", "int4")
        nkv, B, level_lens = cfg.num_key_value_heads, max_unique_batch_size, None
        if self.mesh is not None:
            if kv_quant == "int4":
                raise NotImplementedError(INT4_CACHE_WAITS)
            # Local rows, heads and level slices; the layout from the global heads.
            local = cache_pspecs(cfg, self.mesh, B, list(max_shared_seq_lengths), quantized,
                                 dtype, unique_bshd)
            nkv, B, level_lens = local.num_kv_heads, local.unique_batch, local.level_lens
            unique_bshd = local.unique_bshd
        self.cache = allocate_cache(
            cfg.num_hidden_layers, B, max_unique_seq_length,
            list(max_shared_batch_sizes), list(level_lens or max_shared_seq_lengths),
            nkv, cfg.head_dim, dtype=dtype, quantized=quantized,
            unique_bshd=unique_bshd, shared_quantized=shared_quantized,
            unique_bits=4 if kv_quant == "int4" else 8, device=self.device,
        )
        if self.mesh is not None:
            sp, spi = self.mesh.size("sp"), self.mesh.index("sp")
            self.cache.shared = tuple(
                lv._replace(seq_shards=sp, seq_shard=spi) if split else lv
                for lv, split in zip(self.cache.shared, local.level_split))
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

    def _spec(self, mode: str, unique_history: bool, rows=()) -> ForwardSpec:
        return ForwardSpec(
            mode=mode,
            num_used_levels=self.num_used_levels,
            level_filled=tuple(self.level_filled),
            unique_history=unique_history,
            unique_filled=self.cache.max_unique_seq_len if unique_history else 0,
            disable_hydragen=self._disable_hydragen,
            disable_attention=self._disable_attention,
            impl=self.impl,
            matmul=self.matmul_impl,
            level_batch=tuple(self.level_batch),
            rows=tuple(rows),
        )

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.int32).to(self.device)

    # -- prefill entry points ------------------------------------------------

    @torch.no_grad()
    def append_shared(self, input_ids, seq_lens=None, full_logits: bool = False):
        """Prefill a new shared level; returns its last-token logits."""
        with span("shared_prefill"):
            assert self.cache is not None, "call setup_caches first"
            assert self.num_used_levels < len(self.cache.shared), "no free shared level"
            input_ids = self._ids(input_ids)
            level = self.cache.shared[self.num_used_levels]
            b, t = input_ids.shape
            assert b <= level.max_batch_size, (
                f"level {self.num_used_levels} allocated for {level.max_batch_size} "
                f"prefixes, got {b}")
            assert t <= level.global_seq_len, (
                f"level {self.num_used_levels} holds {level.global_seq_len} tokens, got {t}")
            if seq_lens is not None:
                seq_lens = self._ids(seq_lens)
            input_ids, seq_lens, padded = _pad_to_bucket(
                input_ids, seq_lens, self.prefill_bucket, level.global_seq_len)
            has_pad = seq_lens is not None
            orig_t, t = t, int(input_ids.shape[1])
            self.stats["shared_tokens"] += b * orig_t
            self.stats["shared_tokens_run"] += b * t
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
            hidden = model_forward(
                self.params, self.config, self.cache, input_ids, pos, local_pos, spec,
                write=KVWrite.level(self.cache, self.num_used_levels, b, t), mesh=self.mesh,
            )
            set_shared_level_buffers(self.cache, self.num_used_levels, seq_lens)
            logits = logits_from_hidden(self.params, self.config, hidden,
                                        seq_lens if has_pad else None, full_logits, mesh=self.mesh)
            self.num_used_levels += 1
            self.level_filled.append(t)
            self.level_batch.append(b)
            if full_logits and padded:
                logits = logits[:, :orig_t]
            return logits

    @torch.no_grad()
    def process_unique(self, input_ids, seq_lens=None):
        """Prefill per-sequence suffixes into the unique cache. Under a mesh
        whose dp splits the rows, this rank prefills its share of the rows
        and the logits of every row come back, gathered over dp."""
        assert self.cache is not None
        return self._prefill_unique(self._ids(input_ids),
                                    None if seq_lens is None else self._ids(seq_lens), 1)

    def _prefill_unique(self, input_ids, seq_lens, samples: int, width: Optional[int] = None):
        """Prefill the suffixes ``input_ids`` into unique rows ``[0, b *
        samples)`` of the global batch, suffix ``i`` into rows ``[i * samples,
        (i + 1) * samples)``; returns the suffixes' last-token logits ``[b,
        1, V]``. Under dp this rank prefills the suffixes its rows read,
        places its rows, and gathers every row's logits over dp. ``width``:
        the suffixes' width as given, before bucket padding (default the
        width of ``input_ids``)."""
        with span("unique_prefill"):
            b, t = input_ids.shape
            dp, _ = self._dp()
            if dp == 1:
                self._count_unique(b, width or t, t)
                # Not expand_unique_rows: this copy's transient is one layer's
                # source rows, not one layer's repeated rows.
                logits = self._unique_forward(input_ids, seq_lens)
                if samples > 1:
                    repeat_unique_for_samples(self.cache, b, samples)
                return logits
            r0, n = self._dp_rows(b * samples)
            s0, s1 = r0 // samples, -(-(r0 + n) // samples)
            self._count_unique(s1 - s0, width or t, t)
            logits = self._unique_forward(input_ids[s0:s1],
                                          None if seq_lens is None else seq_lens[s0:s1],
                                          rows=(s0, b))
            index = (r0 + torch.arange(n, device=self.device)) // samples - s0
            if samples > 1 or s1 - s0 != n:
                expand_unique_rows(self.cache, s1 - s0, index)
            rows = mesh_lib.all_gather(logits.index_select(0, index), self.mesh, "dp", dim=0)
            return rows[::samples]

    def _count_unique(self, rows: int, given: int, run: int) -> None:
        self.stats["unique_tokens"] += rows * given
        self.stats["unique_tokens_run"] += rows * run

    def _unique_forward(self, input_ids, seq_lens, rows=()):
        """The unique prefill of ``input_ids`` (this rank's suffixes, rows
        ``rows`` of the global suffix batch) into unique rows ``[0, b)``."""
        has_pad = seq_lens is not None
        b, t = input_ids.shape
        nohydra = self._disable_hydragen
        spec = self._spec("unique_prefill",
                          unique_history=nohydra and self.num_used_levels > 0, rows=rows)
        # Each row's shared length, from the global suffix batch under dp.
        shared_lens = shared_len_for_batch(self.cache, spec.num_used_levels,
                                           rows[1] if rows else b, spec.level_batch or None)
        if rows:
            shared_lens = shared_lens[rows[0]:rows[0] + b]
        ar = torch.arange(t, device=self.device, dtype=torch.int32)[None, :]
        pos = shared_lens[:, None] + ar
        # No sharing: the prefix was copied to the front of each unique row,
        # so unique positions are global and the copy is attention history.
        unique_pos = pos if nohydra else ar.expand(b, t)
        # Each layer writes its KV into the unique rows. All rows share one
        # prefix length (generate allows one prefix), so the suffixes are one
        # block after the copied prefix.
        start = int(shared_lens[0]) if nohydra and b else 0
        hidden = model_forward(
            self.params, self.config, self.cache, input_ids, pos, unique_pos, spec,
            history_lens=shared_lens if nohydra else None,
            write=KVWrite.block(self.cache, b, t, start), mesh=self.mesh,
        )
        return logits_from_hidden(self.params, self.config, hidden,
                                  seq_lens if has_pad else None, mesh=self.mesh)

    # -- generation ------------------------------------------------------------

    def _drop_graphs(self) -> None:
        """Drop every decode graph and its buffers; the next capture takes a
        new pool."""
        self._decode.clear()
        self._graph_pool = None
        self._decode_params = None

    def _graph_state(self, key, make):
        """The graph holder of ``key`` (a ``DecodeStep``, or a continuous
        batcher's chunk step), made by ``make()`` where there is none. New
        parameters drop every graph first: a graph reads the parameters it
        was captured over (held here until then) by address."""
        if self._decode_params is not self.params:
            self._drop_graphs()
            self._decode_params = self.params
        st = self._decode.get(key)
        if st is None:
            st = make()
            self._decode[key] = st
        return st

    def _decode_state(self, key: DecodeKey) -> DecodeStep:
        """The static buffers (and graph) of ``key``."""
        return self._graph_state(key, lambda: DecodeStep(
            key, self.cache.max_unique_seq_len, self.config.vocab_size, self.device))

    def _step_body(self, st: DecodeStep) -> None:
        """One decode step (``hydragen_tpu/core/engine.py:_decode_steps``'s
        scan body) over ``st``'s buffers: no host value, no host sync."""
        key = st.key
        spec = key.spec
        pos = st.start_pos + st.i
        upos = st.start_upos + st.i
        # The step's own slot is outside its history (``history_lens``).
        write = KVWrite.rows(self.cache, upos) if key.per_row \
            else KVWrite.slot(self.cache, key.batch, upos[0])
        hidden = model_forward(
            self.params, self.config, self.cache, st.tok, pos[:, None], upos[:, None],
            spec, history_lens=upos, write=write, mesh=self.mesh,
        )
        logits = logits_from_hidden(self.params, self.config, hidden, mesh=self.mesh)[:, 0]
        nxt = self._sample_rows(logits, spec, key.temperature, key.top_p)
        col = st.i.long().reshape(1)
        st.out.index_copy_(1, col, nxt)
        if st.logits is not None:
            st.logits.copy_(logits)
        st.tok.copy_(nxt if st.overrides is None else st.overrides.index_select(0, col).T)
        st.i.add_(1)

    def _sample_rows(self, logits: torch.Tensor, spec: ForwardSpec, temperature: float,
                     top_p: Optional[float]) -> torch.Tensor:
        """``[b, 1]`` tokens of this rank's rows from their ``logits [b, V]``.
        Where a dp split samples (``spec.rows``, temperature above 0), every
        rank draws for every row of the batch from the one generator state,
        the logits gathered over dp, and keeps its own rows: the draws of the
        meshless engine."""
        if temperature > 0 and spec.rows:
            r0, b = spec.rows[0], logits.shape[0]
            logits = mesh_lib.all_gather(logits, self.mesh, "dp", dim=0)
            return sample_from_logits(logits, self._generator, temperature, top_p,
                                      1)[r0:r0 + b]
        return sample_from_logits(logits, self._generator, temperature, top_p, 1)

    def _capture(self, st, body) -> None:
        """Capture ``body()``, ``st``'s step, into a CUDA graph (its first
        step has run eagerly on the capture stream, so every lazily made
        thing exists: kernel attributes, tensor maps, workspaces, handles).
        Its launches are recorded, not counted, and a failed capture raises."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if st.key.temperature > 0:
            graph.register_generator_state(self._generator)
        t0 = time.perf_counter()
        launches: dict = {}
        collectives: dict = {}
        nbytes: dict = {}
        # Under a mesh, PyTorch's NCCL watchdog thread queries the events of
        # earlier collectives while this thread captures: "thread_local"
        # lets it (the default, "global", would invalidate the capture).
        mode = "global" if self.mesh is None else "thread_local"
        try:
            with span("capture"), cuda_lib.captured_launches(launches), \
                    mesh_lib.captured_collectives(collectives, nbytes), torch.cuda.graph(
                        graph, pool=self._graph_pool, stream=self._graph_stream,
                        capture_error_mode=mode):
                body()
        except RuntimeError as e:
            raise RuntimeError(f"decode step capture failed for {st.key}: {e}") from e
        st.capture_s = time.perf_counter() - t0
        st.graph, st.launches, st.collectives = graph, launches, collectives
        st.collective_bytes = nbytes

    def _decode_steps(self, st, steps: int, body=None) -> list:
        """``steps`` decode steps over ``st``: replays of its graph (the first
        step of a new key runs eagerly on the capture stream, and the second
        captures), or the step body eagerly. ``body`` is the step (``st``'s
        ``_step_body`` by default). Returns each step's logits (clones
        enqueued after the step, where ``st.logits`` is kept)."""
        if body is None:
            body = lambda: self._step_body(st)  # noqa: E731
        logits = []
        for _ in range(steps):
            with span("decode_step"):
                if not self._use_graphs:
                    body()
                elif st.graph is None and not st.warm:
                    if self._graph_stream is None:
                        self._graph_stream = torch.cuda.Stream(self.device)
                    side = self._graph_stream
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        body()
                    torch.cuda.current_stream(self.device).wait_stream(side)
                    st.warm = True
                else:
                    if st.graph is None:
                        self._capture(st, body)
                    st.graph.replay()
                    cuda_lib.add_launches(st.launches)
                    mesh_lib.add_collectives(st.collectives, st.collective_bytes)
                if st.logits is not None:
                    logits.append(st.logits.clone())
        return logits

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
        disable_hydragen: bool = False,
        disable_attention: bool = False,
        disable_hierarchy: bool = False,
        token_overrides=None,
        seed: int = 0,
    ):
        """Generate ``max_new_tokens`` per sequence.

        ``input_ids``: a list of levels (each ``[b_i, t_i]``), the last one the
        per-sequence suffixes unless ``num_return_sequences > 1``, in which
        case every given level is shared and the samples are the unique rows.
        Returns tokens ``[b, T]`` int32 (and the per-step logits when
        ``return_logits``).

        ``disable_hydragen``: the no-sharing baseline. Exactly two levels in
        all (kept, given and the samples' level), the first of one prefix.
        The last given input is the unique rows' prefill, a level in use is
        copied into the front of every unique row (``copy_shared_to_unique``)
        and attention reads each row's whole history from the unique cache.
        Refused with int4 unique KV.

        ``disable_hierarchy``: the no-hierarchy ablation. Exactly three
        levels in all and ``num_return_sequences > 1``: the last given level
        goes to the unique cache and is repeated for the samples, in place of
        a shared level of its own.

        Under a mesh every rank passes the same global inputs and gets the
        whole batch back; under dp it decodes its share of the rows (the
        batch must divide over dp). ``disable_hydragen`` copies the level
        into the rank's rows and kv heads, its sp slices gathered first."""
        with span("generate"):
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
            total_levels = og_levels + len(input_ids) + (1 if num_return_sequences > 1 else 0)
            if disable_hydragen:
                assert total_levels == 2, "disable_hydragen supports exactly 2 levels"
                if input_ids and (num_return_sequences > 1 or len(input_ids) == 2):
                    assert input_ids[0].shape[0] == 1
            if disable_hierarchy:
                assert total_levels == 3 and num_return_sequences > 1, (
                    "disable_hierarchy needs exactly 3 levels and num_return_sequences > 1")

            if seq_lens is None:
                seq_lens = [None] * len(input_ids)
            elif isinstance(seq_lens, (np.ndarray, torch.Tensor)):
                seq_lens = [seq_lens]
            if input_ids:
                total_batch = int(input_ids[-1].shape[0]) * num_return_sequences
            else:
                total_batch = int(starting_logits.shape[0]) * num_return_sequences
            # This rank's rows of the batch (all of them without a dp split).
            r0, b_loc = self._dp_rows(total_batch)
            rows = slice(r0, r0 + b_loc)

            if num_return_sequences > 1 and not (disable_hierarchy or disable_hydragen):
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

            if disable_hydragen:
                if self.cache.unique_bits == 4:
                    raise ValueError(
                        "disable_hydragen is unsupported with kv_quant='int4': the copied "
                        "prefix would need nibble packs at an offset (run the baseline with "
                        "kv_quant='int8')")
                self._disable_hydragen = True
                if self.num_used_levels > 0:
                    level = self.cache.shared[0]
                    if self.mesh is not None:
                        level = gather_level(level, self.mesh)
                    copy_shared_to_unique(self.cache, total_batch, self.level_batch[0],
                                          rows=(r0, b_loc), level=level)

            suffix_lens_np = None if suffix_lens is None else np.asarray(
                suffix_lens.cpu() if torch.is_tensor(suffix_lens) else suffix_lens)
            suffix_uniform = suffix_lens_np is None or bool(
                np.all(suffix_lens_np == suffix_lens_np.flat[0]))
            if suffix_ids is not None:
                # No bucketing under no sharing: the suffix block lands after the
                # copied prefix, and a padded width could overflow the row.
                width = int(suffix_ids.shape[1])
                suffix_ids, suffix_lens, _ = _pad_to_bucket(
                    suffix_ids, None if suffix_lens is None else self._ids(suffix_lens),
                    0 if disable_hydragen else self.prefill_bucket,
                    self.cache.max_unique_seq_len,
                )
                starting_logits = self._prefill_unique(suffix_ids, suffix_lens,
                                                       num_return_sequences, width)

            with span("first_token"):
                self._generator.manual_seed(seed)
                prefill_logits = starting_logits[:, -1]
                first_token = sample_from_logits(
                    prefill_logits, self._generator, temperature, top_p, num_return_sequences
                ).reshape(-1, 1)
                logits_out = None
                if return_logits:
                    logits_out = [prefill_logits.repeat_interleave(num_return_sequences, dim=0)]

                start_pos = self.get_shared_cache_len(total_batch)[rows]
                # Every row decodes at one unique slot (a step writes it once, the
                # JAX engine's uniform_pos) unless the suffixes are ragged.
                uniform = suffix_uniform
                if suffix_ids is not None:
                    if suffix_lens is not None:
                        sl = suffix_lens.to(self.device, torch.int32)
                    else:
                        sl = torch.full((suffix_ids.shape[0],), int(suffix_ids.shape[1]),
                                        dtype=torch.int32, device=self.device)
                    sl = sl.repeat_interleave(num_return_sequences)[rows]
                    start_pos = start_pos + sl
                    start_unique_pos = sl
                else:
                    start_unique_pos = torch.zeros((b_loc,), dtype=torch.int32, device=self.device)
                if disable_hydragen:
                    # Unique positions are global; the slot is uniform when every
                    # row's history has one length (checked on the host, once).
                    start_unique_pos = start_pos.to(torch.int32)
                    sp = start_unique_pos.cpu()
                    uniform = bool(len(sp) and suffix_uniform and bool((sp == sp[0]).all()))

                use_overrides = token_overrides is not None
                if use_overrides:
                    token_overrides = self._ids(token_overrides)[rows]
                first_token = first_token[rows]
                dp, _ = self._dp()

                steps = max_new_tokens - 1
                tokens = first_token
                if steps > 0:
                    # Every step's slot is checked here, once: the steps compute
                    # theirs on the device.
                    top = int(start_unique_pos.max()) + steps
                    if top > self.cache.max_unique_seq_len:
                        raise ValueError(
                            f"{steps} decode steps reach unique position {top}, past the unique "
                            f"cache's {self.cache.max_unique_seq_len} (setup_caches)")
                    spec = self._spec("decode", unique_history=True,
                                      rows=(r0, total_batch) if dp > 1 else ())
                    st = self._decode_state(DecodeKey(spec, b_loc, float(temperature), top_p,
                                                      use_overrides, return_logits,
                                                      not uniform))
                    st.tok.copy_(token_overrides[:, 0:1] if use_overrides else first_token)
                    st.start_pos.copy_(start_pos)
                    st.start_upos.copy_(start_unique_pos)
                    st.i.zero_()
                    if use_overrides:
                        st.overrides[:steps].copy_(token_overrides[:, 1:max_new_tokens].T)
                    # With stops active, decode in chunks with a host check between,
                    # so a batch that finishes early skips the rest of the budget.
                    stops_active = ((eos_token_id is not None or stop_sequences)
                                    and not use_overrides)
                    chunk = self.eos_chunk if stops_active else 0
                    if not chunk or chunk >= steps:
                        plan = [steps]
                    else:
                        plan = ([chunk] * (steps // chunk)
                                + ([steps % chunk] if steps % chunk else []))
                    tok_chunks = [first_token]
                    done = 0
                    fin_rows = None
                    max_l = max((len(s) for s in stop_sequences), default=1)
                    tail = first_token.cpu().numpy()
            if steps > 0:
                with span("decode"):
                    for c in plan:
                        step_logits = self._decode_steps(st, c)
                        toks = st.out[:, done:done + c].clone()
                        done += c
                        tok_chunks.append(toks)
                        if return_logits:
                            logits_out.extend(step_logits)
                        if stops_active and len(plan) > 1:
                            window = np.concatenate([tail, toks.cpu().numpy()], axis=1)
                            hit = _finished_mask(window, eos_token_id, stop_sequences)[:, -1]
                            fin_rows = hit if fin_rows is None else (fin_rows | hit)
                            if self._all_finished(bool(fin_rows.all())):
                                break
                            tail = window[:, window.shape[1] - (max_l - 1):] if max_l > 1 \
                                else window[:, :0]
                    tokens = torch.cat(tok_chunks, dim=1)
            if dp > 1:
                tokens = mesh_lib.all_gather(tokens, self.mesh, "dp", dim=0)
                if return_logits and len(logits_out) > 1:
                    steps_all = mesh_lib.all_gather(torch.stack(logits_out[1:]), self.mesh, "dp",
                                                    dim=1)
                    logits_out = logits_out[:1] + list(steps_all.unbind(0))

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
            if disable_hydragen:
                self._disable_hydragen = False
            if disable_attention:
                self._disable_attention = False
            if return_logits:
                return tokens, logits_out
            return tokens

    def _all_finished(self, local: bool) -> bool:
        """Whether every row of the batch has finished: this rank's rows'
        flag, agreed over dp (an all-reduce), so that every rank leaves the
        decode loop at the same step."""
        if self._dp()[0] == 1:
            return local
        flag = torch.tensor([0 if local else 1], dtype=torch.int32, device=self.device)
        return int(mesh_lib.all_reduce(flag, "max", self.mesh, "dp")) == 0
