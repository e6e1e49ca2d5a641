"""K9 (``ops/rope.py``, ``csrc/rope.cu``): a layer's RoPE and its int8 KV
write in one pass.

On the CPU: the plain version against the chain it replaces, written out
here (``apply_rope``, ``quantize_kv`` and each destination's write as the
model made it), bit for bit, at every destination; the unique-prefill write
path against the stacked write it replaces; and which forwards a generate
call routes through K9 under each cache. Marked ``gpu`` (skipped without a
card): the kernel against its plain version at the cells' head counts and
shapes, its device slot inside a captured graph, and what it refuses; on
the card with ``python -m pytest tests/test_torch_rope.py -m gpu
--noconftest``.
"""

import dataclasses

import pytest
import torch

from hydragen_torch import HydragenLlama
from hydragen_torch.core import cache as tcache
from hydragen_torch.core import engine as tengine
from hydragen_torch.models.config import ModelConfig
from hydragen_torch.models.llama import ForwardSpec, init_params, model_forward
from hydragen_torch.ops import cuda_lib, rope
from hydragen_torch.ops.quant import quantize_kv

L = 2  # cache layers; the write goes to layer 1


def _bf16(shape, seed, scale=1.0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device=device)).to(torch.bfloat16)


def _tables(b, t, hd, seed, device="cpu"):
    """cos/sin at random positions, as ``rope_cos_sin`` makes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    pos = torch.randint(0, 200_000, (b, t), generator=g, device=device).float()
    inv = 1.0 / (5e6 ** (torch.arange(0, hd, 2, device=device).float() / hd))
    ang = pos[..., None] * inv
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    return cos.to(torch.bfloat16), sin.to(torch.bfloat16)


def _cache(kind, b, nkv, hd, S, device="cpu"):
    """A cache of ``L`` layers holding random codes and scales, so a stray
    or missing write shows: ``level`` (one level of S tokens), ``level_sp``
    (shard 1 of 2 of a level of 2S), ``bhsd`` or ``bshd`` (the unique cache;
    BSHD with flat scales)."""
    c = tcache.allocate_cache(L, b, S, [b], [S], nkv, hd, quantized=True,
                              unique_bshd=kind == "bshd", device=device)
    g = torch.Generator(device=device).manual_seed(99)
    bufs = [c.unique_k, c.unique_v, c.unique_k_scale, c.unique_v_scale,
            *[x for lv in c.shared for x in (lv.k, lv.v, lv.k_scale, lv.v_scale)]]
    for x in bufs:
        if x.dtype == torch.int8:
            x.copy_(torch.randint(-127, 128, x.shape, generator=g, device=device))
        else:
            x.copy_(torch.rand(x.shape, generator=g, device=device))
    if kind == "level_sp":
        c.shared = (c.shared[0]._replace(seq_shards=2, seq_shard=1),)
    return c


def _dest(c, kind, b, t, slot):
    if kind.startswith("level"):
        return tcache.level_kv_dest(c.shared[0], 1, b, t)
    return tcache.unique_kv_dest(c, 1, b, slot, t)


def _chain(c, kind, q, k, v, cos, sin, nh, nkv, hd, slot):
    """What the model ran before K9: ``apply_rope`` on q and k, then the
    destination's own write (the level fill's slices, the unique prefill's
    ``update_unique_prefill``, the decode step's
    ``write_decode_token_layer``)."""
    from hydragen_torch.models.llama import apply_rope

    b, t = q.shape[:2]
    q = apply_rope(q.reshape(b, t, nh, hd).transpose(1, 2), cos, sin)
    k = apply_rope(k.reshape(b, t, nkv, hd).transpose(1, 2), cos, sin)
    v = v.reshape(b, t, nkv, hd).transpose(1, 2)
    if kind.startswith("level"):
        lvl = c.shared[0]
        off = lvl.seq_offset
        n = max(0, min(t, off + lvl.max_seq_len) - off)
        (kq, ks), (vq, vs) = quantize_kv(k[:, :, off:off + n]), quantize_kv(v[:, :, off:off + n])
        lvl.k_scale[1, :b, :, :n] = ks
        lvl.v_scale[1, :b, :, :n] = vs
        lvl.k[1, :b, :, :n] = kq
        lvl.v[1, :b, :, :n] = vq
    elif t == 1:
        tcache.write_decode_token_layer(c, 1, k, v, slot)
    else:  # the stacked write over a cache of layer 1 alone
        one = dataclasses.replace(c, **{f: getattr(c, f)[1:2] for f in (
            "unique_k", "unique_v", "unique_k_scale", "unique_v_scale")})
        tcache.update_unique_prefill(one, k[None], v[None], start=slot)
    return q, k, v


def _caches_equal(a, b):
    pairs = [(a.unique_k, b.unique_k), (a.unique_v, b.unique_v),
             (a.unique_k_scale, b.unique_k_scale), (a.unique_v_scale, b.unique_v_scale)]
    for la, lb in zip(a.shared, b.shared):
        pairs += [(la.k, lb.k), (la.v, lb.v), (la.k_scale, lb.k_scale), (la.v_scale, lb.v_scale)]
    return all((x is None and y is None) or torch.equal(x, y) for x, y in pairs)


# Destinations and the shapes they take: (kind, rows, new tokens, slot).
DESTS = {
    "level": ("level", 2, 24, 0),
    "level_sp_window": ("level_sp", 2, 24, 0),
    "unique_bhsd": ("bhsd", 3, 7, 5),
    "unique_bshd_flat": ("bshd", 3, 7, 5),
    "decode_bhsd_host_slot": ("bhsd", 4, 1, 11),
    "decode_bshd_host_slot": ("bshd", 4, 1, 11),
    "decode_bshd_device_slot": ("bshd", 4, 1, "dev"),
}
HEADS = {"32/4": (32, 4, 128), "32/32": (32, 32, 128), "16/2": (16, 2, 128), "4/2": (4, 2, 32)}


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("dest", list(DESTS))
def test_rope_kv_quant_plain_is_the_chain(dest, heads):
    """The plain version (and the wrapper, which runs it on the CPU) writes
    the cache the chain wrote and returns its q, k and v, bit for bit; the
    scale of the old rows and of the other layer stay as they were."""
    kind, b, t, slot = DESTS[dest]
    nh, nkv, hd = HEADS[heads]
    S = 16
    q, k, v = _bf16((b, t, nh * hd), 0, 2.0), _bf16((b, t, nkv * hd), 1, 2.0), \
        _bf16((b, t, nkv * hd), 2)
    cos, sin = _tables(b, t, hd, 3)
    want_c = _cache(kind, b, nkv, hd, S)
    dev_slot = torch.tensor(9, dtype=torch.int32) if slot == "dev" else None
    s = dev_slot if slot == "dev" else slot
    want = _chain(want_c, kind, q, k, v, cos, sin, nh, nkv, hd, s)
    for fn in (rope.rope_kv_quant_plain, rope.rope_kv_quant):
        c = _cache(kind, b, nkv, hd, S)
        got = fn(q, k, v, cos, sin, _dest(c, kind, b, t, s), nh, nkv, hd)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert _caches_equal(c, want_c)


def test_level_dest_takes_the_ranks_window():
    """Shard 1 of an sp=2 level of 2 x 16 tokens: a 24-token prompt's tokens
    [16, 24) go to the shard's tokens [0, 8); a 12-token prompt writes
    nothing there."""
    c = _cache("level_sp", 2, 2, 32, 16)
    assert tcache.level_kv_dest(c.shared[0], 1, 2, 24).window == (16, 8)
    assert tcache.level_kv_dest(c.shared[0], 1, 2, 12).window == (12, 0)


# --- the unique prefill's write path --------------------------------------------

TINY = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=256)


class _Kept:
    """A write that keeps each layer's new KV and writes nothing."""

    def __init__(self):
        self.k, self.v = [], []

    def bind(self, x, impl, masked):
        return self

    def dest(self, li):
        return None

    def put(self, li, k, v):
        self.k.append(k)
        self.v.append(v)


@pytest.mark.parametrize("kv", ["int8_bhsd", "int8_bshd", "int4", "bf16"])
def test_unique_start_writes_what_the_stacked_write_wrote(kv):
    """``model_forward(write=KVWrite.block(..., start=s))`` writes each
    layer's new KV into the unique rows as it goes (through K9 at int8); it
    leaves the cache bit for bit as the stack of every layer's KV, written
    by ``update_unique_prefill``, did, with the same hidden states."""
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), quantized="w8a8")
    b, t, start = 3, 6, 0 if kv == "int4" else 4
    ids = torch.randint(1, 256, (b, t), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(t)[None].expand(b, t)
    spec = ForwardSpec("unique_prefill", 0, (), False, 0, False, False, matmul="w8a8")

    def fresh():
        return tcache.allocate_cache(2, b, 16, [], [], 2, 32, dtype=torch.bfloat16,
                                     quantized=kv != "bf16", unique_bshd=kv == "int8_bshd",
                                     unique_bits=4 if kv == "int4" else 8)

    old, kept = fresh(), _Kept()
    h_old = model_forward(params, cfg, old, ids, pos, pos, spec, write=kept)
    tcache.update_unique_prefill(old, torch.stack(kept.k), torch.stack(kept.v), start=start)
    new = fresh()
    h_new = model_forward(params, cfg, new, ids, pos, pos, spec,
                          write=tcache.KVWrite.block(new, b, t, start))
    assert torch.equal(h_new, h_old) and _caches_equal(new, old)


# --- where a generate call takes K9 ---------------------------------------------


def _k9_calls(monkeypatch, kv_quant, impl=None):
    """Calls of K9's entry over one generate call (a shared prefill, a
    unique prefill of two suffixes and three decode steps), and the
    forwards it ran."""
    params = init_params(TINY, torch.Generator().manual_seed(0))
    quant = "w4a8" if kv_quant == "int4" else "w8a8"
    eng = HydragenLlama(TINY, params, quantization=quant, impl=impl, device="cpu")
    eng.setup_caches(2, 16, [1], [16], kv_quant=kv_quant)
    calls = {"rope_kv_quant": 0, "forwards": 0}

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rope, "rope_kv_quant", counted("rope_kv_quant", rope.rope_kv_quant))
    monkeypatch.setattr(tengine, "model_forward", counted("forwards", tengine.model_forward))
    g = torch.Generator().manual_seed(2)
    toks = eng.generate(input_ids=[torch.randint(1, 256, (1, 10), generator=g),
                                   torch.randint(1, 256, (2, 4), generator=g)],
                        max_new_tokens=4, temperature=0.0)
    assert tuple(toks.shape) == (2, 4)
    return calls


def test_layer_routes_through_k9(monkeypatch):
    """An int8 level, unique cache and decode slot: every forward of the
    call writes each layer's KV through K9, one call a layer."""
    calls = _k9_calls(monkeypatch, "int8")
    assert calls["forwards"] == 5
    assert calls["rope_kv_quant"] == TINY.num_hidden_layers * calls["forwards"]


@pytest.mark.parametrize("kv_quant,impl,forwards", [
    ("int4", None, 1), (None, None, 0), ("int8", "torch", 0)],
    ids=["int4_unique", "bf16", "impl_torch"])
def test_layer_routes_k9_only_to_int8_caches(monkeypatch, kv_quant, impl, forwards):
    """An int4 unique cache keeps the chain (its int8 level, the shared
    prefill's one forward, takes K9); bf16 caches and ``impl="torch"`` run
    the chain everywhere."""
    calls = _k9_calls(monkeypatch, kv_quant, impl)
    assert calls["forwards"] == 5
    assert calls["rope_kv_quant"] == TINY.num_hidden_layers * forwards


# chip_smoke's gates: (kv_quant, disable_hydragen, its expected launches).
SMOKE_PATHS = {
    "main": ("int8", False, "expected_launches"),
    "int4": ("int4", False, "expected_launches_int4"),
    "no_sharing": ("int8", True, "expected_launches_no_sharing"),
}


@pytest.mark.parametrize("path", list(SMOKE_PATHS))
def test_chip_smoke_counts_k9_as_the_engine_calls_it(monkeypatch, path):
    """``chip_smoke.py``'s launch gates count K9 as the engine calls it, at a
    tiny size on the CPU: the main path's two requests (a prompt with
    samples, then suffixes over the kept prompt), the int4 path's, and the
    no-sharing baseline's one request."""
    import chip_smoke
    from hydragen_torch import SharedCacheOp

    kv_quant, nohydra, gate = SMOKE_PATHS[path]
    params = init_params(TINY, torch.Generator().manual_seed(0))
    eng = HydragenLlama(TINY, params, quantization="w4a8" if kv_quant == "int4" else "w8a8",
                        device="cpu")
    T, rows = 3, 2
    eng.setup_caches(rows, 8 + T + (16 if nohydra else 0), [1], [16], kv_quant=kv_quant)
    calls = []
    monkeypatch.setattr(rope, "rope_kv_quant",
                        lambda *a, **kw: calls.append(1) or rope.rope_kv_quant_plain(*a, **kw))
    g = torch.Generator().manual_seed(3)
    eng.generate(input_ids=[torch.randint(1, 256, (1, 16), generator=g)],
                 num_return_sequences=rows, max_new_tokens=T, temperature=0.0,
                 shared_cache_op=SharedCacheOp.WIPE, disable_hydragen=nohydra)
    if not nohydra:
        eng.generate(input_ids=[torch.randint(1, 256, (rows, 8), generator=g)],
                     max_new_tokens=T, temperature=0.0, shared_cache_op=SharedCacheOp.PRESERVE)
    want = getattr(chip_smoke, gate)(TINY.num_hidden_layers, T)
    assert len(calls) == want["rope_kv_quant"]


def test_threads_cover_the_heads():
    assert rope.threads_for(32, 32, 128) == 256
    assert rope.threads_for(32, 4, 128) == 256
    assert rope.threads_for(4, 2, 128) == 128
    assert rope.threads_for(1, 1, 128) == 64


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K9 has no CPU mode")
    return torch.device("cuda")


# (rows, new tokens, destinations): a decode step of 256 rows, the docs
# cell's 128 rows x 512 tokens, a 32,768-token prompt into a level.
GPU_SHAPES = {
    "decode": (256, 1, ("bhsd", "bshd")),
    "docs": (128, 512, ("bhsd", "bshd")),
    "prompt": (1, 32768, ("level", "level_sp")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("heads", ["32/4", "32/32", "16/2"])
@pytest.mark.parametrize("shape", list(GPU_SHAPES))
def test_k9_matches_plain(dev, shape, heads):
    """K9 against its plain version at the cells' head counts (Yi, DeepSeek,
    a tp=4 rank of the 67B) and shapes: the rotated q, k and v, and every
    byte of the cache (codes, scales, the rows and layers it must not
    touch), bit for bit; one launch a call. A decode step writes at a host
    slot and at a device one."""
    b, t, kinds = GPU_SHAPES[shape]
    nh, nkv, hd = HEADS[heads]
    S = t if t > 1 else 64
    q, k, v = (_bf16((b, t, w), i, 2.0, dev) for i, w in enumerate((nh * hd, nkv * hd, nkv * hd)))
    cos, sin = _tables(b, t, hd, 3, dev)
    slots = (0,) if t > 1 else (37, torch.tensor(41, dtype=torch.int32, device=dev))
    for kind in kinds:
        for slot in slots:
            want_c, c = _cache(kind, b, nkv, hd, S, dev), _cache(kind, b, nkv, hd, S, dev)
            want = rope.rope_kv_quant_plain(q, k, v, cos, sin, _dest(want_c, kind, b, t, slot),
                                            nh, nkv, hd)
            before = cuda_lib.LAUNCHES["rope_kv_quant"]
            got = rope.rope_kv_quant(q, k, v, cos, sin, _dest(c, kind, b, t, slot), nh, nkv, hd)
            torch.cuda.synchronize()
            assert cuda_lib.LAUNCHES["rope_kv_quant"] == before + 1
            assert all(x.is_contiguous() and torch.equal(x, y) for x, y in zip(got, want)), kind
            assert _caches_equal(c, want_c), (kind, slot)
            del want_c, c, want, got


@pytest.mark.gpu
def test_k9_device_slot_advances_in_a_graph(dev):
    """Captured once with its slot in device memory, each replay writes the
    slot the step before it advanced to, as the plain version does."""
    b, nh, nkv, hd, S = 8, 32, 32, 128, 16
    c, want_c = _cache("bshd", b, nkv, hd, S, dev), _cache("bshd", b, nkv, hd, S, dev)
    slot = torch.tensor(3, dtype=torch.int32, device=dev)
    q, k, v = (_bf16((b, 1, w), i, 2.0, dev) for i, w in enumerate((nh * hd, nkv * hd, nkv * hd)))
    cos, sin = _tables(b, 1, hd, 4, dev)
    dest = _dest(c, "bshd", b, 1, slot)
    rope.rope_kv_quant(q, k, v, cos, sin, dest, nh, nkv, hd)  # warm-up: writes slot 3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rope.rope_kv_quant(q, k, v, cos, sin, dest, nh, nkv, hd)
    for s in (3, 4, 5, 6):
        rope.rope_kv_quant_plain(q, k, v, cos, sin, _dest(want_c, "bshd", b, 1, s), nh, nkv, hd)
    for _ in range(3):
        slot.add_(1)
        graph.replay()
    torch.cuda.synchronize()
    assert int(slot) == 6 and _caches_equal(c, want_c)


@pytest.mark.gpu
def test_k9_refuses_what_it_does_not_take(dev):
    b, t, nh, nkv, hd = 2, 4, 4, 2, 128
    c = _cache("bhsd", b, nkv, hd, 16, dev)
    dest = _dest(c, "bhsd", b, t, 0)
    q, k, v = (_bf16((b, t, w), i, 1.0, dev) for i, w in enumerate((nh * hd, nkv * hd, nkv * hd)))
    cos, sin = _tables(b, t, hd, 5, dev)
    bad = {
        "f16": (q.half(), k.half(), v.half(), cos.half(), sin.half(), dest, hd),
        "head_dim": (q, k, v, cos, sin, dest, 96),
        "rows_apart": (q.transpose(0, 1).contiguous().transpose(0, 1), k, v, cos, sin, dest, hd),
        "columns_apart": (torch.stack([q, q], -1)[..., 0], k, v, cos, sin, dest, hd),
        "cos_shape": (q, k, v, cos[:, :1], sin, dest, hd),
        "dest_dtype": (q, k, v, cos, sin, dest._replace(k=dest.k.float()), hd),
        "dest_strides": (q, k, v, cos, sin,
                         dest._replace(v=dest.v.transpose(1, 2).contiguous().transpose(1, 2)), hd),
        "window": (q, k, v, cos, sin, dest._replace(window=(2, 4)), hd),
        "slot": (q, k, v, cos, sin, dest._replace(slot=14), hd),
        "slot_dtype": (q, k, v, cos, sin, dest._replace(slot=torch.tensor(0, device=dev)), hd),
    }
    for name, (qq, kk, vv, cc, ss, dd, d) in bad.items():
        with pytest.raises(ValueError):
            rope.rope_kv_quant(qq, kk, vv, cc, ss, dd, nh, nkv, d)
