"""The port's own spans and prefill counters, on a tiny model on the CPU.

Under ``torch.profiler`` a ``generate`` call records ``hg.generate`` with
one ``hg.shared_prefill`` and one ``hg.unique_prefill`` inside it, each
holding the stage spans of every layer, then ``hg.first_token`` and
``hg.decode`` with one ``hg.decode_step`` a step. With no profiler the span
helper enters nothing. ``HydragenLlama.stats`` counts the tokens each
prefill was given and computed, the bucket padding in the second.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
from hydragen_torch.core.engine import _pad_to_bucket
from hydragen_torch.models.llama import init_params
from hydragen_torch.utils import profiling
from hydragen_torch.utils.profiling import SPAN_PREFIX, span

L = 2
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=L,
           num_attention_heads=4, num_key_value_heads=2, dtype="float32")
NEW = 6


@pytest.fixture(scope="module")
def params():
    return init_params(ModelConfig(**CFG), torch.Generator().manual_seed(0))


def _engine(params, bucket=128, kv_quant="int8"):
    eng = HydragenLlama(ModelConfig(**CFG), params, quantization="w8a8", prefill_bucket=bucket,
                        device="cpu")
    eng.setup_caches(4, 32, [1], [200], kv_quant=kv_quant)
    return eng


def _inputs(prompt=40, suffix=5):
    rng = np.random.RandomState(0)
    return [rng.randint(1, 127, (1, prompt)).astype(np.int32),
            rng.randint(1, 127, (4, suffix)).astype(np.int32)]


def _generate(eng, ids):
    return eng.generate(input_ids=ids, max_new_tokens=NEW, temperature=0.0,
                        shared_cache_op=SharedCacheOp.WIPE)


def _traced(eng, ids):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        toks = _generate(eng, ids)
    spans = [(e.name()[len(SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith(SPAN_PREFIX)]
    return toks, spans


def _inside(spans, outer):
    _, a, b = outer
    return collections.Counter(n for n, s, e in spans if a <= s and e <= b and (s, e) != (a, b))


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_generate_records_its_prefills_and_each_layers_stages(params):
    _, spans = _traced(_engine(params), _inputs())
    gen = _one(spans, "generate")
    inner = _inside(spans, gen)
    assert inner["shared_prefill"] == 1 and inner["unique_prefill"] == 1
    per_layer = {"qkv": L, "attn": L, "o_proj": L, "mlp": L, "norm": 2 * L,
                 "rope": L + 1}  # and the forward's cos/sin tables
    # The LM head and the final norm. The int8 KV of every layer is written
    # by K9 inside its hg.rope span: no hg.kv_write opens.
    shared = unique = dict(per_layer, head=2)
    for name, want in (("shared_prefill", shared), ("unique_prefill", unique)):
        assert dict(_inside(spans, _one(spans, name))) == want, name
    s, u = _one(spans, "shared_prefill"), _one(spans, "unique_prefill")
    first, dec = _one(spans, "first_token"), _one(spans, "decode")
    assert s[2] <= u[1] and u[2] <= first[1] and first[2] <= dec[1] and dec[2] <= gen[2]


def test_decode_holds_one_step_span_a_step(params):
    _, spans = _traced(_engine(params), _inputs())
    dec = _inside(spans, _one(spans, "decode"))
    assert dec["decode_step"] == NEW - 1
    # Each eager step runs every layer's stages; K9 writes its KV under hg.rope.
    assert dec["attn"] == L * (NEW - 1) and dec["rope"] == (L + 1) * (NEW - 1)  # and the tables
    assert dec["kv_write"] == 0
    assert _inside(spans, _one(spans, "first_token"))["decode_step"] == 0


def test_a_float_cache_writes_each_layer_under_kv_write(params):
    """With a float cache the chain writes each layer's KV after the layer,
    in its hg.kv_write span: the level fill, the unique prefill and every
    decode step, one a layer."""
    _, spans = _traced(_engine(params, kv_quant=None), _inputs())
    for name in ("shared_prefill", "unique_prefill"):
        assert _inside(spans, _one(spans, name))["kv_write"] == L, name
    assert _inside(spans, _one(spans, "decode"))["kv_write"] == L * (NEW - 1)


def test_span_enters_nothing_without_a_profiler(params, monkeypatch):
    eng = _engine(params)
    traced, _ = _traced(eng, _inputs())

    def boom(*a, **kw):
        raise AssertionError("a profiler range was entered with no profiler on")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert span("a") is span("b")
    torch.testing.assert_close(_generate(eng, _inputs()), traced, rtol=0, atol=0)


def test_spans_are_host_ranges_as_operators_are():
    """A span is recorded at an operator's scope, not as a user annotation:
    the profiler draws a device-side copy of a user annotation on the card,
    which readers of the device trace would take for a kernel."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("probe"):
            torch.ones(2).add_(1)
        with torch.profiler.record_function("annotation"):
            pass
    scope = {e.name(): e.scope() for e in prof.profiler.kineto_results.events()}
    assert scope["hg.probe"] == scope["aten::add_"] != scope["annotation"]
    assert profiling.SPAN_PREFIX == "hg."


@pytest.mark.parametrize("bucket", [128, 0])
def test_stats_count_the_widths_given_and_computed(params, bucket):
    eng = _engine(params, bucket)
    ids = _inputs(prompt=40, suffix=5)
    _generate(eng, ids)
    cap_shared = eng.cache.shared[0].global_seq_len
    cap_unique = eng.cache.max_unique_seq_len
    run_shared = _pad_to_bucket(torch.as_tensor(ids[0]), None, bucket, cap_shared)[0].shape[1]
    run_unique = _pad_to_bucket(torch.as_tensor(ids[1]), None, bucket, cap_unique)[0].shape[1]
    assert eng.stats == {"shared_tokens": 40, "shared_tokens_run": run_shared,
                         "unique_tokens": 4 * 5, "unique_tokens_run": 4 * run_unique}
    if bucket:
        assert (run_shared, run_unique) == (128, 32)
    else:
        assert (run_shared, run_unique) == (40, 5)
    _generate(eng, ids)  # counts add up over calls
    assert eng.stats["unique_tokens_run"] == 8 * run_unique
