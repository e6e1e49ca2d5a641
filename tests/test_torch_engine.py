"""The port's ``HydragenLlama.generate`` against the JAX engine's, on the CPU.

Both engines get one parameter set (made by the JAX package, carried over
with ``params_from_numpy``) and the same prompts, over a hierarchy of two
shared levels with ``num_return_sequences=2``. Greedy tokens must be
identical. Per-step logits along a forced token stream (``token_overrides``)
must agree to 1e-3, in fp32 and under w8a8 + int8 KV; at these inputs they
agree to about 2e-6 in both. The inputs are fixed by their seeds for a
reason: under w8a8 + int8 KV each per-row activation quantization rounds at
half-code boundaries, and where a last-bit difference between XLA's and
PyTorch's float sums meets such a boundary, one activation lands one code
apart and moves a logit by up to ~4e-2 (prompts from seed 2 do that; either
option alone stays within 5e-6).
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax
import torch

from hydragen_tpu.core.engine import HydragenLlama as JEngine
from hydragen_tpu.core.engine import SharedCacheOp as JOp
from hydragen_tpu.models.config import ModelConfig as JConfig
from hydragen_tpu.models.llama import init_params as jinit

from hydragen_torch import HydragenLlama as TEngine
from hydragen_torch import ModelConfig as TConfig
from hydragen_torch import SharedCacheOp as TOp
from hydragen_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
           num_attention_heads=2, num_key_value_heads=2, dtype="float32")
MODES = {"fp32": (None, None), "w8a8_kv8": ("w8a8", "int8")}


@pytest.fixture(scope="module")
def params():
    p = jinit(JConfig(**CFG), jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def _engines(params, mode, monkeypatch, levels=(1, 2), shared_len=(16, 8), eos_chunk=32):
    quant, kv = MODES[mode]
    if quant:
        monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    jp, tp = params
    je = JEngine(JConfig(**CFG), jp, quantization=quant, eos_chunk=eos_chunk)
    te = TEngine(TConfig(**CFG), tp, quantization=quant, eos_chunk=eos_chunk, device="cpu")
    for e in (je, te):
        e.setup_caches(4, 16, list(levels), list(shared_len), kv_quant=kv, unique_bshd=True)
    return je, te


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, 256, (1, 10)).astype(np.int32),
            rng.randint(1, 256, (2, 5)).astype(np.int32))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_tokens_identical(params, mode, monkeypatch):
    je, te = _engines(params, mode, monkeypatch)
    l0, l1 = _prompts()
    kw = dict(input_ids=[l0, l1], num_return_sequences=2, max_new_tokens=6,
              temperature=0.0)
    jt = je.generate(shared_cache_op=JOp.WIPE, **kw)
    tt = te.generate(shared_cache_op=TOp.WIPE, **kw)
    assert _np(tt).shape == (4, 6)
    np.testing.assert_array_equal(_np(tt), _np(jt))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forced_stream_logits_close(params, mode, monkeypatch):
    je, te = _engines(params, mode, monkeypatch)
    l0, l1 = _prompts(1)
    overrides = np.random.RandomState(2).randint(1, 256, (4, 6)).astype(np.int32)
    kw = dict(input_ids=[l0, l1], num_return_sequences=2, max_new_tokens=6,
              temperature=0.0, token_overrides=overrides, return_logits=True)
    _, jl = je.generate(shared_cache_op=JOp.WIPE, **kw)
    _, tl = te.generate(shared_cache_op=TOp.WIPE, **kw)
    assert len(tl) == len(jl) == 6
    for step, (t, j) in enumerate(zip(tl, jl)):
        d = np.abs(_np(t) - _np(j))
        assert d.max() <= 1e-3, (mode, step, d.max())


def test_wipe_preserve_extend_across_calls(params, monkeypatch):
    je, te = _engines(params, "fp32", monkeypatch, levels=(1, 2, 2), shared_len=(16, 8, 8))
    l0, l1 = _prompts(3)
    rng = np.random.RandomState(4)
    suffix = rng.randint(1, 256, (4, 3)).astype(np.int32)
    extra = rng.randint(1, 256, (2, 4)).astype(np.int32)
    calls = [
        # (input_ids, num_return_sequences, op, levels used afterwards)
        ([l0, l1], 2, "WIPE", 2),
        ([suffix], 1, "PRESERVE", 2),   # decode over the kept hierarchy
        ([extra], 2, "EXTEND", 3),      # a third level stays after the call
        ([suffix], 1, "PRESERVE", 3),
        ([l0, l1], 2, "WIPE", 2),
    ]
    for ids, nrs, op, used in calls:
        kw = dict(input_ids=ids, num_return_sequences=nrs, max_new_tokens=4, temperature=0.0)
        jt = je.generate(shared_cache_op=getattr(JOp, op), **kw)
        tt = te.generate(shared_cache_op=getattr(TOp, op), **kw)
        np.testing.assert_array_equal(_np(tt), _np(jt), err_msg=op)
        assert te.get_num_used_shared_caches() == je.get_num_used_shared_caches() == used


def test_stop_sequence_and_eos_truncate_like_jax(params, monkeypatch):
    je, te = _engines(params, "fp32", monkeypatch, eos_chunk=2)
    l0, l1 = _prompts(5)
    kw = dict(input_ids=[l0, l1], num_return_sequences=2, max_new_tokens=8, temperature=0.0)
    full = _np(te.generate(shared_cache_op=TOp.WIPE, **kw))
    stop = [full[0, 2:4].tolist()]
    for extra in (dict(stop_sequences=stop), dict(eos_token_id=int(full[1, 3]))):
        jt = je.generate(shared_cache_op=JOp.WIPE, **kw, **extra)
        tt = te.generate(shared_cache_op=TOp.WIPE, **kw, **extra)
        np.testing.assert_array_equal(_np(tt), _np(jt))


def test_sampling_is_seeded_and_in_range(params, monkeypatch):
    _, te = _engines(params, "fp32", monkeypatch)
    l0, l1 = _prompts(6)
    kw = dict(input_ids=[l0, l1], num_return_sequences=2, max_new_tokens=5,
              temperature=0.8, top_p=0.9, shared_cache_op=TOp.WIPE)
    a = _np(te.generate(seed=1, **kw))
    b = _np(te.generate(seed=1, **kw))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 5) and a.min() >= 0 and a.max() < CFG["vocab_size"]


def test_engine_without_device_needs_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(TConfig(**CFG), params[1])
