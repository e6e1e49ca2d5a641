"""The port's quantization quality gate (``hydragen_torch/scripts/quality.py``)
against the JAX package's ``scripts/quality.py``, on the CPU.

- Parity: ``run`` and ``run_kv`` of both scripts on the same weights (the
  JAX package's ``init_params`` at key 0, carried over by
  ``params_from_numpy`` and handed to the port script in place of its
  random ones) and the same numpy tokens, fp32, at ``CFG_S8``: every
  projection there is one JAX's s8 GEMMs take (``_w8a8_blocks``,
  ``_w4a8_blocks``), so both packages run every family on their s8 route
  under w8a8 and w4a8 (the port always does). Every activation and KV
  quantization of the port is held to JAX's by the tie rule of
  ``tests/test_torch_ties.py`` and goes on with JAX's codes. Each reported
  cross-entropy and KL is then within ``TOL_NATS`` of JAX's (the scripts
  round them to 1e-5 and 1e-6 nats), the perplexities within ``TOL_PPL``
  relative (their difference within twice that of the full-precision
  perplexity).
- The port's own copies of ``tests/test_quality.py``'s four assertions, at
  its configuration: per-channel int8 passes the gate, with outlier
  channels too, where per-tensor int8 fails it; the int8 KV cache and w8a8
  pass it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hydragen_torch.core.engine import HydragenLlama
from hydragen_torch.models.config import ModelConfig
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.scripts import quality

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# tests/test_quality.py's configuration.
CFG = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
           num_attention_heads=8, num_key_value_heads=4, dtype="float32")
# Every projection's (N, K) a multiple of 128 (K of 256), int4 groups of 128:
# the JAX engine's s8 GEMMs take every family.
CFG_S8 = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4, dtype="float32")
TOL_NATS = 2e-5
TOL_PPL = 1e-4
# (kwargs of run, or of run_kv with kv_quant)
PARITY = {
    "int8": dict(quantization="int8"),
    "int8-outliers": dict(quantization="int8", outliers=True),
    "per-tensor-outliers": dict(quantization="int8", outliers=True, scheme="per_tensor"),
    "int4": dict(quantization="int4"),
    "w8a8": dict(quantization="w8a8"),
    "w4a8": dict(quantization="w4a8"),
    "kv-int8": dict(kv_quant="int8"),
    "kv-int4": dict(kv_quant="int4"),
}


def jax_quality():
    import tests.conftest  # noqa: F401

    spec = importlib.util.spec_from_file_location("jax_script_quality",
                                                  ROOT / "scripts" / "quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_params(cfg_kw):
    import tests.conftest  # noqa: F401
    import jax

    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.models.llama import init_params

    p = init_params(JConfig(**cfg_kw), jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("case", list(PARITY))
def test_quality_matches_jax(monkeypatch, case):
    from hydragen_tpu.models.config import ModelConfig as JConfig
    from tests.test_torch_ties import Resolver, assert_resolved, jax_recorded, port_resolved

    jq = jax_quality()
    # The JAX script draws init_params at key 0 itself; the port gets the same.
    monkeypatch.setattr(quality, "init_params", lambda *a, **kw: jax_params(CFG_S8))
    # The JAX script sets these for its s8 arms; restored after the test.
    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    monkeypatch.setenv("HYDRAGEN_W8A8_FAMILIES", "all")
    kw = dict(PARITY[case])
    kv = kw.pop("kv_quant", None)
    records = []
    with jax_recorded(records):
        if kv:
            want = jq.run_kv(JConfig(**CFG_S8), 128, 2, kv_quant=kv, **kw)
        else:
            want = jq.run(JConfig(**CFG_S8), 128, 2, **kw)
    with port_resolved(Resolver(records)) as res:
        if kv:
            got = quality.run_kv(ModelConfig(**CFG_S8), 128, 2, kv_quant=kv, device="cpu", **kw)
        else:
            got = quality.run(ModelConfig(**CFG_S8), 128, 2, device="cpu", **kw)
    if records:  # the s8 arms and the KV caches quantize at run time
        assert_resolved(res.report(), case)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "ppl_delta":  # a difference of two perplexities of ~|vocab|
            assert abs(got[k] - v) <= 2 * TOL_PPL * want["ppl_bf16"], (k, got[k], v)
        elif k.startswith("ppl"):
            assert got[k] == pytest.approx(v, rel=TOL_PPL), k
        elif k.startswith(("ce_", "mean_kl")):
            assert abs(got[k] - v) <= TOL_NATS, (k, got[k], v)
        else:
            assert got[k] == v, k
    if kw.get("quantization") in ("w8a8", "w4a8"):
        assert all(got["s8_kernel_coverage"].values())


@pytest.fixture
def seeded_cfg():
    """tests/test_quality.py's configuration, the port's random weights."""
    return ModelConfig(**CFG)


def test_int8_quality_gate(seeded_cfg):
    m = quality.run(seeded_cfg, tokens=128, batch=2, device="cpu")
    assert m["ce_delta_nats"] < 0.015, m
    assert m["mean_kl_nats"] < 5e-3, m


def test_outlier_channels_discriminate_schemes(seeded_cfg):
    """With 20x outlier channels the per-channel int8 scheme passes the gate
    and the per-tensor one fails it: the gate can reject a bad scheme."""
    good = quality.run(seeded_cfg, tokens=128, batch=2, outliers=True, device="cpu")
    assert good["ce_delta_nats"] < 0.015, good
    assert good["mean_kl_nats"] < 5e-3, good
    bad = quality.run(seeded_cfg, tokens=128, batch=2, outliers=True, scheme="per_tensor",
                      device="cpu")
    assert bad["ce_delta_nats"] > 0.015 or bad["mean_kl_nats"] > 5e-3, bad


def test_int8_kv_quality_gate(seeded_cfg):
    """The int8 KV cache, the weights in full precision (test_quality.py's
    request: a 32-token prompt, two suffixes of 8, 8 greedy tokens)."""
    from hydragen_torch.models.llama import init_params

    params = init_params(seeded_cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 512, size=(1, 32)).astype(np.int32)
    suffix = rng.randint(1, 512, size=(2, 8)).astype(np.int32)

    def logits_with(kv_quant):
        eng = HydragenLlama(seeded_cfg, params, prefill_bucket=0, device="cpu")
        eng.setup_caches(2, 32, [1], [32], kv_quant=kv_quant)
        eng.append_shared(prompt)
        _, logits = eng.generate(input_ids=[suffix], max_new_tokens=8, temperature=0.0,
                                 return_logits=True)
        return torch.stack(logits, dim=1).float()

    lp_hi = torch.log_softmax(logits_with(None), dim=-1)
    lp_lo = torch.log_softmax(logits_with("int8"), dim=-1)
    kl = float((lp_hi.exp() * (lp_hi - lp_lo)).sum(-1).mean())
    assert kl < 5e-3, kl


def test_w8a8_quality_gate(seeded_cfg):
    """w8a8: the activations quantized a row on top of the weights (K1's
    plain version here) still clear the gate."""
    m = quality.run(seeded_cfg, tokens=64, batch=2, quantization="w8a8", device="cpu")
    assert m["ce_delta_nats"] < 0.015, m
    assert m["mean_kl_nats"] < 8e-3, m
