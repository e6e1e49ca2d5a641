"""Quantization quality gate: cross-entropy and KL of a quantized model
against the same model in full precision.

Port of the JAX package's ``scripts/quality.py``. With random weights the
absolute perplexity sits near the vocabulary's size, but the distance
between a model and its quantized copy still measures the quantization
noise: ``ce_delta_nats`` and ``mean_kl_nats`` are the gate (the scale-free
form of "perplexity within 0.1": 0.1 at a real model's perplexity of ~7 is
about 0.014 nats); ``ppl_delta`` understates the error at this near-uniform
operating point and is not evidence for the bound.

- ``--quantization`` int8 or int4 (weight-only), w8a8 or w4a8 (the
  activations quantized a row and the products on K1 or K6): the logits of
  one prefill over the same tokens (``append_shared(full_logits=True)``).
  Every family the port's gates take (``ops/gemm.py``: ``w8a8_supported``,
  ``w4a8_supported``) runs on its kernel, and ``s8_kernel_coverage`` says
  which; a family neither takes is named, and on the card it raises.
- ``--outliers`` scales a random 0.1 % of every projection's output
  channels by 20 (the heavy-tailed channels of real checkpoints), and
  ``--scheme per_tensor`` quantizes each matrix with one int8 scale: the
  naive scheme that must fail the gate there, where the per-channel scheme
  passes (``tests/test_torch_quality.py``).
- ``--kv-quant`` int8 or int4 gates the KV cache instead: full-precision
  weights, the logits of a forced decode stream over a quantized shared
  level and unique cache, against the same stream with a full-precision
  cache.

    python -m hydragen_torch.scripts.quality --preset sheared-llama-1.3b \\
        --tokens 512 --batch 4 --outliers [--device cpu]

Prints one JSON object: the cross-entropies (nats) of both precisions, the
perplexity delta and the mean KL(full || quantized) a token.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hydragen_torch.core.engine import HydragenLlama, SharedCacheOp
from hydragen_torch.models.config import PRESETS
from hydragen_torch.models.llama import init_params
from hydragen_torch.ops import gemm
from hydragen_torch.ops.quant import QuantizedTensor, quantize_params
from hydragen_torch.scripts import common

FAMILIES = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def eval_logits(engine, ids) -> torch.Tensor:
    """Full next-token logits ``[b, T, V]`` of a token batch."""
    engine.setup_caches(max_unique_batch_size=ids.shape[0], max_unique_seq_length=16,
                        max_shared_batch_sizes=[ids.shape[0]],
                        max_shared_seq_lengths=[ids.shape[1]])
    logits = engine.append_shared(ids, full_logits=True)
    engine.empty_shared_cache()
    return logits


def quality_metrics(logits_hi, logits_lo, ids) -> tuple:
    """(ce_hi, ce_lo, mean_kl): the cross-entropies in nats of ``ids``'
    next tokens and KL(hi || lo), in f32."""
    tgt = torch.as_tensor(np.asarray(ids), dtype=torch.long).to(logits_hi.device)[:, 1:]
    lp_hi = torch.log_softmax(logits_hi[:, :-1].float(), dim=-1)
    lp_lo = torch.log_softmax(logits_lo[:, :-1].float(), dim=-1)

    def ce(lp):
        return -torch.take_along_dim(lp, tgt[..., None], dim=-1).mean()

    kl = (lp_hi.exp() * (lp_hi - lp_lo)).sum(-1).mean()
    return float(ce(lp_hi)), float(ce(lp_lo)), float(kl)


def inject_outlier_channels(params: dict, seed: int = 0, frac: float = 0.001,
                            mult: float = 20.0) -> dict:
    """Scale a random ``frac`` of the output channels of every projection by
    ``mult`` (the JAX script's draw: ``numpy.random.RandomState(seed +
    1234)``, family by family): heavy-tailed channels, which random Gaussian
    weights lack and real checkpoints have, so that the gate can tell
    quantization schemes apart."""
    rng = np.random.RandomState(seed + 1234)
    layers = dict(params["layers"])
    for name in FAMILIES:
        w = layers[name].clone()  # [L, in, out] float
        n_out = w.shape[-1]
        idx = rng.choice(n_out, size=max(1, int(n_out * frac)), replace=False)
        w[..., torch.as_tensor(idx, device=w.device)] *= mult
        layers[name] = w
    return dict(params, layers=layers)


def quantize_params_per_tensor(params: dict) -> dict:
    """The naive baseline the adversarial gate must fail: ONE int8 scale a
    matrix (a layer), broadcast over the output channels of the shipped
    per-channel layout (``ops/quant.py:quantize``)."""

    def qt(w):
        wf = w.float()
        amax = wf.abs().amax(dim=(-2, -1), keepdim=True)
        scale = (torch.clamp(amax, min=1e-8) / 127.0).to(torch.bfloat16)
        q = torch.clamp(torch.round(wf / scale.float()), -127, 127).to(torch.int8)
        out_ch = scale[..., 0, :].expand(*wf.shape[:-2], wf.shape[-1])
        return QuantizedTensor(q=q.transpose(-1, -2).contiguous(), scale=out_ch.contiguous())

    layers = dict(params["layers"])
    for name in FAMILIES:
        layers[name] = qt(layers[name])
    return dict(params, layers=layers, lm_head=qt(params["lm_head"]))


def kernel_coverage(params: dict, quantization: str) -> dict:
    """family: whether K1 (w8a8) or K6 (w4a8) takes its stacked weight."""
    cov = {}
    for fam in FAMILIES:
        t = params["layers"][fam]
        if quantization == "w4a8":
            cov[fam] = gemm.w4a8_supported(t.qp.shape[-2], t.qp.shape[-1], t.group_size)
        else:
            cov[fam] = gemm.w8a8_supported(t.q.shape[-2], t.q.shape[-1])
    return cov


def _model(preset, seed: int, outliers: bool, device):
    cfg = PRESETS[preset] if isinstance(preset, str) else preset
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    if outliers:
        params = inject_outlier_channels(params, seed)
    return cfg, params


def run(preset, tokens: int, batch: int, seed: int = 0, outliers: bool = False,
        scheme: str = "per_channel", quantization: str = "int8", device="cuda") -> dict:
    """The weight gate: one prefill's logits of the full-precision model and
    of its quantized copy over the same random tokens."""
    cfg, params = _model(preset, seed, outliers, device)
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, size=(batch, tokens)).astype(np.int32)
    logits_hi = eval_logits(HydragenLlama(cfg, params, device=device), ids)
    if quantization in ("int4", "w4a8"):
        # int4 is group-wise by construction; the per-tensor baseline is an
        # int8 experiment.
        assert scheme == "per_channel", "the int4 gate runs the shipped scheme only"
        quantized = quantize_params(params, bits=4)
    elif scheme == "per_channel":
        quantized = quantize_params(params)
    else:
        quantized = quantize_params_per_tensor(params)
    lo = HydragenLlama(cfg, quantized, quantization=quantization, device=device)
    extra = {}
    if quantization in ("w8a8", "w4a8"):
        cov = kernel_coverage(lo.params, quantization)
        extra["s8_kernel_coverage"] = cov
        missing = sorted(f for f, ok in cov.items() if not ok)
        if missing:
            print(f"WARNING: {quantization}: {'K6' if quantization == 'w4a8' else 'K1'} does not "
                  f"take {missing} at these dims (on the card their products raise; on the "
                  "CPU they run the plain version)")
    logits_lo = eval_logits(lo, ids)
    ce_hi, ce_lo, kl = quality_metrics(logits_hi, logits_lo, ids)
    return {
        **extra,
        "preset": preset if isinstance(preset, str) else "custom",
        "scheme": scheme,
        "quantization": quantization,
        "outliers": outliers,
        "tokens": tokens * batch,
        "ce_bf16_nats": round(ce_hi, 5),
        "ce_int8_nats": round(ce_lo, 5),
        "ppl_bf16": round(float(np.exp(ce_hi)), 4),
        "ppl_int8": round(float(np.exp(ce_lo)), 4),
        "ppl_delta": round(float(abs(np.exp(ce_lo) - np.exp(ce_hi))), 4),
        "ce_delta_nats": round(abs(ce_lo - ce_hi), 6),
        "mean_kl_nats": round(kl, 6),
    }


def run_kv(preset, tokens: int, batch: int, seed: int = 0, kv_quant: str = "int8",
           outliers: bool = False, device="cuda") -> dict:
    """The KV-cache gate: full-precision weights throughout, the logits of a
    forced token stream whose decode steps read the quantized shared level
    and the growing quantized unique cache, against the same run with a
    full-precision cache."""
    cfg, params = _model(preset, seed, outliers, device)
    rng = np.random.RandomState(seed)
    half = tokens // 2
    steps = min(tokens - half - 1, 64)
    prefix = rng.randint(1, cfg.vocab_size, size=(batch, half)).astype(np.int32)
    first = rng.randint(1, cfg.vocab_size, size=(batch, 1)).astype(np.int32)
    overrides = rng.randint(1, cfg.vocab_size, size=(batch, steps)).astype(np.int32)

    def logits_for(kvq):
        eng = HydragenLlama(cfg, params, device=device)
        eng.setup_caches(max_unique_batch_size=batch, max_unique_seq_length=steps + 8,
                         max_shared_batch_sizes=[batch], max_shared_seq_lengths=[half],
                         kv_quant=kvq)
        _, logits = eng.generate(input_ids=[prefix, first], num_return_sequences=1,
                                 max_new_tokens=steps, temperature=0.0, return_logits=True,
                                 token_overrides=overrides,
                                 shared_cache_op=SharedCacheOp.WIPE)
        eng.cache = None
        return torch.stack(logits, dim=1)  # [b, steps, V]

    logits_hi = logits_for(None)
    logits_lo = logits_for(kv_quant)
    # Targets: the forced stream itself, shifted one step.
    ids = np.concatenate([first, overrides], axis=1)[:, :steps + 1]
    ce_hi, ce_lo, kl = quality_metrics(logits_hi, logits_lo, ids[:, 1:])
    return {
        "preset": preset if isinstance(preset, str) else "custom",
        "kv_quant": kv_quant,
        "outliers": outliers,
        "tokens": int(batch * steps),
        "ce_bf16_nats": round(ce_hi, 5),
        "ce_kvq_nats": round(ce_lo, 5),
        "ce_delta_nats": round(abs(ce_lo - ce_hi), 6),
        "mean_kl_nats": round(kl, 6),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="sheared-llama-1.3b")
    p.add_argument("--tokens", type=int, default=512)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outliers", action="store_true",
                   help="inject 20x outlier channels (the adversarial gate)")
    p.add_argument("--scheme", default="per_channel", choices=["per_channel", "per_tensor"])
    p.add_argument("--quantization", default="int8", choices=["int8", "w8a8", "int4", "w4a8"],
                   help="int8 / int4: weight-only; w8a8 / w4a8: the activations quantized a "
                        "row at run time and the products on K1 / K6")
    p.add_argument("--kv-quant", default=None, choices=[None, "int8", "int4"],
                   help="gate the KV-cache precision instead of the weights: full-precision "
                        "weights, logits along a forced decode stream over the quantized "
                        "caches")
    common.add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = common.device_of(args, "quality")
    if args.kv_quant is not None:
        res = run_kv(args.preset, args.tokens, args.batch, args.seed, kv_quant=args.kv_quant,
                     outliers=args.outliers, device=device)
    else:
        res = run(args.preset, args.tokens, args.batch, args.seed, outliers=args.outliers,
                  scheme=args.scheme, quantization=args.quantization, device=device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
