"""DeepSeek-LLM-67B's shape at tp=4, held to the benchmark's plain reference.

A tiny configuration in the proportions of DeepSeek-LLM-67B-Base (8 query
heads a kv head, kv heads, MLP channels and vocabulary split four ways, an
untied head; the MLP 2.6875 times the hidden size, as 22,016 is of 8,192)
runs through ``HydragenLlama(mesh=)`` at tp=4 over four gloo ranks in fp32:
the shared prompt's and the suffixes' prefill, then decoding through the
cache (``generate``, greedy, its per-step logits). The port's graphs run only
on CUDA, so on the CPU this is the eager path. Each rank's logits are held
to the full forward pass of ``portbench/reference/llama.py`` (float32, w8a8
rows, int8 keys and values) over the same prompts and tokens, as the
benchmark's ``correct`` holds the timed path on the card.

Under tp a rank quantizes its own K slice of the o and down projections'
inputs with its own row scale, where the reference quantizes each whole
row with one; and K1 gives each rank's products in bf16 (the row-parallel
partials, summed in f32 and rounded once more), where the fp32 reference
keeps f32 (``parallel/shard_gemm.py``, as the JAX shard bodies do). So the
port at tp=4 is held tightly to the reference with what a rank computes
modelled (``PerShard``: each quarter of those rows quantized alone, the
products rounded as the ranks round them), and loosely to the reference as
it is, which the test shows lies beyond the tight tolerance. The meshless
port (f32 products, whole rows) is held tightly to the reference as it is.
One spawn of the four ranks serves every case.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
from hydragen_torch.parallel import launch
from portbench import port
from portbench.cell import MODEL_KEYS, make_weights, rng, token_ids
from portbench.reference import Reference
from portbench.reference import llama as reference

from test_torch_parallel import _once

CONFIG = {
    "hidden_size": 256, "intermediate_size": 688, "num_hidden_layers": 2,
    "num_attention_heads": 32, "num_key_value_heads": 4, "vocab_size": 1024,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "max_position_embeddings": 4096,
    "tie_word_embeddings": False,
}
TP = 4
SEED = 2**33 + 24
P, B, T, N = 48, 4, 8, 6  # prompt, rows, suffix and new tokens

# Tolerances on the root mean square of logit - reference logit, in the
# reference's standard deviations at each position (over all positions and
# ids). TIGHT: the same quantized model computed in another order (the
# all-reduce's f32 sum, the blocked attention, the fused norm); where that
# moves an activation or a cached key across an int8 rounding point, the
# code changes by one and every later position feels it. Over four seeds
# the port read 2e-5 to 8.1e-3 against PerShard at tp=4 and 2.7e-3 to
# 7.8e-3 meshless against the reference.
TIGHT = 0.012
# LOOSE: the reference as it is at tp=4, where every code of o's and
# down's inputs is rounded on its quarter row's scale and every product to
# bf16: 1.98e-2 to 2.04e-2 over the same seeds, above TIGHT by half again.
LOOSE = 0.03


def model_config() -> ModelConfig:
    return ModelConfig(**{k: CONFIG[k] for k in MODEL_KEYS}, dtype="float32")


def inputs(seed: int):
    r = rng(seed, "call", 0)
    V = CONFIG["vocab_size"]
    return token_ids(r, (1, P), V), token_ids(r, (B, T), V)


def run_engine(seed: int, mesh=None):
    """Tokens ``[B, N]`` and per-step logits ``[N, B, V]`` of one greedy
    call, the engine over the seeded weights (w8a8, int8 keys and values)."""
    eng = HydragenLlama(model_config(), port.port_params(make_weights(CONFIG, seed, "cpu")),
                        quantization="w8a8", device="cpu", mesh=mesh)
    eng.setup_caches(B, T + N, [1], [P], kv_quant="int8")
    prompt, suffixes = inputs(seed)
    toks, logits = eng.generate(input_ids=[prompt, suffixes], max_new_tokens=N,
                                temperature=0.0, return_logits=True,
                                shared_cache_op=SharedCacheOp.WIPE)
    return toks, torch.stack(logits)


def _rank(rank, world, seed):
    from hydragen_torch.parallel import make_mesh

    torch.set_num_threads(1)
    return run_engine(seed, make_mesh(tp=world, device="cpu"))


class PerShard(Reference):
    """The reference computing what a tp rank computes: o's and down's
    input rows quantized a quarter at a time, each quarter's product with
    its K slice of the weight rounded to bf16, the four summed in f32 and
    the sum rounded to bf16; every other projection's product rounded to
    bf16. ``_layer`` projects q, k, v and o, then gate, up and down (one
    block of rows at this size)."""

    def _layer(self, *a, **kw):
        self._proj_calls = 0
        return super()._layer(*a, **kw)

    def _proj(self, x, w, rows=4096):
        self._proj_calls += 1
        if self._proj_calls not in (4, 7):
            return bf16(super()._proj(x, w, rows))
        return bf16(sum(bf16(reference.quant_rows(xs) @ ws.T)
                        for xs, ws in zip(x.chunk(TP, dim=-1), w.chunk(TP, dim=-1))))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def reference_logits(ref_cls, toks, seed: int) -> torch.Tensor:
    """The reference's logits ``[N, B, V]`` at the served positions."""
    prompt, suffixes = inputs(seed)
    ref = ref_cls(make_weights(CONFIG, seed, "cpu"), CONFIG)
    ids = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64))  # noqa: E731
    conts = [ids(np.concatenate([suffixes[i], toks[i, :-1]])) for i in range(B)]
    out = ref.served_logits(ids(prompt[0]), conts, [N] * B)
    return torch.stack(out, dim=1)


def distance(logits, ref) -> float:
    """The root mean square of ``logits - ref`` in the reference's standard
    deviations at each position."""
    d = (torch.as_tensor(logits) - ref) / ref.std(-1, keepdim=True)
    return float(d.pow(2).mean().sqrt())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _once(tmp_path_factory, "tp4_deepseek",
                 lambda: launch(_rank, TP, SEED, timeout=300))


def test_every_rank_gets_the_same_tokens_and_logits(ranks):
    toks, logits = ranks[0]
    assert toks.shape == (B, N)
    for t, lg in ranks[1:]:
        np.testing.assert_array_equal(t, toks)
        np.testing.assert_array_equal(lg, logits)


@pytest.mark.parametrize("case", ["per_shard", "global"])
def test_tp4_matches_the_reference(ranks, case):
    toks, logits = ranks[0]
    ref = reference_logits(PerShard if case == "per_shard" else Reference, toks, SEED)
    d = distance(logits, ref)
    print(f"[tp4 {case}] rms distance {d:.3e} std")
    if case == "per_shard":
        assert d <= TIGHT
    else:  # the per-shard departure is real, and bounded
        assert TIGHT < d <= LOOSE


def test_meshless_matches_the_reference():
    toks, logits = run_engine(SEED)
    d = distance(logits, reference_logits(Reference, toks.numpy(), SEED))
    print(f"[meshless] rms distance {d:.3e} std")
    assert d <= TIGHT
