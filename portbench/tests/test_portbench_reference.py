"""The plain reference held to the port's plain CPU path at a tiny size.

The port runs in float32 on the CPU (each kernel wrapper's plain version),
so where both compute the same function they agree to float32 rounding:
the reference reproduces the port's w8a8 activation codes, its int8
(token, head) cache codes, which keys each forward reads as computed and
which as stored, RoPE, GQA, the norms and the LM head."""

import numpy as np
import pytest
import torch

from portbench import check, port
from portbench.cell import make_weights, rng, token_ids
from portbench.reference import Reference
from portbench.reference.llama import quant_kv, weight
from portbench.tests import tiny

CPU = torch.device("cpu")


def port_and_reference(nkv: int, kv_quant, seed: int, P=24, b=4, t=6, n=5):
    from hydragen_torch import SharedCacheOp

    cfg = dict(tiny.CONFIG, num_key_value_heads=nkv,
               serving=dict(tiny.CONFIG["serving"], compute_dtype="float32"))
    w = make_weights(cfg, seed, CPU)
    eng = port.engine(cfg, w, CPU)
    eng.setup_caches(b, t + n, [1], [P], kv_quant=kv_quant)
    r = rng(seed, "ids")
    prompt, suf = token_ids(r, (1, P), cfg["vocab_size"]), token_ids(r, (b, t), cfg["vocab_size"])
    toks, logits = eng.generate(input_ids=[prompt, suf], max_new_tokens=n, temperature=0.0,
                                shared_cache_op=SharedCacheOp.WIPE, return_logits=True)
    toks, logits = toks.numpy(), torch.stack(logits, 1)
    ref = Reference(w, cfg, kv_bits=8 if kv_quant else None)
    out = ref.served_logits(torch.as_tensor(prompt[0]).long(),
                            [torch.as_tensor(np.concatenate([suf[i], toks[i, :-1]])).long()
                             for i in range(b)], [n] * b)
    return toks, logits, out


@pytest.mark.parametrize("nkv", [2, 4], ids=["gqa", "mha"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32-kv", "int8-kv"])
def test_reference_matches_the_ports_plain_path(nkv, kv_quant):
    toks, logits, out = port_and_reference(nkv, kv_quant, seed=11)
    dist = [float((out[i] - logits[i]).abs().max() / out[i].std()) for i in range(len(out))]
    # Float32 rounding, except where a row's activation code lies on a tie
    # and rounds the other way (the sums run in another order): one code of
    # one row moves the logits by a few percent of their spread at this
    # width, so most rows agree to rounding and none by more than that.
    assert sum(d < 1e-4 for d in dist) >= len(dist) - 1, dist
    assert max(dist) < 0.05, dist
    assert float(check.served_gaps(check.Sample(None, [], list(toks)), out).max()) < 0.05


def test_the_ports_tokens_are_the_references_best():
    toks, _, out = port_and_reference(2, "int8", seed=3)
    gaps = [check.gaps(o, torch.as_tensor(tk)) for o, tk in zip(out, toks)]
    assert max(float(g.max()) for g in gaps) < 0.05


def test_int4_control_weights_and_cache():
    q = torch.tensor([[127, -64, 3, 0] * 64], dtype=torch.int8)  # [1, 256]
    s = torch.tensor([0.01])
    w8 = weight(q, s, 8)
    assert torch.equal(w8, q.float() * 0.01)
    w4 = weight(q, s, 4)
    # Two groups of 128, each amax 1.27 on a grid of 1.27 / 7.
    step = 1.27 / 7
    assert torch.allclose(w4[0, :4], torch.tensor([7, -4, 0, 0]) * step, atol=1e-6)
    x = torch.tensor([[1.0, -0.6, 0.3, 0.0]])  # no code on a tie
    assert torch.allclose(quant_kv(x, 8), torch.round(x * 127) / 127, atol=1e-7)
    assert torch.allclose(quant_kv(x, 4), torch.round(x * 7) / 7, atol=1e-7)


def test_gap_is_in_units_of_the_logits_spread():
    logits = torch.tensor([[0.0, 1.0, 3.0, 2.0]])
    sd = float(logits.std())
    assert float(check.gaps(logits, torch.tensor([2]))[0]) == 0.0
    assert float(check.gaps(logits, torch.tensor([1]))[0]) == pytest.approx(2.0 / sd)
    low = [torch.tensor([[0.0, 1.0, 2.5, 2.9]])]
    assert float(check.control_gaps([logits], low)[0]) == pytest.approx(1.0 / sd)
    st = check.gap_stats(torch.tensor([0.0, 0.0, 0.5, 1.5]))
    assert st["mean"] == pytest.approx(0.5) and st["max"] == 1.5 and st["changed"] == 0.5


def test_judge_holds_each_number_to_its_limit():
    assert check.judge({"mean_gap": 0.1, "failed": 0}, {"mean_gap": 0.12, "failed": 0}) == (
        True, {"mean_gap": [0.1, 0.12], "failed": [0, 0]})
    assert not check.judge({"mean_gap": 0.13, "failed": 0}, {"mean_gap": 0.12, "failed": 0})[0]
    assert not check.judge({"mean_gap": 0.0, "failed": 1}, {"mean_gap": 0.12, "failed": 0})[0]
    assert not check.judge({"mean_gap": 0.0}, {})[0]  # no limit: not correct
