"""The comparison that decides ``correct`` fails what it must.

The control (the reference one precision step down, int4 weights and
cache, in the program's place) comes out not correct from the run's own
comparison where the program comes out correct, and a run whose timed path is broken underneath comes out
not correct: once for each fault a cell of this benchmark can have (a token
altered where it is produced; a decode step that leaves the cache as it
was; half of the batch left out). A cell on one chip has no exchange
between chips to leave out. The runs are the harness's own (its look for a
card skipped), on the tiny cells on the CPU."""

import pytest
import torch

from portbench import calibrate, run
from portbench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["tiny-gen", "tiny-serve"])
def test_the_control_fails_where_the_program_passes(tmp_path, cell):
    root = tiny.make_bench(tmp_path)
    for seed in (1, 2, 3):
        r = calibrate.readings(root, cell, seed, 0.5, True, CPU)
        assert r["failed"] == 0
        gap, ctl = r["program"]["mean"], r["control"]["mean"]
        assert r["program_correct"] is True and r["control_correct"] is False, (seed, gap, ctl)


def altered_tokens(monkeypatch):
    import hydragen_torch.core.batching as batching
    import hydragen_torch.core.engine as engine

    orig = engine.sample_from_logits

    def wrong(logits, *a, **kw):
        return (orig(logits, *a, **kw) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample_from_logits", wrong)
    monkeypatch.setattr(batching, "sample_from_logits", wrong)


def unchanged_cache(monkeypatch):
    import hydragen_torch.models.llama as llama

    monkeypatch.setattr(llama, "write_decode_token_layer", lambda *a, **kw: None)


def half_the_batch(monkeypatch):
    from hydragen_torch.core.batching import ContinuousBatcher
    from hydragen_torch.core.engine import HydragenLlama

    gen = HydragenLlama.generate

    def half(self, *a, **kw):  # the second half of the rows repeats the first
        toks = gen(self, *a, **kw)
        b = toks.shape[0]
        return torch.cat([toks[: b // 2], toks[: b - b // 2]])

    admit = ContinuousBatcher._admit_step

    def admit_half(self, *a, **kw):  # every other row of the pool is never decoded
        admit(self, *a, **kw)
        self.state.active[1::2] = False

    monkeypatch.setattr(HydragenLlama, "generate", half)
    monkeypatch.setattr(ContinuousBatcher, "_admit_step", admit_half)


@pytest.mark.parametrize("cell", ["tiny-gen", "tiny-serve"])
@pytest.mark.parametrize("fault", [altered_tokens, unchanged_cache, half_the_batch],
                         ids=["token-altered", "cache-unchanged", "half-the-batch"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    assert run.run_cell(tiny.make_bench(tmp_path / "sound"), cell, 9, 0.5, False,
                        CPU)["correct"]
    # A request that never comes back is waited for 3 s, not the mix's 30.
    root = tiny.make_bench(tmp_path / "broken", serve=dict(tiny.SERVE, drain_s=3))
    fault(monkeypatch)
    res = run.run_cell(root, cell, 9, 0.5, False, CPU)
    assert res["correct"] is False, res["checks"]
