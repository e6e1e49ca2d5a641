"""A new cell from data files alone: a configuration, a traffic mix, a
per-layer metric's reader, limits and the cell's entry, all written as new
files into a temporary directory, are found by name and run by the harness
on the CPU through its internal entry, with no file of the benchmark
edited."""

import hashlib
from pathlib import Path

import torch

from portbench import run
from portbench.tests import tiny

PKG = Path(run.__file__).resolve().parent


def digest() -> str:
    h = hashlib.sha256()
    for p in sorted(PKG.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p).encode() + p.read_bytes())
    return h.hexdigest()


def test_a_cell_added_as_new_files_runs(tmp_path):
    before = digest()
    root = tiny.make_bench(tmp_path)
    cpu = torch.device("cpu")
    res = run.run_cell(root, "tiny-gen", 2**31 + 5, 0.3, False, cpu)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 8
    assert set(res["metrics"]) == {"gen_tok_s", "setup_s"}
    assert list(res)[-1] == "checks" and list(res["checks"]) == ["mean_gap", "failed"]
    traced = run.run_cell(root, "tiny-gen", 2**31 + 5, 0.3, True, cpu)
    assert traced["correct"]
    # The new reader, found by its name in the new BENCHMARK.json.
    assert traced["metrics"]["calls_per_s.gen"]["unit"] == "1/s"
    assert traced["metrics"]["calls_per_s.gen"]["value"] > 0
    assert "breakdown" in traced and traced["device"]["window_s"] > 0
    served = run.run_cell(root, "tiny-serve", 7, 1.0, True, cpu)
    assert served["correct"] and served["attempted"] == 20
    assert set(served["metrics"]) == {"submit_lag_p95_s.serve"}
    assert digest() == before
