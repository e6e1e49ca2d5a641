"""A tiny benchmark written from scratch into a directory: a configuration,
two traffic mixes, a metric reader, limits and ``BENCHMARK.json`` naming two
cells, all new files (nothing of the repository's ``portbench/`` data is
read). The CPU tests run the harness on it."""

from __future__ import annotations

import json
from pathlib import Path

CONFIG = {
    "name": "tiny", "source": "a test configuration",
    "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 384,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "max_position_embeddings": 4096,
    "tie_word_embeddings": False, "reduced": [],
    "serving": {"weights": "w8a8", "kv_cache": "int8", "compute_dtype": "bfloat16",
                "chips": 1, "deployment": "a test"},
}
GEN = {"kind": "generate", "shared_tokens": 40, "rows": 16, "suffix_tokens": 8,
       "new_tokens": 16, "sample_rows": 8, "trace_call": 1}
SERVE = {"kind": "serve", "shared_tokens": 32, "pool_rows": 8, "ring_slots": 40, "chunk": 4,
         "bucket": 8, "admit_policy": "lpt", "lookahead": 1, "suffix_tokens": [4, 16],
         "new_tokens": [6, 16], "rate_per_s": 20.0, "drain_s": 30, "sample_requests": 12,
         "trace_from": 0.3, "trace_s": 0.3}
# A reader of the harness's own records (no device trace on the CPU).
METRIC = '''"""calls_per_s.gen (1/s): whole generate calls a second of the window."""


def read(rec):
    calls = rec.driver.calls
    return len(calls) / (calls[-1][1] - calls[0][0])
'''
# Set as a cell's limits are (PERF.md), from readings on the CPU at this size
# (two threads, 1 s windows): the program's mean gap over seeds 1-12 read at
# most 0.0015 (generate) and 0.0017 (serve), the control's over seeds 1-6 at
# least 0.0173 and 0.0185.
LIMITS = {"mean_gap": 0.006, "failed": 0}


def make_bench(root: Path, config: dict = CONFIG, gen: dict = GEN, serve: dict = SERVE,
               limits: dict = LIMITS) -> Path:
    base = Path(root) / "bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    (base / "configs" / "tiny.json").write_text(json.dumps(config))
    (base / "traffic" / "tinygen.json").write_text(json.dumps(gen))
    (base / "traffic" / "tinyserve.json").write_text(json.dumps(serve))
    (base / "metrics" / "calls_per_s.gen.py").write_text(METRIC)
    for cell in ("tiny-gen", "tiny-serve"):
        (base / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = {
        "command": ["python3", "portbench/run.py"], "paths": ["bench"], "run_seconds": 1,
        "configs": [{"name": "tiny", "source": "a test", "file": "bench/configs/tiny.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [
            {"name": "tiny-gen", "config": "tiny", "traffic": "tinygen", "chips": 1,
             "why": "a test"},
            {"name": "tiny-serve", "config": "tiny", "traffic": "tinyserve", "chips": 1,
             "why": "a test"}],
        "end_to_end": [
            {"name": "gen_tok_s", "unit": "tokens/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny-gen"]},
            {"name": "ttft_p95_s", "unit": "s", "better": "lower", "bound": 0.1,
             "source": "host_clock", "workloads": ["tiny-serve"]},
            {"name": "tpot_p95_ms", "unit": "ms", "better": "lower", "bound": 0.1,
             "source": "host_clock", "workloads": ["tiny-serve"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            {"name": "calls_per_s.gen", "unit": "1/s", "better": "higher",
             "source": "host_clock", "layer": "engine", "moves": "gen_tok_s"},
            {"name": "submit_lag_p95_s.serve", "unit": "s", "better": "lower",
             "source": "host_clock", "layer": "scheduler", "moves": "ttft_p95_s",
             "workloads": ["tiny-serve"]}],
    }
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(bench))
    return Path(root)
