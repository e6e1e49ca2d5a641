"""A cell and its inputs: the entry of ``BENCHMARK.json`` found by name, the
files it names (configuration, traffic mix, limits), and the seeded inputs
both the program and the reference are given (weights on the device, token
ids on the host). Nothing here imports the program."""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

# The keys of a configuration file that are the model's own (its published
# config.json); the rest of the file says how it is served.
MODEL_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "rms_norm_eps", "rope_theta",
              "max_position_embeddings", "tie_word_embeddings")


@dataclass
class Cell:
    name: str
    root: Path  # the directory holding BENCHMARK.json
    entry: dict  # its entry in ``workloads``
    config: dict
    traffic: dict
    limits: dict
    bench: dict  # the whole of BENCHMARK.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def bench_dir(self) -> Path:
        """Where the cell's traffic, metrics and limits files lie: the
        directory of its configuration file's parent (``<dir>/configs/``)."""
        return (self.root / self.config_entry["file"]).parent.parent

    @property
    def config_entry(self) -> dict:
        return next(c for c in self.bench["configs"] if c["name"] == self.entry["config"])


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    base = (root / cfg_entry["file"]).parent.parent
    traffic = json.loads((base / "traffic" / f"{entry['traffic']}.json").read_text())
    limits_file = base / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(name, root, entry, config, traffic, limits, bench)


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one stream of a run's inputs (weights, a call's
    ids, arrivals, the sample), from ``--seed`` and the stream's name; any
    whole number is taken."""
    h = hashlib.sha256(repr((int(seed),) + tuple(stream)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *stream))


def make_weights(config: dict, seed: int, device) -> dict:
    """The model's weights from ``seed``, made on ``device`` in a few large
    calls, in the type they are served in: each projection an int8 payload
    ``[L, N, K]`` (uniform over [-127, 127]) with an f32 scale a (layer,
    output channel) drawn around ``1 / (73.6 sqrt(K))`` (so a weight's
    standard deviation is near ``1 / sqrt(K)``), the LM head likewise, a bf16
    embedding of unit normal entries and bf16 norm weights around 1. This is
    the layout a w8a8 checkpoint load gives (f32 scales, the MLP unpadded)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "weights"))
    H, I = int(config["hidden_size"]), int(config["intermediate_size"])
    L, V = int(config["num_hidden_layers"]), int(config["vocab_size"])
    nh, nkv = int(config["num_attention_heads"]), int(config["num_key_value_heads"])
    hd = H // nh

    def int8(shape, K):
        q = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
        s = torch.rand(shape[:-1], generator=g, device=device, dtype=torch.float32)
        return q, (s * 0.5 + 0.75) / (73.6 * math.sqrt(K))

    def norm(shape):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return (1.0 + 0.1 * x).to(torch.bfloat16)

    w = {
        "embed": torch.randn((V, H), generator=g, device=device, dtype=torch.float32).to(
            torch.bfloat16),
        "input_norm": norm((L, H)),
        "post_attn_norm": norm((L, H)),
        "final_norm": norm((H,)),
        "lm_head": int8((V, H), H),
    }
    for fam, N, K in (("wq", nh * hd, H), ("wk", nkv * hd, H), ("wv", nkv * hd, H),
                      ("wo", H, nh * hd), ("gate", I, H), ("up", I, H), ("down", H, I)):
        w[fam] = int8((L, N, K), K)
    return w


def token_ids(r: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Token ids uniform over ``[1, vocab)``, int32."""
    return r.integers(1, vocab, size=shape, dtype=np.int32)
