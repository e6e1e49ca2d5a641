"""Benchmark result dataclasses, YAML persistence, and the sweep grammar.

Port of ``hydragen_tpu.utils.results``, field for field: a YAML written by
either package loads in the other, and either ``summarize_sweep`` reads
both. One YAML file per swept configuration keeps a sweep resumable (a
point whose file exists is skipped).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from hydragen_torch.utils.misc import mean, std


@dataclass
class TimingStats:
    times: List[float]
    warmup_times: List[float] = field(default_factory=list)

    @property
    def mean(self) -> float:
        return mean(self.times)

    @property
    def std(self) -> float:
        return std(self.times)

    @property
    def rstd(self) -> float:
        return self.std / self.mean if self.mean else 0.0


@dataclass
class MicrobenchmarkResult:
    """Attention-op kernel timing, seconds per call."""

    batch_size: int
    num_shared: int
    num_unique: int
    num_qheads: int
    num_kvheads: int
    head_dim: int
    mode: str  # "hydragen" | "baseline"
    times: List[float] = field(default_factory=list)
    warmup_times: List[float] = field(default_factory=list)

    @property
    def mean_time(self) -> float:
        return mean(self.times)

    @property
    def std_time(self) -> float:
        return std(self.times)

    @property
    def rstd(self) -> float:
        return self.std_time / self.mean_time if self.mean_time else 0.0


@dataclass
class SynthBenchmarkResult:
    """End-to-end synthetic sweep point, seconds per ``generate`` call."""

    mode: str
    batch_size: int
    num_shared: int
    num_unique: int
    model: str = ""
    times: List[float] = field(default_factory=list)
    warmup_times: List[float] = field(default_factory=list)
    prefill_times: List[float] = field(default_factory=list)

    @property
    def mean_time(self) -> float:
        return mean(self.times)

    @property
    def throughput(self) -> float:
        """Decode throughput in completed tokens/s."""
        return self.batch_size * self.num_unique / self.mean_time

    @property
    def rstd(self) -> float:
        m = self.mean_time
        return std(self.times) / m if m else 0.0


@dataclass
class NeedlesBenchmarkResult:
    """Needle-in-a-haystack point."""

    num_questions: int
    haystack_chars: int
    num_correct: int = 0
    accuracy_by_decile: List[float] = field(default_factory=list)
    counts_by_decile: List[int] = field(default_factory=list)
    shared_prefill_time: float = 0.0
    unique_prefill_time: float = 0.0
    decode_times: List[float] = field(default_factory=list)

    @property
    def accuracy(self) -> float:
        total = sum(self.counts_by_decile)
        return self.num_correct / total if total else 0.0


# ---------------------------------------------------------------------------
# dataclass <-> dict <-> YAML
# ---------------------------------------------------------------------------

def dataclass_to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: dataclass_to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [dataclass_to_dict(x) for x in obj]
    return obj


def dataclass_from_dict(cls, data: dict):
    # Under `from __future__ import annotations` f.type is a *string*; resolve
    # the real types once so nested dataclasses round-trip instead of silently
    # reconstructing as plain dicts.
    import typing

    try:
        hints = typing.get_type_hints(cls)
    except Exception:  # unresolvable forward refs: fall back to raw f.type
        hints = {}
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            val = data[f.name]
            ftype = hints.get(f.name, f.type)
            if dataclasses.is_dataclass(ftype) and isinstance(val, dict):
                val = dataclass_from_dict(ftype, val)
            kwargs[f.name] = val
    return cls(**kwargs)


def save_yaml_dataclass(obj, path) -> None:
    import yaml

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(dataclass_to_dict(obj), f, sort_keys=False)


def load_yaml_dataclass(cls, path):
    import yaml

    with open(path) as f:
        return dataclass_from_dict(cls, yaml.safe_load(f))


# ---------------------------------------------------------------------------
# Sweep grammar
# ---------------------------------------------------------------------------

def split_range(spec: str) -> List[int]:
    """Parse the sweep mini-grammar:

    - ``"a,b,c"``      -> [a, b, c]
    - ``"s:e:xK"``     -> exponential: s, s*K, ... < e (inclusive of e)
    - ``"s:e:step"``   -> arithmetic: s, s+step, ... <= e
    - ``"s:e"``        -> step 1
    - ``"n"``          -> [n]
    """
    spec = str(spec)
    if "," in spec:
        return [int(x) for x in spec.split(",") if x != ""]
    if ":" not in spec:
        return [int(spec)]
    parts = spec.split(":")
    start, end = int(parts[0]), int(parts[1])
    out = []
    if len(parts) == 3 and parts[2].startswith("x"):
        k = int(parts[2][1:])
        cur = start
        while cur <= end:
            out.append(cur)
            cur *= k
    else:
        step = int(parts[2]) if len(parts) == 3 else 1
        out = list(range(start, end + 1, step))
    return out
