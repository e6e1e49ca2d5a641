"""Capacity accounting, timing, profiling, results and small utilities,
exported under the JAX package's names (``hydragen_tpu.utils``)."""

from hydragen_torch.utils.misc import dtype_map, mean, rdiff, std
from hydragen_torch.utils.timing import timed
from hydragen_torch.utils.results import (
    MicrobenchmarkResult,
    NeedlesBenchmarkResult,
    SynthBenchmarkResult,
    dataclass_from_dict,
    dataclass_to_dict,
    load_yaml_dataclass,
    save_yaml_dataclass,
    split_range,
)

__all__ = [
    "rdiff",
    "mean",
    "std",
    "dtype_map",
    "timed",
    "MicrobenchmarkResult",
    "SynthBenchmarkResult",
    "NeedlesBenchmarkResult",
    "dataclass_to_dict",
    "dataclass_from_dict",
    "save_yaml_dataclass",
    "load_yaml_dataclass",
    "split_range",
]
