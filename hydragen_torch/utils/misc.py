"""Small utilities. Port of ``hydragen_tpu.utils.misc``: the same
functions, with ``dtype_map`` onto torch dtypes."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def rdiff(a, b) -> float:
    """Mean symmetric relative difference: mean of 2|a - b| / (|a| + |b| +
    1e-9), in float64."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float((2 * np.abs(a - b) / (np.abs(a) + np.abs(b) + 1e-9)).mean())


def mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs)


def std(xs: Sequence[float]) -> float:
    m = mean(xs)
    return math.sqrt(sum((x - m) ** 2 for x in xs) / len(xs))


dtype_map = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}
