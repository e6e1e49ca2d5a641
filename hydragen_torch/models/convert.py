"""Carry a parameter set across from numpy.

``params_from_numpy`` takes the JAX package's parameter tree after each leaf
was taken to numpy (a quantized weight as its ``(q, scale)`` or ``(qp,
gscale)`` named pair) and returns the port's parameter dict, so both
packages can compute the same model from the same numbers. It reads numpy
arrays only and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from hydragen_torch.ops.quant import Quantized4Tensor, QuantizedTensor

# A quantized weight node by its field names: int8 (q, scale), int4 (qp,
# gscale). Both are 2-tuples, so the names are what tells them apart.
_WEIGHT_CLASSES = {cls._fields: cls for cls in (QuantizedTensor, Quantized4Tensor)}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy -> torch, bfloat16 arrays (ml_dtypes) included."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def params_from_numpy(tree, device=None):
    """Convert a (nested) dict of numpy arrays. A named pair with fields
    ``(q, scale)`` becomes a ``QuantizedTensor`` and one with ``(qp,
    gscale)`` a ``Quantized4Tensor``; an unnamed 2-tuple is taken as ``(q,
    scale)``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2:
        cls = _WEIGHT_CLASSES.get(getattr(tree, "_fields", None), None)
        if cls is None:
            if hasattr(tree, "_fields"):
                raise ValueError(f"unknown quantized weight fields {tree._fields}")
            cls = QuantizedTensor
        return cls(*(tensor_from_numpy(x, device) for x in tree))
    return tensor_from_numpy(tree, device)
