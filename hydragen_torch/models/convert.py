"""Carry a parameter set across from numpy.

``params_from_numpy`` takes the JAX package's parameter tree after each leaf
was taken to numpy (a quantized weight as its ``(q, scale)`` pair) and
returns the port's parameter dict, so both packages can compute the same
model from the same numbers. It reads numpy arrays only and imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from hydragen_torch.ops.quant import QuantizedTensor


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy -> torch, bfloat16 arrays (ml_dtypes) included."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def params_from_numpy(tree, device=None):
    """Convert a (nested) dict of numpy arrays; a 2-tuple ``(q, scale)`` leaf
    becomes a ``QuantizedTensor``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2:
        q, scale = tree
        return QuantizedTensor(q=tensor_from_numpy(q, device),
                               scale=tensor_from_numpy(scale, device))
    return tensor_from_numpy(tree, device)
