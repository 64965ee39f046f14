"""Weight bridge: the JAX package's parameters onto the port's tensors.

The port keeps the reference's parameter tree and stacked layout, so the
mapping is one leaf to one leaf.  ``torch.Generator`` cannot reproduce
``jax.random``, so the two packages share weights as one numpy tree: the
JAX package's own (``jax.tree.map(np.asarray, params)``), or one the
parity tests draw once and hand to both, carried across with
:func:`params_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """One array onto ``device``, bf16 (numpy's ``ml_dtypes`` bfloat16,
    which ``torch.from_numpy`` does not take) carried as its bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device=None):
    """Map a nested dict of numpy arrays onto torch tensors on ``device``
    (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor_from_numpy(tree, dev)
