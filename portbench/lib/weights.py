"""The model's float weights, made on the device from the seed.

The benchmark makes the weights itself and hands the same tree to the
program and to the plain reference (which makes it again after the
window, from the same seed).  The tree's layout is the program's input
format, which each configuration's model module (``portbench/models/``)
gives as a tree of shapes; the MoE layer's leaves, which every module
shares, are ``moe_shapes``.  The draws follow the program's rule (vectors
zero, matrices normal at ``fan_in ** -0.5``; a module may fix other
leaves, as the SSD mixer's) but are the benchmark's own numbers: in the
sorted order of the tree's keys, one ``torch.randn`` per period of a
stacked leaf (one for a leaf that is not stacked), in the model's dtype,
from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def gated(mlp_type: str) -> bool:
    return mlp_type in ("swiglu", "geglu")


def mlp_shapes(d: int, f: int, mlp_type: str) -> dict:
    return {"wi": (d, 2 * f if gated(mlp_type) else f), "wo": (f, d)}


def moe_shapes(cfg: dict) -> dict:
    """The MoE layer's leaves: router, routed experts, shared experts."""
    d, moe = cfg["d_model"], cfg["moe"]
    E, f = moe["n_experts"], moe["d_ff"]
    wi_cols = 2 * f if gated(moe["mlp_type"]) else f
    sh = {"moe": {"w_router": (d, E),
                  "experts": {"wi": (E, d, wi_cols), "wo": (E, f, d)}}}
    if moe.get("n_shared_experts", 0) > 0:
        sh["moe"]["shared"] = mlp_shapes(d, moe.get("d_ff_shared") or f,
                                         moe["mlp_type"])
    sh["moe_norm"] = (d,)
    return sh


def stack(tree: dict, n: int) -> dict:
    return {k: stack(v, n) if isinstance(v, dict) else (n,) + tuple(v)
            for k, v in tree.items()}


# A leaf's own rule: a tensor to use as it is (no draw), the standard
# deviation of its draw, or None for the common rule.
Rule = Callable[[tuple, tuple, torch.device],
                Optional[Union[torch.Tensor, float]]]


@torch.no_grad()
def draw(shapes: dict, seed: int, device, dtype: str,
         rule: Optional[Rule] = None) -> dict:
    """The weight tree of ``shapes`` for ``seed`` on ``device``, in
    ``dtype``.  Leaves under the top-level key ``blocks`` are stacked over
    their first axis and drawn one slice at a time; ``rule(path, shape,
    device)`` overrides the common rule for the leaves it knows."""
    dt = DTYPES[dtype]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 97) % (2 ** 63))

    def leaf(path: tuple, shape: tuple, is_stacked: bool) -> torch.Tensor:
        core = shape[1:] if is_stacked else shape
        own = rule(path, shape, device) if rule is not None else None
        if isinstance(own, torch.Tensor):
            return own
        if own is None and len(core) == 1:
            return torch.zeros(shape, dtype=dt, device=device)
        std = core[-2] ** -0.5 if own is None else own
        out = torch.empty(shape, dtype=dt, device=device)
        for part in (out.view(shape[0], -1) if is_stacked else [out]):
            torch.randn(part.shape, generator=gen, out=part)
            part.mul_(std)
        return out

    def build(tree: dict, path: tuple, is_stacked: bool) -> dict:
        out = {}
        for k in sorted(tree):
            v, sub = tree[k], path + (k,)
            st = is_stacked or (not path and k == "blocks")
            out[k] = build(v, sub, st) if isinstance(v, dict) \
                else leaf(sub, v, st)
        return out

    return build(shapes, (), False)
