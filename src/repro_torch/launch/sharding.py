"""Sharding rules: param-tree path -> partition spec (port of
``repro.launch.sharding``).

The rules, their divisibility filter and the stacked-prefix rule are the
reference's, verbatim: every rule is filtered against the actual
dimension sizes, and an axis that doesn't divide the dim is dropped.  A
partition spec is a tuple with one entry per dimension (``None``, an
axis name, or a tuple of axis names).

The port runs on one device and has no SPMD partitioner, so a spec here
shapes: :class:`NamedSharding` gives each device's shard shape (as
``jax.sharding.NamedSharding.shard_shape``), which the dry-run sums into
its per-device argument bytes.  ``shard_hint`` is the identity (see its
docstring).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import Mesh

AxisSpec = Union[None, str, Tuple[str, ...]]

_CURRENT_MESH: Optional[Mesh] = None


class PartitionSpec(tuple):
    """One axis entry per dimension, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes: AxisSpec):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def _prod(sizes) -> int:
    n = 1
    for s in sizes:
        n *= int(s)
    return n


def _axis_size(mesh, axis: AxisSpec) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis] if axis in mesh.axis_names else 0
    return _prod(_axis_size(mesh, a) for a in axis)


def sanitize_spec(mesh, shape: Sequence[int],
                  spec: Sequence[AxisSpec]) -> PartitionSpec:
    """Drop axes that are absent from the mesh or don't divide the dim."""
    clean = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            clean.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a in mesh.axis_names)
        size = _prod(mesh.shape[a] for a in axes) if axes else 1
        if axes and size > 0 and dim % size == 0:
            clean.append(axes[0] if len(axes) == 1 else axes)
        else:
            # try prefixes (e.g. ('pod','data') -> ('pod',))
            ok = None
            for i in range(len(axes) - 1, 0, -1):
                sub = axes[:i]
                size = _prod(mesh.shape[a] for a in sub)
                if dim % size == 0:
                    ok = sub[0] if len(sub) == 1 else sub
                    break
            clean.append(ok)
    return P(*clean)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``'s
    fields): which mesh axes split each dimension."""

    mesh: Mesh
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> tuple:
        """One device's block of a ``global_shape`` array."""
        out = []
        for i, dim in enumerate(global_shape):
            ax = self.spec[i] if i < len(self.spec) else None
            n = _axis_size(self.mesh, ax)
            if n <= 0 or dim % n:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} "
                                 f"does not split over {ax!r} ({n})")
            out.append(dim // n)
        return tuple(out)


def shard_hint(x, *spec: AxisSpec):
    """The identity.  The reference's hint is
    ``with_sharding_constraint`` against the current mesh and a no-op
    without one; the port runs on one device with no partitioner to
    constrain, and its model calls no hint (``models/moe.py``)."""
    return x


# --------------------------------------------------------------------------
# Parameter sharding rules
# --------------------------------------------------------------------------
# (path regex, spec-from-ndim) — first match wins.  Specs are given for the
# *unstacked* shape; a leading period/layer-stack dim is auto-prepended.
_RULES = [
    # embeddings: vocab -> model, d_model -> data
    (r"embed$", ("model", "data")),
    (r"unembed$", ("data", "model")),
    # attention projections
    (r"(wq|wk|wv|c_wq|c_wk|c_wv)$", ("data", "model")),
    (r"(wo|c_wo)$", ("model", "data")),
    (r"(bq|bk|bv)$", ("model",)),
    # dense mlp
    (r"mlp/wi$", ("data", "model")),
    (r"mlp/wo$", ("model", "data")),
    # shared experts
    (r"shared/wi$", ("data", "model")),
    (r"shared/wo$", ("model", "data")),
    # moe
    (r"w_router$", ("data", None)),
    (r"experts/wi$", ("model", "data", None)),
    (r"experts/wo$", ("model", None, "data")),
    # AMAT-quantized serve-form experts: wi codes shard on the output dim
    # (N), wo codes on the contraction dim (F), aligned with the
    # N-sharded activation of the first product.
    (r"experts/wi_(codes|scales|zps)$", ("model", None, "data")),
    (r"experts/wo_(codes|scales|zps)$", ("model", "data", None)),
    # ssm
    (r"ssm/in_proj$", ("data", "model")),
    (r"ssm/out_proj$", ("model", "data")),
    (r"ssm/conv_w$", (None, "model")),
    (r"ssm/conv_b$", ("model",)),
    (r"ssm/(A_log|D|dt_bias)$", (None,)),
    # norms / everything 1-D: replicated
    (r".*", (None,)),
]

_STACKED_PREFIX = re.compile(r"blocks/pos\d+/|encoder/blocks/")


def param_spec(path: str, shape: Tuple[int, ...]) -> Tuple[AxisSpec, ...]:
    """Raw (unsanitized) axis spec for a param path."""
    stacked = bool(_STACKED_PREFIX.search(path))
    core_ndim = len(shape) - (1 if stacked else 0)
    for pat, spec in _RULES:
        if re.search(pat, path):
            spec = tuple(spec)[:core_ndim]
            spec = spec + (None,) * (core_ndim - len(spec))
            return ((None,) + spec) if stacked else spec
    return (None,) * len(shape)


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, int) for i in x)


def tree_paths(tree) -> list:
    """Flatten a pytree into ('a/b/c', leaf) pairs.

    Int-tuples (shape tuples) count as leaves, matching the ``is_leaf``
    used when flattening shape trees.
    """
    out = []

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)) and not _is_shape(node):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))
    rec(tree, ())
    return out


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, keeping its structure (the
    paths of :func:`tree_paths`)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k],
                                 f"{path}/{k}" if path else str(k))
                for k in sorted(tree)}
    return fn(path, tree)


def param_shardings(mesh, shapes_tree) -> dict:
    """Map a param-shapes tree to a NamedSharding tree (same structure)."""
    return map_with_path(
        lambda path, shape: NamedSharding(
            mesh, sanitize_spec(mesh, shape, param_spec(path, shape))),
        shapes_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
