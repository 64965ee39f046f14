"""Pytree checkpointing in the reference's on-disk format (port of
``repro.checkpoint.ckpt``).

A checkpoint directory holds ``manifest.msgpack`` (``n_leaves``,
``treedef``, ``metas``, ``step``, ``structure``) and one ``leaf_{i}.npy``
per leaf, numbered in the reference's leaf order (dict keys sorted, lists
and tuples in order); bf16 leaves are stored as their uint16 bit pattern.
Either package reads what the other wrote.

* ``save(path, tree)``     — leaves may be torch tensors (any device) or
  numpy arrays;
* ``restore(path)``        — torch tensors on ``device`` (``cuda`` unless
  told otherwise), dtypes and the nested dict/list/tuple structure kept;
* ``save_sharded`` / ``restore_sharded`` add a per-process suffix.

The manifest goes through the package's own MessagePack subset
(:mod:`repro_torch.checkpoint._codec`), so no ``msgpack`` install is
needed.  ``treedef`` is informational (``restore`` never reads it); the
port writes the same ``PyTreeDef(...)`` text the reference writes.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _codec
from repro_torch.device import resolve_device

_BF16 = "bfloat16"
_MANIFEST = "manifest.msgpack"


def _flatten(tree, leaves: list):
    """Collect the leaves in the reference's order; return the index tree's
    ``structure`` record and its ``PyTreeDef`` text."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k], leaves) for k in keys]
        return ({"__kind__": "dict",
                 "items": {k: p[0] for k, p in zip(keys, parts)}},
                "{" + ", ".join(f"{k!r}: {p[1]}"
                                for k, p in zip(keys, parts)) + "}")
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, leaves) for v in tree]
        items = ", ".join(p[1] for p in parts)
        if isinstance(tree, list):
            text = f"[{items}]"
        else:
            text = f"({items},)" if len(parts) == 1 else f"({items})"
        return ({"__kind__": type(tree).__name__,
                 "items": [p[0] for p in parts]}, text)
    leaves.append(tree)
    return {"__kind__": "leaf", "index": len(leaves) - 1}, "*"


def _to_numpy(x):
    """(array to write, dtype name): bf16 as its uint16 bit pattern."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _from_numpy(x: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.astype(dtype) if str(x.dtype) != dtype else x)
    return t.to(device)


def save(path: str, tree: Any, *, step: int | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    leaves: list = []
    structure, text = _flatten(tree, leaves)
    metas = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(path, f"leaf_{i}.npy"), arr)
        metas.append({"shape": list(arr.shape), "dtype": dtype})
    manifest = {
        "n_leaves": len(leaves),
        "treedef": f"PyTreeDef({text})",
        "metas": metas,
        "step": step,
        "structure": structure,
    }
    with open(os.path.join(path, _MANIFEST), "wb") as f:
        f.write(_codec.packb(manifest))


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, _MANIFEST), "rb") as f:
        return _codec.unpackb(f.read())


def _decode_structure(node, leaves):
    kind = node["__kind__"]
    if kind == "dict":
        return {k: _decode_structure(v, leaves)
                for k, v in node["items"].items()}
    if kind == "list":
        return [_decode_structure(v, leaves) for v in node["items"]]
    if kind == "tuple":
        return tuple(_decode_structure(v, leaves) for v in node["items"])
    return leaves[node["index"]]


def restore(path: str, device=None) -> Any:
    dev = resolve_device(device)
    manifest = _read_manifest(path)
    leaves = []
    for i, meta in enumerate(manifest["metas"]):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        leaves.append(_from_numpy(arr, meta["dtype"], dev))
    return _decode_structure(manifest["structure"], leaves)


def restore_step(path: str) -> int | None:
    return _read_manifest(path).get("step")


def save_sharded(path: str, tree: Any, process_idx: int,
                 *, step: int | None = None) -> None:
    save(os.path.join(path, f"proc_{process_idx:05d}"), tree, step=step)


def restore_sharded(path: str, process_idx: int, device=None) -> Any:
    return restore(os.path.join(path, f"proc_{process_idx:05d}"), device)
