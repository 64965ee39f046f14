"""Spec stand-ins for every model input (port of ``repro.launch.specs``).

``input_specs(cfg, shape, mesh)`` returns the full argument tree of the
step function that the shape kind selects (train / prefill / decode).
Its leaves are :class:`TensorSpec` records, the counterpart of the
reference's ``jax.ShapeDtypeStruct``: a global shape, a dtype and, under
a mesh, the :class:`~repro_torch.launch.sharding.NamedSharding` that
gives each device's shard.  :func:`materialize` turns such a tree into
``meta`` tensors (the dry-run: every shape traced through the step,
nothing allocated) or into tensors on a device, and
:func:`argument_size_in_bytes` sums one device's shard bytes.

The dtype rules are the reference's (``_F32_PARAM``, ``_U8_PARAM``;
tokens and the cache position int32), and so is the decode ring cap
(a ``ring_kv`` config with a window sizes its cache at the window).  Two
departures: the optimizer's step counter is a host int in the port
(``optim/adamw.py``), so ``opt_specs`` holds ``0`` where the reference
holds an int32 scalar; and the port's ``init_cache`` makes ``pos``
int64, where the spec keeps the reference's int32 (``decode_step`` takes
either).

Modality stubs (the one allowed carve-out): VLM prefix patch-embeddings
and whisper encoder frame-embeddings enter here as ready-made
``[B, P, d_model]`` float tensors.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.sharding import (NamedSharding, map_with_path,
                                         param_spec, sanitize_spec)
from repro_torch.models import model as MDL
from repro_torch.optim.adamw import AdamWConfig, AdamWState

_F32_PARAM = re.compile(r"ssm/(A_log|D|dt_bias)$|_scales$")
_U8_PARAM = re.compile(r"_(codes|zps)$")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One input tensor that is not allocated: its global shape and dtype,
    the sharding of its shards under a mesh (``None``: whole on every
    device), and how :func:`materialize` fills it on a real device
    (``zeros``; ``normal``, the init rule of ``init_params``; ``index``,
    uniform integers below ``high``)."""

    shape: tuple
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None
    fill: str = "zeros"
    high: int = 0

    @property
    def local_shape(self) -> tuple:
        """One device's block of the tensor."""
        if self.sharding is None:
            return tuple(self.shape)
        return self.sharding.shard_shape(self.shape)

    @property
    def local_nbytes(self) -> int:
        return math.prod(self.local_shape) * self.dtype.itemsize


def _param_dtype(path: str, cfg) -> torch.dtype:
    if _U8_PARAM.search(path):
        return torch.uint8
    if _F32_PARAM.search(path):
        return torch.float32
    return MDL._dt(cfg)


def _sds(shape, dtype, mesh, spec, fill: str = "zeros",
         high: int = 0) -> TensorSpec:
    shape = tuple(int(s) for s in shape)
    sharding = None if mesh is None else NamedSharding(
        mesh, sanitize_spec(mesh, shape, spec))
    return TensorSpec(shape, dtype, sharding, fill, high)


def param_specs(cfg: ModelConfig, mesh):
    """Spec tree matching init_params (dtypes included)."""
    def leaf(path, shape):
        dtype = _param_dtype(path, cfg)
        return _sds(shape, dtype, mesh, param_spec(path, shape),
                    fill="index" if dtype == torch.uint8 else "normal",
                    high=256)
    return map_with_path(leaf, MDL.param_shapes(cfg))


def _map_specs(fn, tree):
    """``fn`` over the :class:`TensorSpec` leaves of a tree of dicts and
    tuples (named tuples included), other leaves kept."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    if isinstance(tree, TensorSpec):
        return fn(tree)
    return tree


def spec_leaves(tree) -> list:
    """The :class:`TensorSpec` leaves of a tree, in its order."""
    out = []
    _map_specs(out.append, tree)
    return out


def opt_specs(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig):
    """AdamWState spec tree (f32 moments/master shard like their params);
    the step counter is the port's host int."""
    p = param_specs(cfg, mesh)

    def as_f32(s):
        return dataclasses.replace(s, dtype=torch.float32, fill="zeros")
    mu = _map_specs(as_f32, p)
    nu = _map_specs(as_f32, p)
    master = _map_specs(as_f32, p) if opt_cfg.master_f32 else None
    return AdamWState(step=0, mu=mu, nu=nu, master=master)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Training / prefill batch inputs."""
    B, S = shape.global_batch, shape.seq_len
    bspec = ("pod", "data")
    dtype = MDL._dt(cfg)
    out = {}
    s_text = S - cfg.prefix_len if cfg.prefix_len else S
    out["tokens"] = _sds((B, s_text), torch.int32, mesh, (bspec, None),
                         "index", cfg.vocab_size)
    if shape.kind == "train":
        out["labels"] = _sds((B, s_text), torch.int32, mesh, (bspec, None),
                             "index", cfg.vocab_size)
    if cfg.prefix_len:
        out["prefix_embeds"] = _sds((B, cfg.prefix_len, cfg.d_model),
                                    dtype, mesh, (bspec, None, None),
                                    "normal")
    if cfg.is_encdec:
        out["encoder_frames"] = _sds((B, cfg.encoder_seq, cfg.d_model),
                                     dtype, mesh, (bspec, None, None),
                                     "normal")
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int, mesh) -> dict:
    """Decode-state spec tree.  KV: batch->data, seq->model (flash-decoding
    style partial-softmax sharding); SSM state: batch->data, heads->model."""
    shapes = MDL.init_cache(cfg, batch, max_seq, device="meta")

    def attach(path, t):
        if path.endswith("pos"):
            return _sds(t.shape, torch.int32, mesh, ())
        if re.search(r"/(k|v)$", path):
            spec = (None, "data", "model", None, None)
        elif re.search(r"/(k_scale|v_scale)$", path):
            spec = (None, "data", "model", None)
        elif re.search(r"/(ck|cv)$", path):
            spec = (None, "data", None, "model", None)
        elif path.endswith("state"):
            spec = (None, "data", "model", None, None)
        elif path.endswith("conv"):
            spec = (None, "data", None, "model")
        else:
            spec = (None,) * len(t.shape)
        return _sds(t.shape, t.dtype, mesh, spec)

    return map_with_path(attach, shapes)


def decode_token_specs(cfg: ModelConfig, batch: int, mesh) -> TensorSpec:
    return _sds((batch,), torch.int32, mesh, ("data",), "index",
                cfg.vocab_size)


def decode_extra_specs(cfg: ModelConfig, batch: int, mesh) -> dict:
    out = {}
    if cfg.is_encdec:
        out["encoder_frames"] = _sds(
            (batch, cfg.encoder_seq, cfg.d_model), MDL._dt(cfg), mesh,
            ("data", None, None), "normal")
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                opt_cfg: Optional[AdamWConfig] = None):
    """Full argument tree for the shape's step function.

    train   -> (params, opt_state, batch)
    prefill -> (params, batch)
    decode  -> (params, cache, token, extras)
    """
    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        return (param_specs(cfg, mesh), opt_specs(cfg, mesh, opt_cfg),
                batch_specs(cfg, shape, mesh))
    if shape.kind == "prefill":
        return (param_specs(cfg, mesh), batch_specs(cfg, shape, mesh))
    if shape.kind == "decode":
        max_seq = shape.seq_len
        if cfg.ring_kv and cfg.sliding_window:
            max_seq = min(max_seq, cfg.sliding_window)
        return (param_specs(cfg, mesh),
                cache_specs(cfg, shape.global_batch, max_seq, mesh),
                decode_token_specs(cfg, shape.global_batch, mesh),
                decode_extra_specs(cfg, shape.global_batch, mesh))
    raise ValueError(shape.kind)


def argument_size_in_bytes(tree) -> int:
    """One device's bytes of a spec tree: the sum of its leaves' shards
    (the counterpart of XLA's ``argument_size_in_bytes``)."""
    return sum(s.local_nbytes for s in spec_leaves(tree))


def materialize(tree, device="meta", *, seed: int = 0):
    """The tensors of a spec tree on ``device``, in their global shapes.
    On ``meta`` nothing is allocated.  Elsewhere each leaf is filled as
    its ``fill`` says, from one generator seeded with ``seed``: ``normal``
    leaves of two or more dimensions (and a last dimension above 1) draw
    from N(0, 1) times ``shape[-2] ** -0.5`` (``init_params``'s rule),
    other ``normal`` leaves and ``zeros`` leaves are zeros, ``index``
    leaves are uniform below ``high``."""
    dev = torch.device(device)
    if dev.type == "meta":
        return _map_specs(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device=dev), tree)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(s: TensorSpec) -> torch.Tensor:
        if s.fill == "index":
            return torch.randint(0, s.high, s.shape, generator=gen,
                                 device=dev, dtype=s.dtype)
        if s.fill == "normal" and len(s.shape) >= 2 and s.shape[-1] != 1:
            t = torch.randn(s.shape, generator=gen, device=dev,
                            dtype=s.dtype)
            return t.mul_(s.shape[-2] ** -0.5)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    return _map_specs(make, tree)
