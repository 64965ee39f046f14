"""Port parity: the checkpoint format and its MessagePack codec.

The port writes and reads the reference's on-disk format without the
``msgpack`` package.  Exact in every check: the codec's bytes against
``msgpack.packb``'s, and every leaf, bit for bit, across the two packages
in both directions.
"""

import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro_torch.checkpoint import _codec
from repro_torch.checkpoint import ckpt as TCK

torch.set_num_threads(1)


def _np_tree(seed):
    """A nested dict / list / tuple tree over bf16, f32, int32, int8 and
    bool leaves (bf16 as ``jnp`` arrays: numpy has no bf16 of its own)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w_bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
            "stack": [rng.standard_normal((2, 4)).astype(np.float32),
                      {"ids": rng.integers(-9, 9, (6,)).astype(np.int32),
                       "codes": rng.integers(-128, 128, (4, 4)).astype(
                           np.int8)}],
            "pair": (rng.random((5,)) < 0.5,
                     jnp.asarray(rng.standard_normal((2, 2, 2)),
                                 jnp.bfloat16)),
        },
        "scalar": np.float32(1.25) * np.ones((), np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes with its shape and dtype name, for exact
    comparison (bf16 compared as its uint16 pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return ("bfloat16", x.view(torch.int16).numpy().view(np.uint16))
        return (str(x.numpy().dtype), x.numpy())
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return ("bfloat16", a.view(np.uint16))
    return (str(a.dtype), a)


def _assert_trees_bit_equal(got, want):
    assert type(got) is type(want) or (
        isinstance(got, torch.Tensor) and not isinstance(
            want, (dict, list, tuple))), (type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)      # restored in sorted order
        for k in want:
            _assert_trees_bit_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_bit_equal(g, w)
    else:
        (gd, ga), (wd, wa) = _bits(got), _bits(want)
        assert gd == wd and ga.shape == wa.shape
        np.testing.assert_array_equal(ga, wa)


# ------------------------------------------------------------------ codec
EDGE_VALUES = [
    {}, [], (), None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
    2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2**31, -2**31 - 1, -2**63, 0.5, -1e300, "", "x" * 31, "x" * 32,
    "x" * 256, "x" * 70000, "naïve",
    list(range(15)), list(range(16)), list(range(2**16)),
    {f"k{i}": i for i in range(15)}, {f"k{i}": -i for i in range(16)},
    {f"k{i}": [i, None] for i in range(2**16 + 1)},
    {"step": None, "metas": [{"shape": [], "dtype": "bool"}]},
]


@pytest.mark.parametrize("value", EDGE_VALUES,
                         ids=[f"v{i}" for i in range(len(EDGE_VALUES))])
def test_codec_bytes_equal_msgpack(value):
    want = msgpack.packb(value)
    assert _codec.packb(value) == want
    assert _codec.unpackb(want) == msgpack.unpackb(want)


def test_codec_rejects_other_types_and_trailing_bytes():
    for value in ({"a": np.int64(3)}, b"raw", {"a": {1.5}}):
        with pytest.raises(TypeError):
            _codec.packb(value)
    with pytest.raises(ValueError):
        _codec.unpackb(msgpack.packb(1) + b"\x00")


def test_codec_on_real_manifests(tmp_path):
    """A manifest the reference wrote: decoded equal to ``msgpack``'s
    reading, and re-encoded to the same bytes."""
    JCK.save(str(tmp_path), _np_tree(0), step=12)
    raw = (tmp_path / "manifest.msgpack").read_bytes()
    manifest = _codec.unpackb(raw)
    assert manifest == msgpack.unpackb(raw)
    assert _codec.packb(manifest) == raw
    JCK.save(str(tmp_path / "nostep"), _np_tree(1))
    raw = (tmp_path / "nostep" / "manifest.msgpack").read_bytes()
    assert _codec.unpackb(raw)["step"] is None
    assert _codec.packb(_codec.unpackb(raw)) == raw


# ----------------------------------------------------- the on-disk format
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_save_port_restore(tmp_path, seed):
    tree = _np_tree(seed)
    JCK.save(str(tmp_path), tree, step=seed)
    got = TCK.restore(str(tmp_path), device="cpu")
    _assert_trees_bit_equal(got, _to_torch(tree))
    assert TCK.restore_step(str(tmp_path)) == seed


@pytest.mark.parametrize("seed", [0, 1])
def test_port_save_reference_restore(tmp_path, seed):
    tree = _to_torch(_np_tree(seed))
    TCK.save(str(tmp_path), tree, step=None if seed else 40)
    got = JCK.restore(str(tmp_path))
    _assert_trees_bit_equal(_to_torch(got), tree)
    assert JCK.restore_step(str(tmp_path)) == (None if seed else 40)


def test_port_manifest_bytes_equal_reference(tmp_path):
    """The port's manifest, ``treedef`` text included, is the reference's
    byte for byte, and so is every leaf file."""
    tree = _np_tree(2)
    JCK.save(str(tmp_path / "j"), tree, step=3)
    TCK.save(str(tmp_path / "t"), _to_torch(tree), step=3)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_port_round_trip_and_restore_step(tmp_path):
    tree = _to_torch(_np_tree(3))
    TCK.save(str(tmp_path), tree, step=7)
    _assert_trees_bit_equal(TCK.restore(str(tmp_path), device="cpu"), tree)
    assert TCK.restore_step(str(tmp_path)) == 7


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sharded_round_trip(tmp_path, writer):
    trees = [_np_tree(s) for s in (4, 5)]
    for idx, tree in enumerate(trees):
        if writer == "port":
            TCK.save_sharded(str(tmp_path), _to_torch(tree), idx, step=idx)
        else:
            JCK.save_sharded(str(tmp_path), tree, idx, step=idx)
    assert sorted(os.listdir(tmp_path)) == ["proc_00000", "proc_00001"]
    for idx, tree in enumerate(trees):
        _assert_trees_bit_equal(
            TCK.restore_sharded(str(tmp_path), idx, device="cpu"),
            _to_torch(tree))
        _assert_trees_bit_equal(
            _to_torch(JCK.restore_sharded(str(tmp_path), idx)),
            _to_torch(tree))
        assert TCK.restore_step(str(tmp_path / f"proc_{idx:05d}")) == idx


def test_restore_defaults_to_the_card(tmp_path):
    """``restore`` runs on ``cuda`` unless told otherwise; without a card
    that raises instead of falling back to the CPU."""
    TCK.save(str(tmp_path), {"a": torch.ones(2)})
    if torch.cuda.is_available():
        assert TCK.restore(str(tmp_path))["a"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TCK.restore(str(tmp_path))
