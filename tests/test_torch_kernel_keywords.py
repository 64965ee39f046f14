"""Port parity: the kernel wrappers take the reference wrappers' tile and
``interpret`` keywords (``bm``, ``bn``, ``bk`` of ``amat_matmul``,
``amat_expert_matmul`` and ``expert_matmul``, through ``**kw`` of their
``_qt`` / ``_t`` forms; ``bq``, ``bk`` of ``flash_attention``).

The tile sweeps of ``tests/test_kernels.py`` (its ``:57``, ``:82``,
``:173-174``, ``:241``, ``:254`` and ``:272``) on the port's CPU path:
at every tile of a sweep the port's output must equal the JAX wrapper's
(its Pallas kernel in interpret mode) at the same tile, at atol 1e-4.
On a CPU tensor the port's wrappers run their plain versions whatever
the tile, so these cases hold the port against the reference's kernel
at each of its tilings.  On the card the wrappers' plans choose the
tiling, so these keywords choose no tile there either.  ``interpret=True`` runs the plain
version, ``interpret=False`` on a CPU tensor raises.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels._build import launches_kernel
from repro_torch.kernels.amat_matmul import ops as AOPS
from repro_torch.kernels.amat_matmul.ref import amat_matmul_ref
from repro_torch.kernels.expert_matmul import ops as EOPS
from repro_torch.kernels.flash_attn import ops as FOPS
from repro_torch.quant.groupquant import quantize

torch.set_num_threads(1)


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _qt(shape, seed):
    return quantize(_normal(shape, seed, 0.1), bits=8, group_size=32,
                    asymmetric=True)


def _jnp(t):
    import jax.numpy as jnp

    return jnp.asarray(t.numpy())


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


# -------------------------------------------------------------- amat_matmul
def test_amat_matmul_block_size_invariance():
    """``tests/test_kernels.py:57``."""
    from repro.kernels.amat_matmul.ops import amat_matmul as j_amat

    x, qt = _normal((64, 128), 1), _qt((128, 64), 2)
    args = (x, qt.codes, qt.scales, qt.zero_points)
    for bm, bn, bk in [(16, 16, 32), (64, 64, 64), (32, 64, 128)]:
        _close(AOPS.amat_matmul(*args, bm=bm, bn=bn, bk=bk),
               j_amat(*map(_jnp, args), bm=bm, bn=bn, bk=bk))


@pytest.mark.parametrize("M", [1, 7, 130])
def test_amat_matmul_ragged_m_at_fixed_tiles(M):
    """``tests/test_kernels.py:82``: M that is no multiple of ``bm``,
    through the wrapper with the reference test's tiles."""
    from repro.kernels.amat_matmul.kernel import amat_matmul_pallas

    x, qt = _normal((M, 64), 3), _qt((64, 128), 4 + M)
    args = (x, qt.codes, qt.scales, qt.zero_points)
    out = AOPS.amat_matmul(*args, bm=128, bn=128, bk=64, interpret=True)
    assert out.shape == (M, 128)
    _close(out, amat_matmul_ref(*args), atol=1e-3)
    _close(out, amat_matmul_pallas(*map(_jnp, args), bm=128, bn=128,
                                   bk=64, interpret=True), atol=1e-3)


def test_amat_matmul_qt_passes_keywords_on():
    """The ``_qt`` form passes its tiles on: the port against the JAX
    wrapper at the same tile."""
    from repro.kernels.amat_matmul.ops import amat_matmul as j_amat

    x, qt = _normal((8, 64), 5), _qt((64, 32), 6)
    args = (x, qt.codes, qt.scales, qt.zero_points)
    got = AOPS.amat_matmul_qt(x, qt, shift=4, mode="low", bm=16, bn=32,
                              bk=32, interpret=True)
    _close(got, j_amat(*map(_jnp, args), shift=4, mode="low", bm=16, bn=32,
                       bk=32, interpret=True))


# ------------------------------------------------------- amat_expert_matmul
def test_amat_expert_matmul_block_size_invariance():
    """``tests/test_kernels.py:173-174``."""
    from repro.kernels.amat_matmul.ops import amat_expert_matmul_qt as j_qt
    from repro.quant.groupquant import QuantizedTensor as JQT

    x, qt = _normal((2, 32, 128), 7), _qt((2, 128, 64), 8)
    ul = torch.tensor([True, False])
    jqt = JQT(_jnp(qt.codes), _jnp(qt.scales), _jnp(qt.zero_points), 8, 32,
              True)
    for bm, bn, bk in [(16, 16, 32), (32, 64, 64), (128, 128, 128)]:
        _close(AOPS.amat_expert_matmul_qt(x, qt, ul, shift=4, bm=bm, bn=bn,
                                          bk=bk),
               j_qt(_jnp(x), jqt, _jnp(ul), shift=4, bm=bm, bn=bn, bk=bk))


def test_amat_expert_matmul_t_passes_keywords_on():
    """The ``_t`` form passes its tiles on: the port against the JAX
    wrapper's transposed form at the same tile."""
    from repro.kernels.amat_matmul.ops import amat_expert_matmul_t as j_t

    x, qt = _normal((3, 9, 64), 9), _qt((3, 64, 48), 10)
    ul = torch.tensor([False, True, False])
    ct = qt.codes.transpose(-1, -2).contiguous()
    args = (x, ct, qt.scales, qt.zero_points, ul)
    got = AOPS.amat_expert_matmul_t(*args, shift=4, bm=8, bn=16, bk=32,
                                    interpret=True)
    _close(got, j_t(*map(_jnp, args), shift=4, bm=8, bn=16, bk=32,
                    interpret=True))


# ------------------------------------------------------------ expert_matmul
@pytest.mark.parametrize("tiles", [(16, 16, 32), (128, 128, 128)], ids=str)
def test_expert_matmul_takes_tiles(tiles):
    """The port at each tile against the JAX wrapper at the same tile."""
    from repro.kernels.expert_matmul.ops import expert_matmul as j_em

    bm, bn, bk = tiles
    x, qt = _normal((4, 16, 64), 11), _qt((4, 64, 32), 12)
    ul = torch.arange(4) % 2 == 0
    args = (x, qt.codes, qt.scales, qt.zero_points, ul)
    _close(EOPS.expert_matmul_qt(x, qt, ul, shift=4, bm=bm, bn=bn, bk=bk),
           j_em(*map(_jnp, args), shift=4, bm=bm, bn=bn, bk=bk))


# ---------------------------------------------------------- flash_attention
DIMS = [(1, 16, 16, 4, 2, 32, True, None),
        (2, 24, 40, 8, 2, 32, True, None),
        (1, 17, 33, 4, 4, 64, True, 8),
        (1, 16, 16, 4, 2, 32, False, None)]


def _qkv(B, Sq, Sk, H, Hkv, D, seed):
    return (_normal((B, Sq, H, D), seed), _normal((B, Sk, Hkv, D), seed + 1),
            _normal((B, Sk, Hkv, D), seed + 2))


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_flash_matches_ref_at_8x8_tiles(dims):
    """``tests/test_kernels.py:241``: the port against the JAX wrapper,
    both at 8x8 tiles."""
    from repro.kernels.flash_attn.ops import flash_attention as j_flash

    B, Sq, Sk, H, Hkv, D, causal, win = dims
    q, k, v = _qkv(B, Sq, Sk, H, Hkv, D, seed=sum(dims[:6]))
    out = FOPS.flash_attention(q, k, v, causal=causal, sliding_window=win,
                               bq=8, bk=8)
    _close(out, j_flash(*map(_jnp, (q, k, v)), causal=causal,
                        sliding_window=win, bq=8, bk=8))


def test_flash_block_size_invariance():
    """``tests/test_kernels.py:254``."""
    from repro.kernels.flash_attn.ops import flash_attention as j_flash

    q, k, v = _qkv(1, 32, 32, 4, 2, 32, seed=20)
    for bq, bk in [(8, 8), (16, 32), (32, 16)]:
        _close(FOPS.flash_attention(q, k, v, bq=bq, bk=bk),
               j_flash(*map(_jnp, (q, k, v)), bq=bq, bk=bk))


@pytest.mark.parametrize("seed", range(10))
def test_flash_random_shapes_at_8x8_tiles(seed):
    """``tests/test_kernels.py:272`` (its ten examples as a seeded grid):
    the port against the JAX wrapper, both at 8x8 tiles."""
    from repro.kernels.flash_attn.ops import flash_attention as j_flash

    rng = np.random.default_rng(seed)
    sq, sk = (int(n) for n in rng.integers(4, 25, size=2))
    q, k, v = _qkv(1, sq, sk, 2, 2, 16, seed=100 + seed)
    if sq > sk:        # every query row keeps a visible key (the contract)
        q = q[:, :sk]
    _close(FOPS.flash_attention(q, k, v, bq=8, bk=8),
           j_flash(*map(_jnp, (q, k, v)), bq=8, bk=8))


# ----------------------------------------------------------------- routing
def _calls():
    x, qt = _normal((2, 8, 64), 30), _qt((2, 64, 32), 31)
    ul = torch.tensor([True, False])
    q, k, v = _qkv(1, 8, 8, 2, 2, 16, seed=32)
    return {
        "amat_matmul": lambda **kw: AOPS.amat_matmul(
            x[0], qt.codes[0], qt.scales[0], qt.zero_points[0], **kw),
        "amat_matmul_qt": lambda **kw: AOPS.amat_matmul_qt(
            x[0], quantize(_normal((64, 32), 33) * 0.1), **kw),
        "amat_expert_matmul": lambda **kw: AOPS.amat_expert_matmul(
            x, qt.codes, qt.scales, qt.zero_points, ul, **kw),
        "amat_expert_matmul_qt": lambda **kw: AOPS.amat_expert_matmul_qt(
            x, qt, ul, shift=4, **kw),
        "amat_expert_matmul_t": lambda **kw: AOPS.amat_expert_matmul_t(
            x, qt.codes.transpose(-1, -2).contiguous(), qt.scales,
            qt.zero_points, ul, shift=4, **kw),
        "expert_matmul": lambda **kw: EOPS.expert_matmul(
            x, qt.codes, qt.scales, qt.zero_points, ul, **kw),
        "expert_matmul_qt": lambda **kw: EOPS.expert_matmul_qt(
            x, qt, ul, shift=4, **kw),
        "flash_attention": lambda **kw: FOPS.flash_attention(q, k, v, **kw),
    }


@pytest.mark.parametrize("name", sorted(_calls()))
def test_interpret_routes_on_the_cpu(name):
    call = _calls()[name]
    plain = call()
    assert torch.equal(call(interpret=True), plain)
    with pytest.raises(ValueError, match="interpret=False"):
        call(interpret=False)


def test_launch_rule():
    cpu = torch.zeros(1)
    assert launches_kernel("k", cpu, None) is False
    assert launches_kernel("k", cpu, True) is False
    with pytest.raises(ValueError, match="interpret=False on a cpu"):
        launches_kernel("k", cpu, False)
    meta = torch.zeros(1, device="meta")
    for interpret in (None, True, False):
        with pytest.raises(ValueError, match="no path for device"):
            launches_kernel("k", meta, interpret)
