"""Port parity: AdamW and its learning-rate schedules.

The same numpy params and grads go through the reference's
``apply_updates`` and the port's (which updates in place).  Params,
moments and master copy must agree at rtol 1e-6 after 5 steps, for f32
and bf16 params, with the f32 master copy on and off and gradient
clipping on and off; the schedules at rtol 1e-6.

With clipping, every gradient is scaled by ``grad_clip / global_norm``,
and the global norm sums its squares in another order in each package
(one f32 ulp apart).  A moment entry whose terms cancel toward zero
carries that ulp at the scale of its terms, not at its own; so with
clipping the tolerance is rtol 1e-6 of each leaf's largest entry
(elementwise rtol 1e-6 without clipping).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JO
from repro_torch.optim import adamw as TO

torch.set_num_threads(1)

RTOL = 1e-6


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup, total", [(10, 100), (1, 7), (0, 40)])
def test_schedule_lr_matches_reference(schedule, warmup, total):
    kw = dict(lr=2e-3, warmup_steps=warmup, total_steps=total,
              schedule=schedule)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    steps = sorted({0, max(warmup - 1, 0), warmup, (warmup + total) // 2,
                    total, total + 5})
    for s in steps:
        want = float(JO.schedule_lr(jc, jnp.asarray(s, jnp.int32)))
        got = TO.schedule_lr(tc, s)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=str(s))


def _tree(rng, dtype):
    """Matrices, a stacked ``[2, d]`` norm (weight-decayed: ndim 2) and a
    bias vector (not decayed)."""
    return {
        "blocks": {"w": rng.standard_normal((2, 8, 6)).astype(np.float32),
                   "norm": 0.1 * rng.standard_normal((2, 6)).astype(
                       np.float32)},
        "bias": rng.standard_normal((5,)).astype(np.float32),
        "embed": rng.standard_normal((11, 6)).astype(np.float32),
    }


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    return TO.tree_map(lambda a: torch.from_numpy(a.copy()).to(dtype), tree)


def _pairs(jtree, ttree):
    """(port leaf, reference leaf) in the reference's leaf order."""
    return zip(TO.tree_leaves(ttree), jax.tree_util.tree_leaves(jtree))


def _close(ttree, jtree, what, clipped):
    for t, j in _pairs(jtree, ttree):
        want = np.asarray(j, np.float32)
        atol = RTOL * np.abs(want).max() if clipped else 0.0
        np.testing.assert_allclose(t.to(torch.float32).numpy(), want,
                                   rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("master_f32", [True, False],
                         ids=["master", "no_master"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clip", "no_clip"])
def test_apply_updates_matches_reference(dtype, master_f32, grad_clip):
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    grads = [_tree(rng, dtype) for _ in range(5)]
    kw = dict(lr=1e-2, grad_clip=grad_clip, master_f32=master_f32,
              warmup_steps=2, total_steps=5)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    jp = _jax(params, jdt)
    js = JO.init_state(jp, jc)
    tp = _torch(params, tdt)
    ts = TO.init_state(tp, tc)
    for g in grads:
        jp, js, jm = JO.apply_updates(jp, _jax(g, jdt), js, jc)
        tp, ts, tm = TO.apply_updates(tp, _torch(g, tdt), ts, tc)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=RTOL)
    assert ts.step == int(js.step) == 5
    for t, j in _pairs(jp, tp):
        assert str(t.dtype).endswith(dtype)
        assert np.asarray(j).dtype == jdt
    clipped = grad_clip > 0
    _close(tp, jp, "params", clipped)
    _close(ts.mu, js.mu, "mu", clipped)
    _close(ts.nu, js.nu, "nu", clipped)
    if master_f32:
        _close(ts.master, js.master, "master", clipped)
    else:
        assert ts.master is None and js.master is None


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = _tree(rng, "float32")
    np.testing.assert_allclose(
        float(TO.global_norm(_torch(tree, torch.float32))),
        float(JO.global_norm(_jax(tree, jnp.float32))), rtol=RTOL)
