"""Port parity: activation checkpointing per period (``remat_policy``).

The reference wraps each period of ``forward`` in ``jax.checkpoint``
(``"dots"``: ``checkpoint_dots_with_no_batch_dims``; any other value:
recompute everything); the port runs each period under
``torch.utils.checkpoint.checkpoint`` while gradients are recorded.  One
small f32 config of each family the reference checkpoints: MoE
(``qwen15-moe-repro`` at 2 layers), dense with a window and soft-capping
(``gemma-7b`` reduced, ``always_swa`` at an 8-token window over 16),
hybrid (``jamba-v0.1-52b`` reduced: SSM and MoE in one period), prefix
(``internvl2-1b`` reduced) and encoder-decoder (``whisper-small``
reduced), one numpy tree of weights shared by both packages.

* Gradients of ``lm_loss`` under ``"full"`` and ``"dots"`` equal the
  un-checkpointed route's (``_remat=False``) bit for bit, and the
  reference's ``jax.value_and_grad`` under the same policy at the
  tolerances of ``tests/test_torch_train.py`` (loss 1e-5; every leaf
  atol 1e-5 + rtol 1e-4).
* Backward calls each period body once more; without gradients nothing
  is checkpointed; the aux rows (``collect_trace`` ids and gates too)
  come back the same.
* ``"dots"`` saves the products the reference's policy saves, product
  by product (sizes of the no-batch ``dot_general``s inside the
  reference's checkpoint against the port's ``MUST_SAVE`` products), and
  its backward recomputes no no-batch product but does recompute
  attention's and the routed experts' batched ones.
* ``make_train_step`` under each policy takes the plain route's step.
* A missing ``create_selective_checkpoint_contexts`` raises; nothing
  falls back to ``"full"``.
"""

import collections
import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as jget
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO

torch.set_num_threads(1)

# family -> (arch, reduced, overrides)
FAMILIES = {
    "moe": ("qwen15-moe-repro", False, {"n_layers": 2}),
    "dense_window_softcap": ("gemma-7b", True,
                             {"always_swa": True, "sliding_window": 8}),
    "hybrid": ("jamba-v0.1-52b", True, {}),
    "prefix": ("internvl2-1b", True, {}),
    "encdec": ("whisper-small", True, {}),
}
POLICIES = ["full", "dots"]
B, S = 2, 16
A = torch.ops.aten


@dataclasses.dataclass
class Family:
    name: str
    jcfg: object
    tcfg: object
    tree: dict
    tokens: np.ndarray
    labels: np.ndarray
    extras: dict

    def t_cfg(self, policy):
        return dataclasses.replace(self.tcfg, remat_policy=policy)

    def t_params(self):
        return params_from_numpy(self.tree, "cpu")

    def t_extras(self):
        return {k: torch.from_numpy(v) for k, v in self.extras.items()}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    arch, reduced, over = FAMILIES[request.param]
    cfgs = []
    for get in (jget, tget):
        cfg = get(arch).reduced() if reduced else get(arch)
        cfgs.append(dataclasses.replace(cfg, dtype="float32", **over))
    jcfg, tcfg = cfgs
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S))
    labels = rng.integers(0, tcfg.vocab_size, (B, S))
    extras = {}
    if tcfg.prefix_len:
        extras["prefix_embeds"] = rng.standard_normal(
            (B, tcfg.prefix_len, tcfg.d_model)).astype(np.float32)
    if tcfg.is_encdec:
        extras["encoder_frames"] = rng.standard_normal(
            (B, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    return Family(request.param, jcfg, tcfg, tree, tokens, labels, extras)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _grads(fam, policy, remat=True):
    """(loss, [grad per leaf]) of the port's ``lm_loss``."""
    params = fam.t_params()
    leaves = list(TO.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TM.lm_loss(params, fam.t_cfg(policy), _t(fam.tokens),
                         _t(fam.labels), _remat=remat, **fam.t_extras())
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module")
def plain(family):
    return _grads(family, "full", remat=False)


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_equal_the_plain_route(family, plain, policy):
    loss, grads = _grads(family, policy)
    assert torch.equal(loss, plain[0])
    assert len(grads) == len(plain[1])
    for i, (got, want) in enumerate(zip(grads, plain[1])):
        assert torch.equal(got, want), (family.name, policy, i)


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_match_reference(family, policy):
    cfg = dataclasses.replace(family.jcfg, remat_policy=policy)
    extras = {k: jnp.asarray(v) for k, v in family.extras.items()}

    def j_loss(p):
        return JM.lm_loss(p, cfg, jnp.asarray(family.tokens),
                          jnp.asarray(family.labels), **extras)

    (jl, _), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, family.tree))
    loss, grads = _grads(family, policy)
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-5, rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(grads)
    for (path, want), got in zip(jleaves, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture
def counted(monkeypatch):
    """Counts of ``_period`` calls and of checkpoints entered."""
    n = collections.Counter()
    period, checkpoint = TM._period, TM.CK.checkpoint

    def period_(*a, **kw):
        n["period"] += 1
        return period(*a, **kw)

    def checkpoint_(*a, **kw):
        n["checkpoint"] += 1
        return checkpoint(*a, **kw)

    monkeypatch.setattr(TM, "_period", period_)
    monkeypatch.setattr(TM.CK, "checkpoint", checkpoint_)
    return n


# "save_nothing" stands for any value but "dots": the reference recomputes
# everything then.
@pytest.mark.parametrize("policy", ["full", "dots", "save_nothing"])
def test_backward_calls_each_period_once_more(family, counted, policy):
    params = family.t_params()
    leaves = list(TO.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TM.lm_loss(params, family.t_cfg(policy), _t(family.tokens),
                         _t(family.labels), **family.t_extras())
    n_periods = family.tcfg.n_periods
    assert counted == {"period": n_periods, "checkpoint": n_periods}
    torch.autograd.grad(loss, leaves)
    assert counted == {"period": 2 * n_periods, "checkpoint": n_periods}


def test_unknown_policy_recomputes_everything(family, plain, monkeypatch):
    def no_policy(*a, **kw):
        raise AssertionError("the dots policy ran")

    monkeypatch.setattr(TM, "_dots_policy", no_policy)
    loss, grads = _grads(family, "save_nothing")
    assert torch.equal(loss, plain[0])
    assert all(torch.equal(a, b) for a, b in zip(grads, plain[1]))


@pytest.mark.parametrize("route", ["no_grad", "unrematerialized"])
def test_no_checkpoint_without_gradients(family, counted, route):
    params = family.t_params()
    toks = _t(family.tokens)
    if route == "no_grad":
        with torch.no_grad():
            h, _ = TM.forward(params, family.tcfg, toks, **family.t_extras())
    else:
        for p in TO.tree_leaves(params):
            p.requires_grad_(True)
        h, _ = TM.forward(params, family.tcfg, toks, _remat=False,
                          **family.t_extras())
    assert counted == {"period": family.tcfg.n_periods}
    assert h.requires_grad == (route != "no_grad")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["moe", "hybrid"])
def test_aux_rows_come_back_the_same(name, policy):
    arch, reduced, over = FAMILIES[name]
    cfg = tget(arch).reduced() if reduced else tget(arch)
    cfg = dataclasses.replace(cfg, dtype="float32", remat_policy=policy,
                              **over)
    params = TM.init_params(cfg, seed=0, device="cpu")
    for p in TO.tree_leaves(params):
        p.requires_grad_(True)
    toks = _t(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    got = TM.forward(params, cfg, toks, collect_trace=True)
    want = TM.forward(params, cfg, toks, collect_trace=True, _remat=False)
    assert torch.equal(got[0], want[0])
    assert set(got[1]["moe"]) == set(want[1]["moe"]) >= {
        "aux_loss", "dropped_frac", "ids", "gates"}
    for k, v in want[1]["moe"].items():
        assert got[1]["moe"][k].dtype == v.dtype, k
        assert torch.equal(got[1]["moe"][k], v), k
    assert torch.equal(got[1]["aux_loss"], want[1]["aux_loss"])


# --------------------------------------------------------------------------
# "dots" against the reference's rule, product by product
# --------------------------------------------------------------------------
def _jax_checkpointed_dots(cfg, params, tokens, extras):
    """Counter of (saved, work) over the ``dot_general``s inside the
    reference's checkpointed period body, ``saved`` by its own policy,
    ``work`` the product's multiply-adds; counted once per period."""
    closed = jax.make_jaxpr(lambda p: JM.forward(p, cfg, tokens, **extras))(
        params)
    found = collections.Counter()

    def walk(jaxpr, policy):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("checkpoint", "remat2"):
                walk(eqn.params["jaxpr"], eqn.params["policy"])
                continue
            if eqn.primitive.name == "dot_general" and policy is not None:
                (lc, _), _ = eqn.params["dimension_numbers"]
                lhs = eqn.invars[0].aval.shape
                work = math.prod(eqn.outvars[0].aval.shape) * math.prod(
                    lhs[i] for i in lc)
                saved = bool(policy(eqn.primitive,
                                    *[v.aval for v in eqn.invars],
                                    **eqn.params))
                found[(saved, work)] += 1
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if hasattr(sub, "eqns"):
                        walk(sub, policy)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr, policy)

    walk(closed.jaxpr, None)
    return found


def _work(op, args):
    """Multiply-adds of an ``aten`` matrix product."""
    a, b = (args[1], args[2]) if op in (A.addmm.default,
                                        A.baddbmm.default) else args[:2]
    return math.prod(a.shape) * b.shape[-1]


PRODUCTS = {A.mm.default, A.addmm.default, A.bmm.default, A.baddbmm.default}


def test_dots_saves_the_references_products(family, monkeypatch):
    decided = collections.Counter()
    policy = TM._dots_policy

    def recorded(ctx, op, *args, **kw):
        out = policy(ctx, op, *args, **kw)
        if op in PRODUCTS and not ctx.is_recompute:
            saved = out == TM.CK.CheckpointPolicy.MUST_SAVE
            decided[(saved, _work(op, args), op)] += 1
        return out

    monkeypatch.setattr(TM, "_dots_policy", recorded)
    _grads(family, "dots")
    n_periods = family.tcfg.n_periods
    cfg = dataclasses.replace(family.jcfg, remat_policy="dots")
    ref = _jax_checkpointed_dots(
        cfg, jax.tree.map(jnp.asarray, family.tree),
        jnp.asarray(family.tokens),
        {k: jnp.asarray(v) for k, v in family.extras.items()})
    saved = collections.Counter()
    for (s, work, op), n in decided.items():
        assert s == (op in (A.mm.default, A.addmm.default)), op
        if s:
            saved[work] += n
    want = collections.Counter({work: n * n_periods
                                for (s, work), n in ref.items() if s})
    assert saved == want
    assert any(not s for s, _ in ref), "the reference recomputes no product"
    assert any(not s for s, _, _ in decided)


class _Products(TorchDispatchMode):
    """Counter of (op, multiply-adds) of every matrix product it sees."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            kind = "mm" if func in (A.mm.default, A.addmm.default) else "bmm"
            self.seen[(kind, _work(func, args))] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(fam, policy, remat=True):
    params = fam.t_params()
    leaves = list(TO.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TM.lm_loss(params, fam.t_cfg(policy), _t(fam.tokens),
                         _t(fam.labels), _remat=remat, **fam.t_extras())
    with _Products() as mode:
        torch.autograd.grad(loss, leaves)
    return mode.seen


def _period_products(fam, monkeypatch):
    """The products of the periods' forward on the plain route."""
    mode = _Products()
    period = TM._period

    def recorded(*a, **kw):
        with mode:
            return period(*a, **kw)

    monkeypatch.setattr(TM, "_period", recorded)
    _grads(fam, "full", remat=False)
    monkeypatch.setattr(TM, "_period", period)
    return mode.seen


def test_backward_recomputes_what_the_policy_leaves(family, monkeypatch):
    """Over backward, the products beyond the plain route's are the
    recomputed ones: under "dots" every batched product of the periods
    and no no-batch one, attention's score and value products (and the
    routed experts' where the family has them) among them; under "full"
    the no-batch products too."""
    cfg = family.tcfg
    forward = _period_products(family, monkeypatch)
    base = _backward_products(family, "full", remat=False)
    extra = {p: _backward_products(family, p) - base for p in POLICIES}
    assert extra["dots"] == collections.Counter(
        {k: n for k, n in forward.items() if k[0] == "bmm"})
    assert any(kind == "mm" for kind, _ in extra["full"])
    assert not extra["dots"] - extra["full"]
    n_q = S + (cfg.prefix_len if "prefix_embeds" in family.extras else 0)
    attn = B * cfg.n_heads * n_q * n_q * cfg.head_dim
    # Whisper's cross-attention has as many keys (encoder_seq) as queries.
    n_attn = sum(spec.mixer == "attn" for spec in cfg.block_pattern) * (
        2 if cfg.is_encdec else 1)
    assert cfg.encoder_seq in (0, S)
    assert extra["dots"][("bmm", attn)] == 2 * n_attn * cfg.n_periods
    moe_pos = [i for i, spec in enumerate(cfg.block_pattern)
               if spec.ffn == "moe"]
    if moe_pos:
        wi = family.tree["blocks"][f"pos{moe_pos[0]}"]["moe"]["experts"][
            "wi"]
        E, d, f = wi.shape[1:]
        C = TM.M.capacity(B * n_q, cfg.moe.top_k, E,
                          cfg.moe.capacity_factor)
        n = len(moe_pos) * cfg.n_periods
        assert extra["dots"][("bmm", E * C * d * f)] == n
        assert extra["dots"][("bmm", E * C * cfg.moe.d_ff * d)] == n


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["moe", "hybrid"])
def test_train_step_under_each_policy_takes_the_plain_step(name, policy):
    arch, reduced, over = FAMILIES[name]
    cfg = tget(arch).reduced() if reduced else tget(arch)
    cfg = dataclasses.replace(cfg, dtype="float32", remat_policy=policy,
                              **over)
    opt_cfg = TO.AdamWConfig(lr=2e-3, total_steps=3, warmup_steps=1)
    rng = np.random.default_rng(2)
    batch = {"tokens": _t(rng.integers(0, cfg.vocab_size, (B, S))),
             "labels": _t(rng.integers(0, cfg.vocab_size, (B, S)))}
    params = TM.init_params(cfg, seed=0, device="cpu")
    ref = copy.deepcopy(params)
    params, _, metrics = make_train_step(cfg, opt_cfg)(
        params, TO.init_state(params, opt_cfg), batch)

    # The plain route by hand: make_train_step's body with _remat=False.
    leaves = list(TO.tree_leaves(ref))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TM.lm_loss(ref, cfg, batch["tokens"], batch["labels"],
                         _remat=False)
    flat = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    grads = TO.tree_map(lambda _: next(flat), ref)
    ref, _, _ = TO.apply_updates(ref, grads, TO.init_state(ref, opt_cfg),
                                 opt_cfg)
    assert torch.equal(metrics["loss"], loss.detach())
    for a, b in zip(TO.tree_leaves(params), TO.tree_leaves(ref)):
        assert torch.equal(a, b)


def test_dots_needs_selective_checkpointing(monkeypatch):
    """Without ``create_selective_checkpoint_contexts`` "dots" raises; it
    never falls back to recomputing everything."""
    cfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                              dtype="float32", remat_policy="dots")
    params = TM.init_params(cfg, seed=0, device="cpu")
    for p in TO.tree_leaves(params):
        p.requires_grad_(True)
    monkeypatch.delattr(TM.CK, "create_selective_checkpoint_contexts")
    toks = _t(np.zeros((B, S), dtype=np.int64))
    with pytest.raises(AttributeError,
                       match="create_selective_checkpoint_contexts"):
        TM.lm_loss(params, cfg, toks, toks)
