"""Port parity: the ``hybrid`` and ``ssm`` architectures served, replayed,
trained and checkpointed (``jamba-v0.1-52b`` and ``mamba2-2.7b``
reduced).

* Jamba (period-8 pattern, attention at position 3, MoE FFNs at the odd
  positions) at f32 served by both packages' continuous-batching
  schedulers with quantized execution, 3 requests at ``max_batch=2`` (a
  slot retired and installed again mid-run, SSM ``state`` and ``conv``
  included): tokens, each decode step's access and miss counts, each
  request's cache stats and the miss curve exact, ledger totals at rtol
  1e-6 (``_torch_parity.run_both``).  The port's
  recorded trace carries ``moe_positions=(1, 3, 5, 7)`` and replays, in
  both packages, to the port's live run.
* ``mamba2-2.7b`` (no MoE) through both packages' ``SliceMoEServer``,
  which serve it on ``PlainEngine``; the tokens equal.
* The serving CLI with ``--arch jamba-v0.1-52b --reduced`` and ``--arch
  mamba2-2.7b --reduced`` on one checkpoint: the port's JSON lines equal
  the reference CLI's (the wall seconds left out).
* Three steps of the port's ``train_loop`` on ``mamba2-2.7b`` reduced
  (bf16): finite losses, and each f32 SSM leaf a tensor apart from its
  f32 master copy (``tests/test_system.py:201-212``'s counterpart).
* The f32 ``A_log`` / ``D`` / ``dt_bias`` leaves of a bf16 tree cross
  the bridge and the checkpoint of either package bit for bit, keeping
  their dtype.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import REF, run_both
from repro.checkpoint import ckpt as JCK
from repro.configs.base import get_config
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.core.engine import PersistentEngine as JPE
from repro.launch import serve as JSERVE
from repro.models.moe import RoutingPolicy as JRP
from repro.serving import scheduler as JSC
from repro.serving import server as JSV
from repro.sim import Trace as JTrace
from repro.sim import TraceRecorder as JRecorder
from repro.sim import replay_trace as j_replay
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as TCK
from repro_torch.configs import base as TC
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.launch import serve as TSERVE
from repro_torch.launch.train import train_loop
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.optim import adamw as TO
from repro_torch.serving import scheduler as TSC
from repro_torch.serving import server as TSV
from repro_torch.sim import Trace, TraceRecorder, replay_trace

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

JAMBA, MAMBA = "jamba-v0.1-52b", "mamba2-2.7b"
SSM_F32 = ("A_log", "D", "dt_bias")


def _cfgs(arch, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(TC.get_config(arch).reduced(), **over))


def _tree(tcfg, seed=0):
    return jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=seed, device="cpu"))


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (10, 7, 12)]


# ------------------------------------------------------------------ serving
def _jamba_run(ref: bool) -> dict:
    jcfg, tcfg = _cfgs(JAMBA)
    tree = _tree(tcfg, seed=2)
    kw = dict(mat=None, cache_bytes=1.0e6, miss_rate_target=0.1,
              warmup="pcw", max_seq=32)
    if ref:
        cfg, SC = jcfg, JSC
        engine = JPE(cfg, jax.tree.map(jnp.asarray, tree), JEC(**dict(
            kw, mat=JMat(8, 4), policy=JRP(kind="cache_prior",
                                           slice_mode="dbsc",
                                           quant_execution=True))))
        recorder, sched_kw = JRecorder(), {}
    else:
        cfg, SC = tcfg, TSC
        engine = TPE(cfg, params_from_numpy(tree, "cpu"), TEC(**dict(
            kw, mat=TMat(8, 4), policy=TRP(kind="cache_prior",
                                           slice_mode="dbsc",
                                           quant_execution=True))),
            device="cpu")
        recorder, sched_kw = TraceRecorder(), {"device": "cpu"}
    sched = SC.ContinuousBatchingScheduler(
        engine, SC.SchedulerConfig(max_batch=2, max_queue=8), **sched_kw)
    rec = sched.attach_recorder(recorder)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        sched.submit(SC.Request(request_id=i, prompt=p,
                                max_new_tokens=5 + i))
    done = sched.run()
    return {"view": {
        "tokens": {c.request_id: np.asarray(c.tokens).tolist()
                   for c in done},
        "epoch_counts": engine.cache.epoch_counts(),
        "step_counts": [s.per_tenant for s in sched.telemetry.steps],
        "request_stats": {c.request_id: c.metrics["cache_stats"]
                          for c in done},
        "miss_curve": sched.telemetry.miss_rate_curve(),
        "ledger": engine.ledger.snapshot(),
        "moe_positions": list(engine.moe_positions)},
        "trace": rec.trace()}


@pytest.fixture(scope="module")
def jamba_runs():
    runs = {}

    def view(ns):
        key = "ref" if ns is REF else "port"
        runs[key] = _jamba_run(ref=ns is REF)
        return runs[key]["view"]

    run_both(view)
    return runs


def test_jamba_served_by_both_packages(jamba_runs):
    port = jamba_runs["port"]["view"]
    assert port["moe_positions"] == [1, 3, 5, 7]
    assert sorted(port["tokens"]) == [0, 1, 2]
    assert [len(port["tokens"][i]) for i in range(3)] == [5, 6, 7]
    assert port["ledger"]["total_energy_j"] > 0
    steps = port["step_counts"]
    assert len(steps) == len(port["miss_curve"]) > 0
    assert sum(s["default"]["misses"] for s in steps) > 0
    assert all(r["msb_hits"] + r["msb_misses"] > 0
               for r in port["request_stats"].values())


def test_jamba_trace_replays_in_both_packages(jamba_runs, tmp_path):
    live = jamba_runs["port"]["view"]
    trace = jamba_runs["port"]["trace"]
    assert trace.meta.moe_positions == (1, 3, 5, 7)
    assert trace.meta.n_periods == 2 and trace.n_prefills == 3
    path = trace.save(str(tmp_path / "jamba.npz"))
    for rep in (replay_trace(Trace.load(path)),
                j_replay(JTrace.load(path))):
        assert rep.epoch_counts == live["epoch_counts"]
        assert rep.miss_curve == live["miss_curve"]
        assert set(rep.ledger) == set(live["ledger"])
        for k, want in live["ledger"].items():
            np.testing.assert_allclose(rep.ledger[k], want, rtol=1e-6,
                                       atol=1e-15, err_msg=k)


def _serve_plain(SV, cfg, params, **kw):
    server = SV.SliceMoEServer(cfg, params, engine_cfg=None, max_seq=40,
                               **kw)
    for i, p in enumerate(_prompts(cfg.vocab_size)[:2]):
        server.submit(SV.Request(request_id=i, prompt=p, max_new_tokens=6))
    done = server.run()
    assert server._engine is None
    assert all(c.metrics is None for c in done)
    return [np.asarray(c.tokens).tolist() for c in done]


def test_mamba2_served_on_the_plain_engine_by_both_packages():
    jcfg, tcfg = _cfgs(MAMBA)
    tree = _tree(tcfg, seed=4)
    ref = _serve_plain(JSV, jcfg, jax.tree.map(jnp.asarray, tree))
    port = _serve_plain(TSV, tcfg, params_from_numpy(tree, "cpu"),
                        device="cpu")
    assert port == ref and [len(t) for t in port] == [6, 6]
    # An engine config changes nothing for a model without MoE layers.
    ecfg = TEC(mat=TMat(8, 4))
    server = TSV.SliceMoEServer(tcfg, params_from_numpy(tree, "cpu"),
                                engine_cfg=ecfg, max_seq=40, device="cpu")
    assert not server._moe_serving()


# ---------------------------------------------------------------------- CLI
def _cli_lines(text):
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("prefill_s", "decode_s")}
            for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("arch", [JAMBA, MAMBA])
def test_cli_lines_equal_the_reference_cli(arch, tmp_path, capsys,
                                           monkeypatch):
    """``--arch ... --reduced`` on one checkpoint of the port's init (the
    config's bf16): the port's request lines equal the reference's."""
    argv = ["--arch", arch, "--reduced", "--n-requests", "2",
            "--prompt-len", "8", "--max-new", "4", "--seed", "3"]
    ckpt = str(tmp_path / "ckpt")
    TCK.save(ckpt, {"params": TM.init_params(
        TC.get_config(arch).reduced(), seed=0, device="cpu")})
    capsys.readouterr()
    TSERVE.main(argv + ["--device", "cpu", "--ckpt", ckpt])
    port = _cli_lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + ["--ckpt", ckpt])
    JSERVE.main()
    assert _cli_lines(capsys.readouterr().out) == port
    assert [line["n_tokens"] for line in port] == [4, 4]
    assert ("miss_rate" in port[0]) == (arch == JAMBA)


# --------------------------------------------------------- train, checkpoint
def _ssm_leaves(tree):
    for pos, blk in sorted(tree["blocks"].items()):
        if "ssm" in blk:
            for name in SSM_F32:
                yield f"{pos}/{name}", blk["ssm"][name]


def test_train_loop_keeps_ssm_leaves_apart_from_the_master_copy():
    cfg = TC.get_config(MAMBA).reduced()
    assert cfg.dtype == "bfloat16"
    params, state, hist = train_loop(
        cfg, steps=3, global_batch=2, seq_len=16,
        opt_cfg=TO.AdamWConfig(lr=1e-3, total_steps=3, warmup_steps=1),
        log_every=1000, collect_history=True, device="cpu")
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    master = dict(_ssm_leaves(state.master))
    n = 0
    for name, leaf in _ssm_leaves(params):
        assert leaf.dtype == torch.float32, name
        assert leaf.data_ptr() != master[name].data_ptr(), name
        assert torch.equal(leaf, master[name]), name
        n += 1
    assert n == 3            # one SSM position, its leaves stacked over periods
    # The trained A_log moved off its init.
    a_log = params["blocks"]["pos0"]["ssm"]["A_log"]
    h = cfg.ssm.n_heads(cfg.d_model)
    init = torch.log(torch.linspace(1.0, 16.0, h))
    assert not torch.equal(a_log, init.expand_as(a_log))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_f32_leaves_of_a_bf16_tree_cross_bridge_and_checkpoint(writer,
                                                              tmp_path):
    cfg = TC.get_config(JAMBA).reduced()
    tree = jax.tree.map(
        lambda t: t.view(torch.int16).numpy().view(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy(),
        TM.init_params(cfg, seed=1, device="cpu"))
    dtypes = {jax.tree_util.keystr(p): str(a.dtype)
              for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert {d for k, d in dtypes.items() if k.split("'")[-2] in SSM_F32} \
        == {"float32"}
    assert set(dtypes.values()) == {"float32", "bfloat16"}
    tparams = params_from_numpy(tree, "cpu")
    for name, leaf in _ssm_leaves(tparams):
        assert leaf.dtype == torch.float32, name
    path = str(tmp_path / "ckpt")
    if writer == "port":
        TCK.save(path, {"params": tparams})
    else:
        JCK.save(path, {"params": jax.tree.map(jnp.asarray, tree)})
    back = TCK.restore(path, device="cpu")["params"]
    ref = JCK.restore(path)["params"]
    for p, want in jax.tree_util.tree_leaves_with_path(tree):
        got, jgot = back, ref
        for k in p:
            got, jgot = got[k.key], jgot[k.key]
        key = jax.tree_util.keystr(p)
        assert str(got.dtype).replace("torch.", "") == dtypes[key], key
        assert str(np.asarray(jgot).dtype) == dtypes[key], key
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
            jgot = np.asarray(jgot).view(np.int16)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)
        np.testing.assert_array_equal(np.asarray(jgot), want, err_msg=key)
