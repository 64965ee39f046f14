"""Port parity: input spec trees, step factories and the training launcher.

* ``param_specs``, ``batch_specs`` and ``cache_specs`` (mesh ``None``)
  match the reference's ``ShapeDtypeStruct`` trees path for path in shape
  and dtype, for every arch at full width, every shape and the variants
  that change the trees (int8 KV, ``quantized_serve``, ring KV with the
  decode cap); ``cache_specs`` also matches the port's ``init_cache`` on
  ``meta`` (its ``pos`` int64 where the spec keeps the reference's
  int32).  ``materialize`` gives those tensors on ``meta`` and the CPU,
  with ``argument_size_in_bytes`` of them.
* The reference's ``tests/test_sharding_specs.py``: params specs equal
  ``init_params`` (reduced, every arch), the VLM and encoder-decoder
  batches, the cache against ``init_cache``, a train step under the host
  mesh.
* ``make_prefill_step`` and ``make_decode_step`` (baseline, and
  ``quantized_serve`` with ``MatConfig(8, 4)``) on one numpy tree through
  ``repro_torch.bridge`` against the reference's jitted steps: tokens
  exact, f32 logits at 1e-4; ``step_for_shape``'s donate tuples and its
  long_500k window; the train step's loss at rtol 1e-5.
* ``launch.train``: ``init_sharded_params`` on the host mesh,
  ``train_loop(mesh=)``, ``--mesh multipod`` raising as the reference's
  ``jax.make_mesh`` does without 512 devices.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, SHAPES as J_SHAPES, ShapeConfig
from repro.configs.base import get_config as j_config
from repro.core.amat import MatConfig as JMat
from repro.launch import specs as JSPEC
from repro.launch import steps as JSTEPS
from repro.models import model as JM
from repro.optim import adamw as JO
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TSH
from repro_torch.launch import specs as TSPEC
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO

torch.set_num_threads(1)

TREE_VARIANTS = {"baseline": {}, "int8kv": {"kv_dtype": "int8"},
                 "qserve": {"quantized_serve": True},
                 "ringkv": {"ring_kv": True}}


def _ref_flat(tree, path=()):
    """{path: (shape, dtype name)} of a reference SDS tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_ref_flat(tree[k], path + (str(k),)))
        return out
    return {"/".join(path): (tuple(tree.shape), str(np.dtype(tree.dtype)))}


def _port_flat(tree):
    return {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for p, s in TSH.tree_paths(tree)}


@pytest.mark.parametrize("variant", list(TREE_VARIANTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_reference(arch, variant):
    t = dataclasses.replace(TC.get_config(arch), **TREE_VARIANTS[variant])
    j = dataclasses.replace(j_config(arch), **TREE_VARIANTS[variant])
    assert _port_flat(TSPEC.param_specs(t, None)) == \
        _ref_flat(JSPEC.param_specs(j, None))
    for name, shape in TC.SHAPES.items():
        if shape.kind != "decode":
            assert _port_flat(TSPEC.batch_specs(t, shape, None)) == \
                _ref_flat(JSPEC.batch_specs(j, J_SHAPES[name], None)), name
            continue
        t_in = TSPEC.input_specs(t, shape, None)
        j_in = JSPEC.input_specs(j, J_SHAPES[name], None)
        assert _port_flat(t_in[1]) == _ref_flat(j_in[1]), name
        assert _port_flat({"t": t_in[2]}) == _ref_flat({"t": j_in[2]})
        assert _port_flat(t_in[3]) == _ref_flat(j_in[3])
        rows = t_in[1]["pos0"]
        if "k" in rows:
            want = shape.seq_len
            if t.ring_kv and t.sliding_window:
                want = min(want, t.sliding_window)
            assert rows["k"].shape[2] == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_ports_init_cache(arch):
    cfg = dataclasses.replace(TC.get_config(arch), kv_dtype="int8")
    specs = TSPEC.cache_specs(cfg, 3, 64, None)
    real = TM.init_cache(cfg, 3, 64, device="meta")
    sp, rp = TSH.tree_paths(specs), TSH.tree_paths(real)
    assert [p for p, _ in sp] == [p for p, _ in rp]
    for (path, s), (_, r) in zip(sp, rp):
        assert s.shape == tuple(r.shape), path
        if path == "pos":
            assert (s.dtype, r.dtype) == (torch.int32, torch.int64)
        else:
            assert s.dtype == r.dtype, path


def test_opt_specs_and_materialize():
    cfg = TC.get_config("smollm-360m").reduced()
    shape = dataclasses.replace(TC.SHAPES["train_4k"], global_batch=2,
                                seq_len=16)
    specs = TSPEC.input_specs(cfg, shape, TMESH.make_host_mesh("cpu"))
    params, opt, batch = specs
    assert opt.step == 0 and set(batch) == {"tokens", "labels"}
    for tree in (opt.mu, opt.nu, opt.master):
        assert [(p, s.shape) for p, s in TSH.tree_paths(tree)] == \
            [(p, s.shape) for p, s in TSH.tree_paths(params)]
        assert {s.dtype for s in TSPEC.spec_leaves(tree)} == {torch.float32}
    no_master = TSPEC.opt_specs(cfg, None, TO.AdamWConfig(master_f32=False))
    assert no_master.master is None
    want = TSPEC.argument_size_in_bytes(specs)
    meta = TSPEC.materialize(specs, "meta")
    leaves = [t for t in TO.tree_leaves(
        {"p": meta[0], "m": meta[1].mu, "v": meta[1].nu,
         "w": meta[1].master, "b": meta[2]})]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) == want
    real = TSPEC.materialize(specs, "cpu", seed=3)
    again = TSPEC.materialize(specs, "cpu", seed=3)
    assert torch.equal(real[0]["embed"], again[0]["embed"])
    assert real[0]["embed"].std() > 0 and not real[1].mu["embed"].any()
    toks = real[2]["tokens"]
    assert toks.dtype == torch.int32 and 0 <= int(toks.min())
    assert int(toks.max()) < cfg.vocab_size
    assert not real[0]["final_norm"].any()


# ------------------------------ the reference's test_sharding_specs cases
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_init_params(arch):
    cfg = TC.get_config(arch).reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    pp, sp = TSH.tree_paths(params), TSH.tree_paths(
        TSPEC.param_specs(cfg, mesh=None))
    assert [p for p, _ in pp] == [p for p, _ in sp]
    for (path, p), (_, s) in zip(pp, sp):
        assert tuple(p.shape) == s.shape and p.dtype == s.dtype, path


def test_batch_specs_vlm_prefix_and_encdec():
    cfg = TC.get_config("internvl2-1b")
    b = TSPEC.batch_specs(cfg, TC.SHAPES["train_4k"], mesh=None)
    assert b["tokens"].shape == (256, 4096 - cfg.prefix_len)
    assert b["prefix_embeds"].shape == (256, cfg.prefix_len, cfg.d_model)
    cfg = TC.get_config("whisper-small")
    b = TSPEC.batch_specs(cfg, TC.SHAPES["prefill_32k"], mesh=None)
    assert b["encoder_frames"].shape == (32, 1500, 768)
    assert "labels" not in b


def test_train_step_runs_under_host_mesh():
    cfg = TC.get_config("smollm-360m").reduced()
    mesh = TMESH.make_host_mesh("cpu")
    opt_cfg = TO.AdamWConfig(total_steps=5, warmup_steps=1)
    step, donate = TSTEPS.step_for_shape(
        cfg, TC.SHAPES["train_4k"], opt_cfg)
    assert donate == (0, 1)
    with TSH.mesh_context(mesh):
        params = TT.init_sharded_params(cfg, mesh, 0)
        opt_state = TO.init_state(params, opt_cfg)
        toks = torch.randint(0, cfg.vocab_size, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        _, _, metrics = step(params, opt_state,
                             {"tokens": toks, "labels": toks})
    assert np.isfinite(float(metrics["loss"]))


# ------------------------------------------------------ steps, in parity
def _cfgs(arch, **over):
    out = []
    for get in (j_config, TC.get_config):
        cfg = get(arch).reduced()
        if cfg.moe is not None:
            over_moe = dataclasses.replace(cfg.moe, capacity_factor=8.0)
            cfg = dataclasses.replace(cfg, moe=over_moe)
        out.append(dataclasses.replace(cfg, dtype="float32", **over))
    return out


STEP_CASES = [("smollm-360m", {}), ("llama4-scout-17b-a16e", {}),
              ("llama4-scout-17b-a16e", {"quantized_serve": True}),
              ("whisper-small", {}), ("jamba-v0.1-52b", {})]


@pytest.mark.parametrize("arch,over", STEP_CASES,
                         ids=[f"{a}{'-qserve' if o else ''}"
                              for a, o in STEP_CASES])
def test_prefill_and_decode_steps_match_reference(arch, over):
    jcfg, tcfg = _cfgs(arch, **over)
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    shape = ShapeConfig("prefill_32k", 32, 2, "prefill")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    batch = {"tokens": toks}
    if tcfg.is_encdec:
        batch["encoder_frames"] = rng.standard_normal(
            (2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32) * 0.02
    jfn, jdon = JSTEPS.step_for_shape(jcfg, shape)
    tfn, tdon = TSTEPS.step_for_shape(tcfg, TC.ShapeConfig(
        *dataclasses.astuple(shape)))
    assert tdon == jdon == ()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if tcfg.quantized_serve:
        # Neither package's prefill step passes a MatConfig, so both
        # refuse the flat AMAT experts; the decode steps start from the
        # model's prefill with MAT84.
        with pytest.raises(AssertionError):
            jax.jit(jfn)(jp, jb)
        with pytest.raises(ValueError, match="MatConfig"):
            tfn(tp, tb)
        jl, jc, _ = JM.prefill(jp, jcfg, jb["tokens"], 32, mat=JMat(8, 4))
        tl, tc, _ = TM.prefill(tp, tcfg, tb["tokens"], 32, mat=TMat(8, 4))
    else:
        jl, jc = jax.jit(jfn)(jp, jb)
        tl, tc = tfn(tp, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert int(tc["pos"]) == int(jc["pos"]) == 12
    dshape = ShapeConfig("decode_32k", 32, 2, "decode")
    jfn, jdon = JSTEPS.step_for_shape(jcfg, dshape)
    tfn, tdon = TSTEPS.step_for_shape(tcfg, TC.ShapeConfig(
        *dataclasses.astuple(dshape)))
    assert tdon == jdon == (1,)
    extras = {k: v for k, v in batch.items() if k == "encoder_frames"}
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1).to(torch.int32)
    jstep = jax.jit(jfn)
    for _ in range(2):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, jl, jc = jstep(jp, jc, jt,
                           {k: jnp.asarray(v) for k, v in extras.items()})
        tt, tl, tc = tfn(tp, tc, tt,
                         {k: torch.from_numpy(v) for k, v in extras.items()})
        assert tt.dtype == torch.int32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tc["pos"]) == int(jc["pos"]) == 14


def test_long_500k_decode_step_reads_the_window():
    """``step_for_shape`` gives long_500k's decode on a dense arch the
    sliding window, as the reference does: both packages' steps from one
    prefilled cache, and the unwindowed step apart from them."""
    jcfg, tcfg = _cfgs("smollm-360m", sliding_window=8)
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=2, device="cpu"))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 20)).astype(np.int32)
    _, jc, _ = JM.prefill(jp, jcfg, jnp.asarray(toks), 32)
    _, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks), 32)
    long = ShapeConfig("long_500k", 32, 2, "decode")
    jfn, _ = JSTEPS.step_for_shape(jcfg, long)
    tfn, _ = TSTEPS.step_for_shape(tcfg, TC.ShapeConfig(
        *dataclasses.astuple(long)))
    tok = np.array([3, 5], np.int32)
    _, jl, _ = jax.jit(jfn)(jp, jc, jnp.asarray(tok), {})
    _, tl, _ = tfn(tp, TO.tree_map(torch.clone, tc), torch.from_numpy(tok),
                   {})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    plain, _ = TSTEPS.step_for_shape(tcfg, TC.ShapeConfig(
        "decode_32k", 32, 2, "decode"))
    _, ul, _ = plain(tp, tc, torch.from_numpy(tok), {})
    assert float((ul - tl).abs().max()) > 1e-3


def test_train_step_loss_matches_reference():
    jcfg, tcfg = _cfgs("llama4-scout-17b-a16e")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=4, device="cpu"))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jfn, jdon = JSTEPS.step_for_shape(jcfg, J_SHAPES["train_4k"],
                                      JO.AdamWConfig(**kw))
    tfn, tdon = TSTEPS.step_for_shape(tcfg, TC.SHAPES["train_4k"],
                                      TO.AdamWConfig(**kw))
    assert tdon == jdon == (0, 1)
    _, _, jm = jax.jit(jfn)(jp, JO.init_state(jp, JO.AdamWConfig(**kw)),
                            {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(toks)})
    _, _, tm = tfn(tp, TO.init_state(tp, TO.AdamWConfig(**kw)),
                   {"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(toks)})
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


def test_shape_supported_reason_is_the_references():
    cfg = TC.get_config("whisper-small")
    ok, why = TSTEPS.shape_supported(cfg, TC.SHAPES["long_500k"])
    assert (ok, why) == JSTEPS.shape_supported(j_config("whisper-small"),
                                               J_SHAPES["long_500k"])
    assert not ok and why == (
        "full-attention arch without sliding-window variant — long_500k "
        "skipped per DESIGN.md §4")
    with pytest.raises(ValueError):
        TSTEPS.step_for_shape(cfg, TC.ShapeConfig("x", 8, 1, "serve"))


# ------------------------------------------------------------ the launcher
def test_init_sharded_params_and_train_loop_on_the_host_mesh():
    cfg = TC.get_config("qwen15-moe-repro").reduced()
    mesh = TMESH.make_host_mesh("cpu")
    got = TT.init_sharded_params(cfg, mesh, 7)
    want = TM.init_params(cfg, seed=7, device="cpu")
    for a, b in zip(TO.tree_leaves(got), TO.tree_leaves(want)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="one device"):
        TT.init_sharded_params(cfg, TMESH.make_production_mesh(
            abstract=True), 0)
    _, _, hist = TT.train_loop(cfg, steps=2, global_batch=2, seq_len=16,
                               mesh=mesh, seed=0, collect_history=True)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_train_cli_multipod_raises_without_512_devices(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen15-moe-repro",
                                      "--mesh", "multipod"])
    with pytest.raises(ValueError, match="spans 512 devices"):
        TT.main()
