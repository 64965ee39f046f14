"""Port parity: the serving CLI (``repro_torch.launch.serve`` against
``repro.launch.serve``).

* Knob parity, the counterpart of ``tests/test_analysis.py::
  test_serve_cli_knob_parity_runtime`` on the port's ``EngineConfig``;
  the port's ``DEFAULT_KNOBS`` equal the reference's.
* The two parsers hold the same flags (names, destinations, defaults,
  choices, types and help), apart from the port's ``--device``.
* ``--replay-trace`` of one recorded trace: the port's JSON report equals
  the reference's, bare and under overrides (floats at rtol 1e-6, the
  epoch miss rates and counts exact; the host's replay speed left out),
  and the two ``--trace-out`` exports are event-identical.
* A live run of the port's ``main`` on the CPU, on a checkpoint of the
  port's init: its request lines equal an in-process ``SliceMoEServer``
  built with ``build_engine_config`` of the same arguments (the wall
  seconds left out), and its recorded trace replays bare to that
  server's totals.
"""

import argparse
import dataclasses
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.analysis.knobs import ALIASES, ALLOWLIST
from repro.launch import serve as JSERVE
from repro_torch.checkpoint import ckpt as TCK
from repro_torch.configs.base import get_config
from repro_torch.core.engine import EngineConfig
from repro_torch.launch import serve as TSERVE
from repro_torch.models import model as TM
from repro_torch.serving.server import Request, SliceMoEServer
from repro_torch.sim import ReplayEngine, Trace

torch.set_num_threads(1)

ARCH = "qwen15-moe-repro"
LIVE = ["--device", "cpu", "--arch", ARCH, "--n-requests", "2",
        "--prompt-len", "8", "--max-new", "3", "--seed", "4"]
WALLS = ("prefill_s", "decode_s")


def _lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_default_knobs_cover_the_engine_config():
    flat = set()
    for f in dataclasses.fields(EngineConfig):
        if f.name not in ALLOWLIST:
            flat |= ALIASES.get(f.name, {f.name})
    assert set(TSERVE.DEFAULT_KNOBS) == flat
    assert TSERVE.DEFAULT_KNOBS == JSERVE.DEFAULT_KNOBS

    ns = SimpleNamespace(
        cache_mb=None, routing=None, miss_target=None, controller=None,
        **{k: None for k in TSERVE.DEFAULT_KNOBS
           if k not in ("cache_bytes", "policy_kind", "miss_rate_target",
                        "controller")})
    assert set(TSERVE.cli_engine_knobs(ns)) == set(TSERVE.DEFAULT_KNOBS)
    ecfg = TSERVE.build_engine_config(ns)
    assert ecfg.lsb_keep_frac == EngineConfig().lsb_keep_frac
    assert ecfg.system == EngineConfig().system
    assert ecfg.fused_slices == EngineConfig().fused_slices
    assert ecfg.hotness_request_decay == \
        EngineConfig().hotness_request_decay
    assert ecfg.policy.fetch_lsb_on_miss == \
        EngineConfig().policy.fetch_lsb_on_miss
    assert not ecfg.policy.quant_execution       # the dense-dequant path


@pytest.mark.parametrize("argv", [
    [],
    ["--cache-mb", "2", "--miss-target", "0.1", "--system", "tpu_offload",
     "--no-fetch-lsb-on-miss", "--routing", "topk", "--placement",
     "hotness", "--ep-shards", "2", "--async-io",
     "--controller", '{"slos": {"default": {"miss_rate": 0.05}}}'],
], ids=["defaults", "set"])
def test_build_engine_config_equals_reference(argv):
    """The same command line gives the same engine settings."""
    j = JSERVE.build_engine_config(_reference_parser().parse_args(argv))
    t = TSERVE.build_engine_config(TSERVE.build_parser().parse_args(argv))
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert set(jd) == set(td)
    for key in jd:
        if key == "controller":
            assert (jd[key] is None) == (td[key] is None)
            if jd[key] is not None:
                assert j.controller.to_dict() == t.controller.to_dict()
        else:
            assert jd[key] == td[key], key


class _Parsed(Exception):
    pass


def _reference_parser():
    """The parser the reference's ``main`` builds (it keeps no handle):
    its ``parse_args`` is intercepted on the way in."""
    grabbed = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        grabbed["ap"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Parsed):
            JSERVE.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return grabbed["ap"]


def _flags(ap):
    # The port's help names its own modules (repro_torch.hw.specs,
    # repro_torch.control) where the reference's names repro's.
    return {a.option_strings[0]: (
        tuple(a.option_strings), a.dest, a.default, a.choices, a.type,
        a.nargs, a.help and a.help.replace("repro_torch.", "repro."),
        a.metavar, type(a).__name__) for a in ap._actions
        if a.dest != "help"}


def test_parsers_hold_the_same_flags():
    ref, port = _flags(_reference_parser()), _flags(TSERVE.build_parser())
    assert port.pop("--device")[2] is None        # cuda by default
    assert port == ref
    assert len(port) == 36


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A checkpoint of the port's init and one live CLI run on it that
    records its trace and writes every export."""
    d = tmp_path_factory.mktemp("cli")
    ckpt = str(d / "ckpt")
    TCK.save(ckpt, {"params": TM.init_params(get_config(ARCH), seed=0,
                                             device="cpu")}, step=0)
    paths = {k: str(d / name) for k, name in (
        ("trace", "live.npz"), ("chrome", "live.json"),
        ("metrics", "live.jsonl"), ("prom", "live.prom"))}
    argv = LIVE + ["--ckpt", ckpt, "--record-trace", paths["trace"],
                   "--trace-out", paths["chrome"],
                   "--metrics-out", paths["metrics"],
                   "--prom-out", paths["prom"]]
    return ckpt, argv, paths, d


@pytest.fixture(scope="module")
def live_lines(recorded):
    import contextlib
    import io

    _, argv, _, _ = recorded
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TSERVE.main(argv)
    return _lines(buf.getvalue())


def _replay_reference(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    capsys.readouterr()
    JSERVE.main()
    return json.loads(capsys.readouterr().out)


def _replay_port(argv, capsys):
    capsys.readouterr()
    TSERVE.main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("over", [
    [], ["--cache-mb", "2", "--miss-target", "0.1"],
    ["--system", "tpu_offload"]], ids=["bare", "cache_miss", "tpu_offload"])
def test_replay_report_equals_reference(recorded, live_lines, over, capsys,
                                        monkeypatch):
    _, _, paths, d = recorded
    argv = ["--replay-trace", paths["trace"]] + over
    ref = _replay_reference(argv, capsys, monkeypatch)
    port = _replay_port(argv, capsys)
    for r in (ref, port):
        assert r.pop("replay_steps_per_s") > 0       # the host's speed
    assert port["epoch_miss"] == ref["epoch_miss"]
    assert port["n_prefills"] == ref["n_prefills"] == 2
    assert_same(ref, port)
    if over:
        assert port["total_energy_j"] != _replay_port(
            ["--replay-trace", paths["trace"]], capsys)["total_energy_j"]


def test_replay_exports_are_event_identical(recorded, live_lines, capsys,
                                            monkeypatch):
    _, _, paths, d = recorded
    ref_out, port_out = str(d / "ref_replay.json"), str(d / "port_replay.json")
    ref = _replay_reference(["--replay-trace", paths["trace"],
                             "--trace-out", ref_out], capsys, monkeypatch)
    port = _replay_port(["--replay-trace", paths["trace"],
                         "--trace-out", port_out], capsys)
    assert port["trace_out"] == port_out and ref["trace_out"] == ref_out
    with open(ref_out) as f:
        ref_events = json.load(f)["traceEvents"]
    with open(port_out) as f:
        port_events = json.load(f)["traceEvents"]
    assert len(port_events) == len(ref_events) > 0
    assert_same(ref_events, port_events)
    # The live export holds the same channel events, plus request spans.
    with open(paths["chrome"]) as f:
        live_events = json.load(f)["traceEvents"]
    from repro_torch.obs.timeline import REQUESTS_PID
    assert [e for e in live_events if e.get("pid") != REQUESTS_PID] \
        == port_events


def test_live_cli_equals_the_server_and_replays_to_it(recorded, live_lines,
                                                      capsys):
    ckpt, argv, paths, _ = recorded
    args = TSERVE.build_parser().parse_args(argv)
    cfg = get_config(ARCH)
    server = SliceMoEServer(
        cfg, TCK.restore(ckpt, "cpu")["params"],
        engine_cfg=TSERVE.build_engine_config(args),
        max_seq=args.prompt_len + args.max_new + 8, device="cpu")
    rng = np.random.default_rng(args.seed)
    for rid in range(args.n_requests):
        server.submit(Request(
            request_id=rid,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    done = server.run()

    requests = [line for line in live_lines if "request" in line]
    assert len(requests) == 2
    for line, c in zip(requests, done):
        d = c.metrics["decode_totals"]
        cs = c.metrics["cache_stats"]
        want = {"request": c.request_id, "n_tokens": len(c.tokens),
                "sim_decode_energy_mJ": round(d["total_energy_j"] * 1e3, 3),
                "sim_decode_latency_ms": round(
                    d["total_latency_s"] * 1e3, 3),
                "miss_rate": round(cs["msb_misses"] / max(
                    cs["msb_hits"] + cs["msb_misses"], 1), 4)}
        assert {k: v for k, v in line.items() if k not in WALLS} == want
        assert all(line[k] >= 0 for k in WALLS)
    keys = [next(iter(line)) for line in live_lines if "request" not in line]
    assert keys == ["recorded_trace", "trace_out", "metrics_out",
                    "prom_out"]
    rec = next(line for line in live_lines if "recorded_trace" in line)
    assert rec["n_prefills"] == 2 and rec["n_decode_steps"] == 6
    met = next(line for line in live_lines if "metrics_out" in line)
    with open(paths["metrics"]) as f:
        assert len(f.read().splitlines()) == met["n_samples"] == 6
    with open(paths["prom"]) as f:
        assert f.read().strip()

    # The bare replay of the recorded trace gives the live totals, and
    # each request's decode window the live line's MSB miss rate.
    report = _replay_port(["--replay-trace", paths["trace"]], capsys)
    live = server._engine.ledger.snapshot()
    for key in ("total_energy_j", "total_latency_s"):
        np.testing.assert_allclose(report[key], live[key], rtol=1e-6)
    assert report["epoch_miss"] == [
        {"epoch": label, "miss_rate": round(m, 6)}
        for label, m in server._engine.cache.epoch_miss_rates()]
    eng = ReplayEngine(Trace.load(paths["trace"]).meta)
    eng.consume_all(Trace.load(paths["trace"]).events)
    eng.finish()
    decode = [s for label, s in eng.cache.epochs if label.endswith("/decode")]
    assert [round(s["msb_misses"] / max(s["msb_hits"] + s["msb_misses"], 1),
                  4) for s in decode] == [line["miss_rate"]
                                          for line in requests]
