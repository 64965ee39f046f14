"""Shared infrastructure of the port's benchmarks (the counterpart of
``benchmarks/common.py``): the trained-model cache, held-out batches,
synthetic perplexity, the CSV sink, the call timer, the JSON record and
the readers of the records a benchmark is held against (the reference's
and its own).  Imports no JAX.

The trained-weights cache is ``results/trained_torch/``, apart from the
reference's ``results/trained/``: the two packages draw different inits,
so one name would serve one package's weights as the other's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models.model import lm_loss
from repro_torch.optim import adamw as OPT

# REPRO_RESULTS_DIR redirects the CSV sinks and the JSON records, as for
# the reference's benchmarks; the trained-model cache stays at the repo
# default.
_REPO_RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "results")
RESULTS = os.environ.get("REPRO_RESULTS_DIR", _REPO_RESULTS)
BENCH_DIR = os.path.join(RESULTS, "bench")
TRAINED_DIR = os.path.join(_REPO_RESULTS, "trained_torch")


def train_or_load(arch: str, *, steps: int = 80, seq: int = 64,
                  batch: int = 8, lr: float = 2e-3, seed: int = 0,
                  device=None):
    """Briefly train the repro-scale model on synthetic data (cached in
    ``TRAINED_DIR`` by arch and steps); returns (cfg, params on
    ``device``, ``cuda`` unless told otherwise).

    The SliceMoE experiments need non-degenerate routing distributions;
    a fresh-init router routes near-uniformly, a briefly-trained one
    develops the skewed, input-dependent gating the paper exploits.
    """
    dev = resolve_device(device)
    cfg = get_config(arch)
    path = os.path.join(TRAINED_DIR, f"{arch}_s{steps}")
    if os.path.exists(os.path.join(path, "manifest.msgpack")):
        return cfg, CKPT.restore(path, dev)["params"]
    opt_cfg = OPT.AdamWConfig(lr=lr, total_steps=steps,
                              warmup_steps=max(steps // 10, 1))
    params, _, _ = train_loop(cfg, steps=steps, global_batch=batch,
                              seq_len=seq, opt_cfg=opt_cfg,
                              log_every=max(steps // 4, 1), seed=seed,
                              device=dev)
    CKPT.save(path, {"params": params}, step=steps)
    return cfg, params


def eval_batches(cfg, *, n_batches: int = 4, batch: int = 4, seq: int = 64,
                 seed: int = 1234):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    return [data.sample_batch(10_000 + i, batch) for i in range(n_batches)]


@torch.no_grad()
def synthetic_ppl(params, cfg, batches) -> float:
    """Perplexity on held-out synthetic data (on the params' device)."""
    dev = params["embed"].device
    losses = []
    for full in batches:
        full = torch.as_tensor(full, dtype=torch.int64, device=dev)
        loss, _ = lm_loss(params, cfg, full[:, :-1], full[:, 1:],
                          aux_weight=0.0)
        losses.append(float(loss))
    return float(np.exp(np.mean(losses)))


class CsvSink:
    def __init__(self, name: str, header: list[str]):
        os.makedirs(BENCH_DIR, exist_ok=True)
        self.path = os.path.join(BENCH_DIR, name + ".csv")
        self.header = header
        self.rows: list[list] = []

    def add(self, *row) -> None:
        if len(row) != len(self.header):
            raise ValueError(f"{len(row)} values for {len(self.header)} "
                             "columns")
        self.rows.append(list(row))

    def flush(self) -> str:
        with open(self.path, "w") as f:
            f.write(",".join(self.header) + "\n")
            for r in self.rows:
                f.write(",".join(str(x) for x in r) + "\n")
        return self.path


def report(name: str, us_per_call: float, derived: str) -> None:
    """The ``name,us_per_call,derived`` CSV line to stdout."""
    print(f"{name},{us_per_call:.1f},{derived}")


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall time per call in microseconds, after ``warmup`` calls.
    Once the card is in use, each timed call runs from a synchronized
    card to the end of its work (``torch.cuda.synchronize()`` before and
    after it)."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def device_time_us(fn: Callable, device, *, warmup: int = 3,
                   iters: int = 20) -> Optional[float]:
    """Device time per call in microseconds on the card, ``None`` on any
    other device: after ``warmup`` calls on a side stream, ``iters``
    calls are captured once in a CUDA graph and replayed between CUDA
    events, so that the host's launch gaps drop out."""
    if torch.device(device).type != "cuda":
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def _load(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def reference_record(name: str) -> Optional[dict]:
    """The reference's persisted ``results/BENCH_<name>.json`` (in the
    repo, whatever ``REPRO_RESULTS_DIR`` says), or ``None``.  Its
    model-free numbers are targets the port must equal."""
    return _load(os.path.join(_REPO_RESULTS, f"BENCH_{name}.json"))


def own_record(name: str) -> Optional[dict]:
    """This port benchmark's last record, ``RESULTS/BENCH_torch_<name>
    .json``, or ``None``."""
    return _load(os.path.join(RESULTS, f"BENCH_torch_{name}.json"))


def json_record(name: str, payload: dict) -> str:
    """Write a port benchmark's structured results to
    ``RESULTS/BENCH_torch_<name>.json`` (the ``torch_`` prefix keeps it
    apart from the reference's baselines, which it never writes)."""
    os.makedirs(RESULTS, exist_ok=True)
    path = os.path.join(RESULTS, f"BENCH_torch_{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path
