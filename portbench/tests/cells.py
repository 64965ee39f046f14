"""Small cells for the CPU tests: the shapes of ``qwen15-moe-repro`` and a
two-period hybrid, served under the benchmark's engine settings."""

from __future__ import annotations

import json
import pathlib

from portbench.lib import loader
from portbench.lib.bench import Cell
from portbench.lib.traffic import Mix

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent

QWEN_REPRO = {
    "name": "qwen15-moe-repro", "source": "test", "model": "periodic",
    "arch_type": "moe",
    "n_layers": 4, "d_model": 256, "n_heads": 8, "n_kv_heads": 8,
    "head_dim": 32, "d_ff": 512, "vocab_size": 2048, "mlp_type": "swiglu",
    "moe": {"n_experts": 60, "top_k": 4, "d_ff": 64, "n_shared_experts": 4,
            "d_ff_shared": 256, "capacity_factor": 2.0,
            "mlp_type": "swiglu"},
    "pattern": [{"mixer": "attn", "ffn": "moe"}],
    "rope_theta": 10000.0, "norm_eps": 1e-6, "qkv_bias": True,
    "dtype": "float32"}

TINY_HYBRID = {
    "name": "tiny-hybrid", "source": "test", "model": "periodic",
    "arch_type": "hybrid",
    "n_layers": 8, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
    "head_dim": 32, "d_ff": 256, "vocab_size": 512, "mlp_type": "swiglu",
    "moe": {"n_experts": 8, "top_k": 2, "d_ff": 128, "n_shared_experts": 0,
            "d_ff_shared": 0, "capacity_factor": 1.25,
            "mlp_type": "swiglu"},
    "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 32,
            "chunk": 32},
    "pattern": [{"mixer": "ssm", "ffn": "moe"}, {"mixer": "attn",
                                                 "ffn": "dense"},
                {"mixer": "ssm", "ffn": "moe"}, {"mixer": "ssm",
                                                 "ffn": "dense"}],
    "rope_theta": 10000.0, "norm_eps": 1e-6, "qkv_bias": False,
    "dtype": "float32"}

MIX = {"loop": "closed", "clients": 6, "max_batch": 6,
       "prompt": {"kind": "lognormal", "value": 24, "sigma": 0.5,
                  "min_len": 8, "max_len": 48},
       "output": {"kind": "lognormal", "value": 12, "sigma": 0.6,
                  "min_len": 4, "max_len": 24},
       "strata": 6, "warmup_steps": 2, "trace_steps": 2}


def cell(cfg: dict, max_gap=None, mean_gap=None,
         dtype: str = "float32") -> Cell:
    cfg = dict(cfg, dtype=dtype)
    with open(HERE / "configs" / "engine.json") as f:
        engine = json.load(f)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    metrics = {False: bench["end_to_end"], True: bench["per_layer"]}
    return Cell(cfg["name"], cfg, engine, Mix.from_json(MIX),
                {"sample_requests": 3, "max_logit_gap": max_gap,
                 "mean_logit_gap": mean_gap}, 1,
                metrics, loader.model_module(cfg))
