"""Llama-4 Scout 17B-A16E — MoE 16 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E].
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoECfg

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=16, top_k=1, d_ff=8192,
               n_shared_experts=1, d_ff_shared=8192,
               capacity_factor=1.25, mlp_type="swiglu"),
    rope_theta=500000.0,
    sliding_window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
