"""Qwen1.5-MoE-A2.7B routing-structure reproduction (paper eval model 2).

Faithful expert structure (60 routed experts, top-4, 4 shared experts)
at reduced width.  [Qwen blog, Feb 2024]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoECfg

CONFIG = ModelConfig(
    name="qwen15-moe-repro",
    arch_type="moe",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    head_dim=32,
    d_ff=512,
    vocab_size=2048,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=60, top_k=4, d_ff=64,
               n_shared_experts=4, d_ff_shared=256,
               capacity_factor=2.0, mlp_type="swiglu"),
    source="Qwen1.5-MoE-A2.7B blog (reduced width, faithful routing)",
)
