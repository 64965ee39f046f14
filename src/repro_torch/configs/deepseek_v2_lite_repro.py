"""DeepSeek-V2-Lite routing-structure reproduction (paper eval model 1).

Faithful expert structure (64 routed experts, top-6, 2 shared experts)
at reduced width so routing-trace experiments run on CPU.
[arXiv:2405.04434]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite-repro",
    arch_type="moe",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    head_dim=32,
    d_ff=512,
    vocab_size=2048,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=64, top_k=6, d_ff=64,
               n_shared_experts=2, d_ff_shared=128,
               capacity_factor=2.0, mlp_type="swiglu"),
    source="arXiv:2405.04434 (DeepSeek-V2-Lite; reduced width, faithful routing)",
)
