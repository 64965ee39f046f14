"""Jamba-v0.1 52B — Mamba+attention 1:7 hybrid with MoE every 2 layers.

[arXiv:2403.19887].  Period-8 block pattern: one attention layer per 8
(position 3), the rest Mamba; MoE FFN on every other layer (odd
positions), dense FFN otherwise.  Jamba uses Mamba-1 (d_state=16); we
adapt to the SSD formulation with the same state size (DESIGN.md §3).
Sub-quadratic: runs long_500k natively.
"""
from repro_torch.configs.base import ModelConfig, BlockSpec
from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import SSMCfg

_PATTERN = tuple(
    BlockSpec(mixer=("attn" if i == 3 else "ssm"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=16, top_k=2, d_ff=14336,
               capacity_factor=1.25, mlp_type="swiglu"),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
    pattern=_PATTERN,
    source="arXiv:2403.19887 (Jamba)",
)
