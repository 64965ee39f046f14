"""Mamba2-2.7B — pure SSD stack, attention-free. [arXiv:2405.21060]

64 layers, d_model=2560, d_state=128, expand=2, head_dim=64 (80 heads).
No FFN (d_ff=0), no attention; decode state is O(1) in sequence length,
so decode_32k and long_500k have identical per-step cost.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import SSMCfg

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    mlp_type="swiglu",    # unused
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060 (Mamba2 / SSD)",
)
