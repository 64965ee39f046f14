"""StarCoder2-3B — dense GQA code model. [arXiv:2402.19173]

GQA kv=2, RoPE, GELU MLP (pile-style FFN), 16k training window in the
original (sliding window 4096); we expose the sliding window for the
long_500k decode shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp_type="gelu",
    rope_theta=1e5,
    sliding_window=4096,
    qkv_bias=True,
    source="arXiv:2402.19173 (StarCoder2)",
)
