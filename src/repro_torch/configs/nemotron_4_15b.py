"""Nemotron-4 15B — dense, squared-ReLU MLP, GQA kv=8. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="relu2",
    rope_theta=10000.0,
    sliding_window=8192,          # long_500k variant only
    source="arXiv:2402.16819 (Nemotron-4)",
)
