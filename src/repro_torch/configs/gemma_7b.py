"""Gemma-7B — dense, GeGLU, head_dim=256, kv=16 (MHA at 7B). [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    rope_theta=10000.0,
    sliding_window=8192,          # long_500k variant only
    logit_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma)",
)
