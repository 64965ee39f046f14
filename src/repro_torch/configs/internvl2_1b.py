"""InternVL2-1B — InternViT vision encoder + InternLM2 LM backbone.

[arXiv:2404.16821].  The assignment specifies the transformer backbone;
the ViT/projector frontend is a stub: ``input_specs`` supplies 256
precomputed patch embeddings (d_model) as a decoder prefix.
Dense full-attention LM; long_500k runs via the sliding-window variant
(documented deviation, DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    mlp_type="swiglu",
    rope_theta=1e6,
    sliding_window=8192,          # long_500k variant only (not always_swa)
    prefix_len=256,
    source="arXiv:2404.16821 (InternVL2); backbone=InternLM2/Qwen2-0.5B",
)
