"""SmolLM-360M — llama-architecture small model. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    mlp_type="swiglu",
    rope_theta=10000.0,
    sliding_window=8192,          # long_500k variant only
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M (assignment card cites SmolLM-135M)",
)
