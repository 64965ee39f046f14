"""Whisper-small — encoder-decoder ASR transformer. [arXiv:2212.04356]

12+12 layers, d_model=768, MHA (kv=12), GELU MLP.  The mel-spectrogram +
conv frontend is a stub: ``input_specs`` supplies 1500 precomputed frame
embeddings as the encoder input.  Decoder = causal self-attn + cross-attn.
Full attention only -> long_500k is skipped (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    mlp_type="gelu",
    encoder_layers=12,
    encoder_seq=1500,
    source="arXiv:2212.04356 (Whisper)",
)
