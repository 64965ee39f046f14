"""DeepSeek-V2-Lite at its published widths (paper eval model 1).

The numbers of the Hugging Face ``deepseek-ai/DeepSeek-V2-Lite``
``config.json``: 27 layers at hidden size 2048, vocab 102400,
``rms_norm_eps`` 1e-6; layer 0 a dense SwiGLU FFN of width 10944
(``first_k_dense_replace`` 1), layers 1-26 MoE with 64 routed SwiGLU
experts of width 1408, top-6 by softmax, and 2 shared experts (one SwiGLU
MLP of width 2816); multi-head latent attention over 16 heads without a
query LoRA (``q_proj`` 2048 to 16 x (128 + 64), ``kv_a_proj_with_mqa``
2048 to 512 + 64 with an RMSNorm on the 512, ``kv_b_proj`` 512 to 16 x
(128 + 128), ``o_proj`` 16 x 128 to 2048), RoPE with base 10000 on the 64
decoupled dims under YaRN (factor 40 over 4096 positions, beta_fast 32,
beta_slow 1, mscale and mscale_all_dim 0.707).  15,706,484,224
parameters.

Where it follows the repo's semantics instead of Hugging Face's:

* the top-6 gates are renormalized to sum to one (the checkpoint's config
  sets ``norm_topk_prob=false``), and the MoE layer has a capacity of
  ``capacity_factor`` times the mean load (the published model drops
  nothing);
* RoPE rotates the halves of the 64 dims (dim i with dim i + 32), where
  the published code rotates interleaved pairs (2i, 2i + 1): the same
  model up to a fixed permutation of the 64 RoPE output columns of
  ``q_proj`` and ``kv_a_proj_with_mqa``.

``head_dim`` is the query/key head size (128 + 64); the attention reads
its widths from ``mla``.  The repo's ``deepseek-v2-lite-repro`` keeps the
expert structure at a reduced width with plain attention.
"""
from repro_torch.configs.base import BlockSpec, MLACfg, ModelConfig
from repro_torch.models.moe import MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,
    d_ff=10944,
    vocab_size=102400,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=64, top_k=6, d_ff=1408,
               n_shared_experts=2, d_ff_shared=2816,
               capacity_factor=2.0, mlp_type="swiglu"),
    pattern=(BlockSpec("attn", "moe"),),
    rope_theta=10000.0,
    norm_eps=1e-6,
    mla=MLACfg(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
               v_head_dim=128, rope_factor=40.0, rope_original_max=4096,
               beta_fast=32.0, beta_slow=1.0, mscale=0.707,
               mscale_all_dim=0.707),
    lead_dense_layers=1,
    source=("huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json "
            "(published widths; top-k renormalized, half-split RoPE)"),
)
