"""Qwen1.5-MoE-A2.7B at its published widths (paper eval model 2).

The widths, depth, expert counts, RoPE base, norm epsilon and QKV bias
are those of the Hugging Face ``Qwen/Qwen1.5-MoE-A2.7B`` ``config.json``
(hidden_size 2048, 24 layers, 16 heads of 128, moe_intermediate_size
1408, shared_expert_intermediate_size 5632, 60 experts, top-4, vocab
151936).  ``d_ff`` (the dense FFN width) only sizes configs without MoE
blocks; every layer here is an MoE block.

Where it follows the repo's MoE semantics instead of Hugging Face's:

* the repo renormalizes the top-k gates to sum to one; the checkpoint's
  config sets ``norm_topk_prob=false``;
* the repo's shared experts are one always-on SwiGLU MLP of width
  ``d_ff_shared`` added to the routed mixture, with no sigmoid gate
  (Hugging Face scales the shared expert by ``sigmoid(x @ w_gate)``).

It is the same family as ``qwen15-moe-repro`` (which cuts d_model to 256
and depth to 4); it adds no architecture.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoECfg

CONFIG = ModelConfig(
    name="qwen15-moe-a2.7b",
    arch_type="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,
    vocab_size=151936,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=60, top_k=4, d_ff=1408,
               n_shared_experts=4, d_ff_shared=5632,
               capacity_factor=2.0, mlp_type="swiglu"),
    rope_theta=1e6,
    norm_eps=1e-6,
    qkv_bias=True,
    source=("huggingface.co/Qwen/Qwen1.5-MoE-A2.7B config.json "
            "(published widths; top-k renormalized, no shared-expert gate)"),
)
