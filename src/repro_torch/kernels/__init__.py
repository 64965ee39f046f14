"""Kernels written by hand for NVIDIA Hopper: one per ported TPU kernel,
and the decode step's attention.

Each kernel ships as ``ops.py`` (the public wrapper: checks, launch,
launch counter), ``ref.py`` (the plain PyTorch version the CPU path and
the on-card comparison use) and ``csrc/`` (the CUDA C++ source, built at
first use by :mod:`repro_torch.kernels._build`).

Subpackages:
  * :mod:`repro_torch.kernels.amat_matmul` — the fused AMAT
    dequant-matmuls: batched experts (``wi`` K-major and ``wo``
    output-major) and one matrix at a static precision;
  * :mod:`repro_torch.kernels.expert_matmul` — the per-expert sliced
    matmul, on the batched K-major kernel of ``amat_matmul``;
  * :mod:`repro_torch.kernels.flash_attn` — causal GQA flash attention
    with an optional sliding window;
  * :mod:`repro_torch.kernels.decode_attn` — one attention layer of a
    decode step (RoPE, the KV append, split-KV attention over the bf16
    cache), which replaces no TPU kernel;
  * :mod:`repro_torch.kernels.mla_decode` — the attention of one
    multi-head latent attention layer of a decode step, absorbed (RoPE, the
    latent and rope rows appended, split-KV attention of all heads over the
    bf16 latent cache), which replaces no TPU kernel either.
"""
