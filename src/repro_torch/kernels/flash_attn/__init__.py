"""Causal GQA flash attention with an optional sliding window, on Hopper.

:func:`flash_attention` keeps the reference's layout (``q [B, Sq, H, D]``,
``k``/``v`` ``[B, Sk, Hkv, D]``, f32 output ``[B, Sq, H, D]``); on CUDA
tensors it launches the hand-written kernel in
``csrc/flash_attention.cu``.
"""

from repro_torch.kernels.flash_attn.ops import LAUNCHES, flash_attention

__all__ = ["LAUNCHES", "flash_attention"]
