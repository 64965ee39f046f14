"""One attention layer of a batched decode step on Hopper: RoPE, the new
K/V rows appended to the bf16 cache, and split-KV attention over each
sequence's valid rows (``csrc/decode_attention.cu``).

:func:`decode_attention_fused` does all three; :func:`decode_attention`
only attends, for caches whose rows are written elsewhere; :func:`route`
picks the fused, attend-only or plain route of a decode step.
"""

from repro_torch.kernels.decode_attn.ops import (LAUNCHES, decode_attention,
                                                 decode_attention_fused,
                                                 route)

__all__ = ["LAUNCHES", "decode_attention", "decode_attention_fused", "route"]
