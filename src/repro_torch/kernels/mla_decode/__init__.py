"""The attention of one multi-head latent attention layer of a batched
decode step on Hopper, absorbed (``csrc/mla_decode.cu``): RoPE on the
query's and the new key's rope dims, the new latent and rope rows
appended to the bf16 caches, and split-KV attention of all heads over
each sequence's latent rows.

:func:`mla_decode_fused` does it; :func:`route` says whether a decode
step's MLA takes the kernel or the plain route (``ref.py``).
"""

from repro_torch.kernels.mla_decode.ops import (LAUNCHES, frequencies,
                                                mla_decode_fused, route)

__all__ = ["LAUNCHES", "frequencies", "mla_decode_fused", "route"]
