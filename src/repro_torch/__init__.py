"""SliceMoE on PyTorch and CUDA (NVIDIA Hopper).

The port of :mod:`repro` (JAX/Pallas) to PyTorch, one slice at a time.
The file layout mirrors ``repro/``; inside the files the code is plain
PyTorch on explicit devices.  The JAX package stays the reference: every
ported module has a parity test against its counterpart
(``tests/test_torch_*.py``), with weights carried across by
:mod:`repro_torch.bridge`.

Entry points (``init_params``, the engines, the server and the
scheduler) run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises.  The expert FFN's fused AMAT
dequant-matmul is a CUDA C++ kernel for ``sm_90a``
(:mod:`repro_torch.kernels.amat_matmul`); the counterparts of the JAX
package's other Pallas kernels sit beside it under
:mod:`repro_torch.kernels`.  On CPU tensors each wrapper runs its plain
PyTorch version instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
