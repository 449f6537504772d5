"""The gallery ops the losses and con_w call, under the JAX package's names.

The choice between kernel and plain version is made in one place, the
wrappers of ``ops.gallery_kernels``: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain PyTorch version
(``ops.gallery``). There is no global switch: the plain functions can be
called directly.
"""

from __future__ import annotations

from creamfl_tpu_torch.ops import gallery_kernels as kernels

gallery_ce = kernels.fused_gallery_ce
conw_diag_log_softmax = kernels.conw_diag
