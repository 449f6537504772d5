"""The port's operations: plain PyTorch versions and hand-written CUDA
kernels (``csrc/``), dispatched by the tensors' device."""


def launch_wrappers():
    """The kernel wrappers that count their launches: ``launches``,
    ``launches_by_route`` and K3's ``launches_by_rows``."""
    from creamfl_tpu_torch.ops import (adamp, batchnorm, fused_bn_mm_kernels,
                                       gallery_kernels)

    return (*fused_bn_mm_kernels._WRAPPERS, *gallery_kernels._WRAPPERS,
            *adamp._WRAPPERS, *batchnorm._WRAPPERS)
