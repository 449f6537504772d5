"""L2 normalization (reference `src/utils/tensor_utils.py` l2_normalize)."""

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / ||x||_2 along ``dim``.

    The squared sum is clamped from below by ``eps**2`` inside the sqrt.
    ``F.normalize`` clamps the norm instead, which gives the same value
    but a different gradient for tiny norms (sqrt'(0) = inf there).
    """
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))
