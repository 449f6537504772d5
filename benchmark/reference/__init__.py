"""The plain reference the benchmark judges the port against.

Plain PyTorch and NumPy, in float32 with TF32 off. It imports nothing of
the port (``creamfl_tpu_torch``), nor JAX, nor the JAX package. It works out
again everything the port derives from a run's seed: the synthesized
images, the caption and BERT ids, the loader's row order, the weights
(the port's initializers, copied here and frozen), the dropout masks
(drawn from the card's generator in the port's order) and the steps.

``fp8=True`` on a model is the control: every convolution and matrix
product of the trunk and of BERT, the parts the configuration runs in
bfloat16, takes operands rounded to float8 e4m3 with a per-tensor scale,
the next precision below bfloat16. A check that this control does not fail
would let a lower precision pass unseen.
"""

import torch


def strict_fp32() -> None:
    """Matrix products and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
