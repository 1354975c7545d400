"""The plain references that decide ``correct``: float32 PyTorch and NumPy,
no kernels, no cache, no batching of requests.  Nothing here imports the
port, the JAX package or ``jax``; what the port's own code would give
(the byte tokenizer's rule, the chunker, the relative-position buckets, the
ALiBi slopes, the int8c rule) is written out again here.

Matrix products here run in true float32: TF32 is switched off before
any reference runs (:func:`strict_f32`).
"""

import torch


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
