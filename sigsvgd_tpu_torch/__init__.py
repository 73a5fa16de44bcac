"""PyTorch/CUDA port of ``sigsvgd_tpu`` (Stein-variational MPC on one H100).

The JAX package ``sigsvgd_tpu`` is the reference; this package keeps its
module names and semantics, in PyTorch idiom. It never imports JAX or the
JAX package. Entry points take ``device=None``, which means ``"cuda"``; they
raise when CUDA is unavailable unless the caller asks for the CPU.

fp32 throughout: TF32 is switched off for matmuls and convolutions here, at
import, because the reference's prior gradient uses ``precision="highest"``
matmuls and every parity tolerance of the port assumes full fp32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ._device import resolve_device  # noqa: E402,F401
