"""PyTorch/CUDA port of ``sigsvgd_tpu`` (Stein-variational MPC on one H100).

The JAX package ``sigsvgd_tpu`` is the reference; this package keeps its
module names and semantics, in PyTorch idiom. It never imports JAX or the
JAX package. Entry points take ``device=None``, which means ``"cuda"``; they
raise when CUDA is unavailable unless the caller asks for the CPU.

fp32 throughout: TF32 is switched off for matmuls and convolutions here, at
import, because the reference's prior gradient uses ``precision="highest"``
matmuls and every parity tolerance of the port assumes full fp32.

CPU results do not depend on the process: PyTorch computes a CPU ``exp``
(and ``sin``, ``log``, ...) of a float tensor by MKL's vector math library,
each OpenMP thread on its own slice, and the first such call of a process
that runs on several threads was seen to give one worker thread's slice at
about 1.5e-4 relative error (MKL's low-accuracy level) instead of one ulp,
in roughly one process in six. Later calls are exact, whatever the
function. So one multi-threaded call runs here, at import, before any twin.
It covers the OpenMP threads that exist at import: a later
``torch.set_num_threads`` that starts more threads is not warmed up.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one slice of 65536 floats for every CPU thread (twice the parallel grain)
torch.exp(torch.zeros(max(torch.get_num_threads(), 1) * 65536))

from ._device import resolve_device  # noqa: E402,F401
