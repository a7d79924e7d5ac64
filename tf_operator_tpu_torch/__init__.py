"""PyTorch/CUDA port of the tf_operator_tpu compute plane for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``train/``) so each
module sits where its counterpart does. The attention kernels are hand
written CUDA C++ for ``sm_90a`` under ``csrc/``; everything else is plain
PyTorch. The package imports ``torch``, ``numpy`` and the standard library
only: no JAX, and nothing of ``tf_operator_tpu``.

Entry points run on the card (``torch.device("cuda")``) unless the caller
passes ``device="cpu"``.
"""

from tf_operator_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
