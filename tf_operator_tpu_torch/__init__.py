"""PyTorch/CUDA port of the tf_operator_tpu compute plane for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``train/``) so each
module sits where its counterpart does. The attention kernels are hand
written CUDA C++ for ``sm_90a`` under ``csrc/``; everything else is plain
PyTorch. The package imports ``torch``, ``numpy`` and the standard library
only: no JAX, and nothing of ``tf_operator_tpu``.

Entry points run on the card (``torch.device("cuda")``) unless the caller
passes ``device="cpu"``.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # torch loads on first use, so the control plane (operator, worker
    # stub) imports the package without it.
    if name == "resolve_device":
        from tf_operator_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
