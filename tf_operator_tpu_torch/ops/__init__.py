"""Layers and attention kernels of the port (``tf_operator_tpu.ops``)."""
