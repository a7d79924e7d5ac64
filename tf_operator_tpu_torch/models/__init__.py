"""Models of the port (``tf_operator_tpu.models``)."""
