"""Training of the port (``tf_operator_tpu.train``)."""
