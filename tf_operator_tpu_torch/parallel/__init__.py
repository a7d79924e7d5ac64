"""Multi-process training: bring-up, device mesh and sharding rules
(port of tf_operator_tpu/parallel/ and of the payloads' distributed
bring-up)."""
