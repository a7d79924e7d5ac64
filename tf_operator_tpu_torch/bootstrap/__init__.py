"""Cluster bootstrap: slice topology -> worker ranks -> env injection.

Reference parity: pkg/controller.v1/tensorflow/tensorflow.go (TF_CONFIG
rendering) replaced by the torch.distributed env (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, LOCAL_WORLD_SIZE, and RANK / LOCAL_RANK or
GROUP_RANK / GROUP_WORLD_SIZE: one process a GPU).
"""

from tf_operator_tpu_torch.bootstrap.topology import SliceTopology, parse_accelerator  # noqa: F401
from tf_operator_tpu_torch.bootstrap.cluster import (  # noqa: F401
    ClusterSpec,
    build_cluster_spec,
    learner_endpoints,
    render_worker_env,
)
