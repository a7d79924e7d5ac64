"""Online-inference serving plane (port of ``tf_operator_tpu/serve``).

A request queue with per-tenant QoS lanes (``queue``), slot-based
continuous batching over the Llama incremental-decode path
(``batcher``/``runner``), the loop that ties them together and publishes
the SLO metrics into ``runtime.metrics`` (``engine``), and the
spool-backed serving worker a ``serving``-role pod runs (``worker``).
Copies of the JAX package's modules: the port imports nothing of it.
"""

from tf_operator_tpu_torch.serve.queue import Request, RequestQueue  # noqa: F401
from tf_operator_tpu_torch.serve.batcher import (  # noqa: F401
    ContinuousBatcher,
    FakeRunner,
)
from tf_operator_tpu_torch.serve.engine import ServingEngine  # noqa: F401
