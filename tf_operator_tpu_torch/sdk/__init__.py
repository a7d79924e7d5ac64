"""Python SDK (reference: sdk/python/kubeflow/tfjob TFJobClient)."""

from tf_operator_tpu_torch.sdk.client import TPUJobClient  # noqa: F401
