"""Controller: condition machine, expectations, reconcile engine.

Reference parity: pkg/controller.v1/tensorflow/ plus the vendored
kubeflow/common controller engine, rebuilt as first-class modules.
"""
