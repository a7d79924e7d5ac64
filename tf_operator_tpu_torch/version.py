"""Version info of the GPU port (reference: pkg/version/version.go:21-43;
port of tf_operator_tpu/version.py under the port's own name)."""

__version__ = "0.1.0"
GIT_SHA = "dev"


def version_string() -> str:
    return f"tpu-operator-torch v{__version__} (git {GIT_SHA})"
