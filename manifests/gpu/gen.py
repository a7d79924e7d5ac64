"""Regenerate the GPU port's generated manifests from the port's API
dataclasses (``tf_operator_tpu_torch/api/schema.py``), as
``manifests/gen.py`` does for ``manifests/base`` from the JAX package.
``tests/test_torch_kube.py`` fails when a checked-in copy drifts.

    python manifests/gpu/gen.py

Outputs ``tpujob.schema.json`` (the wire format's JSON Schema) and
``crd.yaml`` (the TPUJob CustomResourceDefinition with a structural
openAPIV3Schema, status subresource and printer columns) beside this
file. ``rbac.yaml``, ``node-agent.yaml`` and ``operator-deployment.yaml``
are written by hand.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from tf_operator_tpu_torch.api import constants  # noqa: E402
from tf_operator_tpu_torch.api.schema import (  # noqa: E402
    generate_crd_schema,
    generate_schema,
)

HERE = os.path.dirname(os.path.abspath(__file__))

CRD_HEADER = """\
# GENERATED by manifests/gpu/gen.py — do not edit (drift fails
# tests/test_torch_kube.py). The GPU port's TPUJob CRD: the API is the
# JAX package's, so one job file runs under either operator.
"""


def crd_manifest() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": constants.CRD_NAME},
        "spec": {
            "group": constants.GROUP,
            "scope": "Namespaced",
            "names": {
                "kind": constants.KIND,
                "listKind": f"{constants.KIND}List",
                "plural": constants.PLURAL,
                "singular": constants.SINGULAR,
                "shortNames": ["tj"],
            },
            "versions": [{
                "name": constants.VERSION,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "additionalPrinterColumns": [
                    {"name": "State", "type": "string",
                     "jsonPath": ".status.conditions[-1:].type"},
                    {"name": "Age", "type": "date",
                     "jsonPath": ".metadata.creationTimestamp"},
                ],
                "schema": {"openAPIV3Schema": generate_crd_schema()},
            }],
        },
    }


def render_schema() -> str:
    return json.dumps(generate_schema(), indent=2, sort_keys=False) + "\n"


def render_crd() -> str:
    import yaml

    return CRD_HEADER + yaml.safe_dump(crd_manifest(), sort_keys=False)


if __name__ == "__main__":
    for name, text in (("tpujob.schema.json", render_schema()),
                       ("crd.yaml", render_crd())):
        path = os.path.join(HERE, name)
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path}")
