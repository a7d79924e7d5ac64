"""JSON-Schema generation for the TPUJob API surface (port of
tf_operator_tpu/api/schema.py over the port's ``api/types.py`` and
``serde.py``; its checked-in copy is ``manifests/gpu/``).

The reference ships a generated OpenAPI schema (openapi_generated.go,
13.5k lines) that backs CRD validation (manifests/base/crd.yaml
openAPIV3Schema) and SDK model generation. Here the schema is derived
reflectively from the same dataclasses that define the wire format
(api/types.py + serde.py), so it can never drift from the code — and a
checked-in copy under manifests/ is kept honest by a codegen-verify
test (the hack/verify-codegen.sh analog).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any, Dict, Union, get_args, get_origin

from tf_operator_tpu_torch.api.serde import (
    ApiObject,
    _hints_for,
    _unwrap_optional,
    snake_to_camel,
)

_PRIMITIVES = {
    str: {"type": "string"},
    int: {"type": "integer"},
    float: {"type": "number"},
    bool: {"type": "boolean"},
}


def _is_int_or_string(tp: Any) -> bool:
    """Union[int, str] in either order (e.g. ObjectMeta.resource_version:
    locally an int, an opaque server string on the kube mirror) — the
    K8s IntOrString pattern."""
    if get_origin(tp) is not Union:
        return False
    args = set(a for a in get_args(tp) if a is not type(None))
    return args == {int, str}


def _type_schema(tp: Any, defs: Dict[str, dict]) -> dict:
    if _is_int_or_string(tp):
        return {"type": ["integer", "string"]}
    tp = _unwrap_optional(tp)
    if tp in _PRIMITIVES:
        return dict(_PRIMITIVES[tp])
    if tp is _dt.datetime:
        return {"type": "string", "format": "date-time"}
    if tp is Any or tp is object:
        return {}
    origin = get_origin(tp)
    if origin in (list, tuple):
        args = get_args(tp)
        item = _type_schema(args[0], defs) if args else {}
        return {"type": "array", "items": item}
    if origin is dict:
        args = get_args(tp)
        val = _type_schema(args[1], defs) if len(args) == 2 else {}
        return {"type": "object", "additionalProperties": val}
    if isinstance(tp, type) and issubclass(tp, ApiObject):
        name = tp.__name__
        if name not in defs:
            defs[name] = {}  # placeholder breaks recursion cycles
            defs[name] = _object_schema(tp, defs)
        return {"$ref": f"#/$defs/{name}"}
    return {}  # unknown: accept anything (parity with unvalidated fields)


def _object_schema(cls, defs: Dict[str, dict]) -> dict:
    props = {}
    for f in dataclasses.fields(cls):
        hint = _hints_for(cls).get(f.name, Any)
        props[snake_to_camel(f.name)] = _type_schema(hint, defs)
    return {
        "type": "object",
        "properties": props,
        "additionalProperties": False,
    }


def generate_schema(cls=None) -> dict:
    """JSON Schema (draft 2020-12) for ``cls`` (default: TPUJob)."""
    if cls is None:
        from tf_operator_tpu_torch.api.types import TPUJob
        cls = TPUJob
    defs: Dict[str, dict] = {}
    root = _object_schema(cls, defs)
    schema = {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "$id": f"https://tpu-operator.dev/schemas/{cls.__name__}.json",
        "title": cls.__name__,
        **root,
    }
    if defs:
        schema["$defs"] = dict(sorted(defs.items()))
    return schema


# ---------------------------------------------------------------------------
# CRD structural schema (reference: manifests/base/crd.yaml openAPIV3Schema,
# backed by openapi_generated.go). Kubernetes structural schemas forbid
# $ref and sibling additionalProperties/properties, so this variant
# inlines definitions and keeps every node typed.
# ---------------------------------------------------------------------------

def _structural(tp: Any, depth: int = 0) -> dict:
    if depth > 16:  # cycle guard: no API type recurses, this is a backstop
        return {"type": "object",
                "x-kubernetes-preserve-unknown-fields": True}
    if _is_int_or_string(tp):
        # K8s native IntOrString marker: a `type: object` fallback here
        # would make the apiserver REJECT the scalar forms.
        return {"x-kubernetes-int-or-string": True}
    tp = _unwrap_optional(tp)
    if tp in _PRIMITIVES:
        return dict(_PRIMITIVES[tp])
    if tp is _dt.datetime:
        return {"type": "string", "format": "date-time"}
    if tp is Any or tp is object:
        return {"type": "object",
                "x-kubernetes-preserve-unknown-fields": True}
    origin = get_origin(tp)
    if origin in (list, tuple):
        args = get_args(tp)
        item = (_structural(args[0], depth + 1) if args
                else {"type": "object",
                      "x-kubernetes-preserve-unknown-fields": True})
        return {"type": "array", "items": item}
    if origin is dict:
        args = get_args(tp)
        val = (_structural(args[1], depth + 1) if len(args) == 2
               else {"type": "string"})
        return {"type": "object", "additionalProperties": val}
    if isinstance(tp, type) and issubclass(tp, ApiObject):
        props = {}
        for f in dataclasses.fields(tp):
            hint = _hints_for(tp).get(f.name, Any)
            props[snake_to_camel(f.name)] = _structural(hint, depth + 1)
        return {"type": "object", "properties": props}
    return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}


def generate_crd_schema() -> dict:
    """openAPIV3Schema for the TPUJob CRD: spec + status only (metadata
    belongs to the API machinery; reference crd.yaml:22-47 likewise
    validates only replica bounds under spec)."""
    from tf_operator_tpu_torch.api.types import JobStatus, TPUJobSpec

    return {
        "type": "object",
        "properties": {
            "spec": _structural(TPUJobSpec),
            "status": _structural(JobStatus),
        },
    }
