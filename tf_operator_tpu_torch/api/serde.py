"""Dataclass <-> camelCase-dict serialization for API objects.

The reference gets this from Kubernetes codegen (zz_generated.deepcopy.go,
openapi_generated.go). Here a single reflective base class covers the whole
API surface: snake_case dataclass fields serialize to camelCase wire keys
(K8s JSON convention), datetimes to RFC3339, nested ApiObjects recursively.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime as _dt
import functools
from typing import Any, Optional, Union, get_args, get_origin, get_type_hints


def snake_to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _rfc3339(ts: _dt.datetime) -> str:
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=_dt.timezone.utc)
    ts = ts.astimezone(_dt.timezone.utc)
    if ts.microsecond:
        return ts.strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    return ts.strftime("%Y-%m-%dT%H:%M:%SZ")


def parse_time(v: Union[str, _dt.datetime, None]) -> Optional[_dt.datetime]:
    if v is None or isinstance(v, _dt.datetime):
        return v
    s = v.replace("Z", "+00:00")
    return _dt.datetime.fromisoformat(s)


def _unwrap_optional(tp: Any) -> Any:
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _encode(value: Any) -> Any:
    if value is None:
        return None
    if isinstance(value, ApiObject):
        return value.to_dict()
    if isinstance(value, _dt.datetime):
        return _rfc3339(value)
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    return value


def _decode(tp: Any, value: Any) -> Any:
    if value is None:
        return None
    tp = _unwrap_optional(tp)
    origin = get_origin(tp)
    if origin in (list, tuple):
        (item_tp,) = get_args(tp) or (Any,)
        return [_decode(item_tp, v) for v in value]
    if origin is dict:
        args = get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: _decode(val_tp, v) for k, v in value.items()}
    if isinstance(tp, type) and issubclass(tp, ApiObject):
        return tp.from_dict(value)
    if tp is _dt.datetime:
        return parse_time(value)
    return value


_ATOMIC = (str, int, float, bool, _dt.datetime, bytes, type(None))


def _clone(value: Any) -> Any:
    """Structural copy for ApiObject field values: immutable leaves are
    shared, containers and nested ApiObjects are copied recursively,
    anything else defers to the generic ``copy.deepcopy``."""
    if isinstance(value, _ATOMIC):
        return value
    if isinstance(value, ApiObject):
        return _clone_obj(value)
    if isinstance(value, dict):
        return {k: _clone(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_clone(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_clone(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return type(value)(_clone(v) for v in value)
    return copy.deepcopy(value)


def _clone_obj(obj: "ApiObject") -> "ApiObject":
    """Clone one ApiObject. Separate from ``ApiObject.deepcopy`` so the
    public method is the single countable entry point (benchmarks and
    allocation tests patch it to count copies per *object graph*, not
    per nested dataclass)."""
    cls = type(obj)
    new = cls.__new__(cls)
    new.__dict__ = {k: _clone(v) for k, v in obj.__dict__.items()}
    return new


@functools.lru_cache(maxsize=None)
def _hints_for(cls) -> dict:
    # get_type_hints re-evaluates stringified annotations on every call;
    # from_dict sits on the reconcile hot path, so cache per class.
    return get_type_hints(cls)


@functools.lru_cache(maxsize=None)
def _wire_keys_for(cls) -> tuple:
    return tuple((f.name, snake_to_camel(f.name))
                 for f in dataclasses.fields(cls))


@dataclasses.dataclass
class ApiObject:
    """Base for all API dataclasses; provides wire-format round-tripping."""

    def to_dict(self, explicit_nulls: bool = False) -> dict:
        """Wire-format dict. ``explicit_nulls=True`` emits unset/empty
        TOP-LEVEL fields as JSON ``null`` instead of omitting them —
        required for RFC 7386 merge-patch writers (a merge patch can
        only clear a field it names). Nested objects keep omit-empty:
        nulling recursively would turn every partial update into a
        destructive replace."""
        out = {}
        for name, wire in _wire_keys_for(type(self)):
            v = getattr(self, name)
            # Omit empty containers to keep wire objects tidy (K8s
            # omitempty) — unless the caller needs clear-on-patch.
            if v is None or (isinstance(v, (dict, list)) and not v):
                if explicit_nulls:
                    out[wire] = None
                continue
            out[wire] = _encode(v)
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "ApiObject":
        if data is None:
            data = {}
        hints = _hints_for(cls)
        kwargs = {}
        for name, wire in _wire_keys_for(cls):
            if wire in data:
                raw = data[wire]
            elif name in data:  # tolerate snake_case input
                raw = data[name]
            else:
                continue
            kwargs[name] = _decode(hints.get(name, Any), raw)
        return cls(**kwargs)

    def deepcopy(self):
        """Analog of the generated DeepCopy (zz_generated.deepcopy.go).

        Hand-rolled instead of ``copy.deepcopy``: API objects are
        acyclic trees of dataclasses, scalars, datetimes and str->str
        dicts, so the generic protocol's memo dict and ``__reduce_ex__``
        round-trips buy nothing — and this sits on the store's hottest
        path (one copy per create/update plus one per watch event).
        Immutable leaves (str/int/float/bool/datetime) are shared, not
        copied; anything unrecognized falls back to ``copy.deepcopy``.
        """
        return _clone_obj(self)
