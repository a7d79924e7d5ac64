"""Structured logging: JSON formatter + contextual job/replica loggers
(port of tf_operator_tpu/runtime/logconfig.py over the port's trace
context).

Reference parity: logrus JSON setup with a filename hook
(cmd/tf-operator.v1/main.go:32-37,58-61) and the contextual field
loggers in vendored common/pkg/util/logger.go:26-96 (fields: job, uid,
replica-type, replica-index, pod).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
from typing import Optional

from tf_operator_tpu_torch.runtime import trace as trace_mod


class JSONFormatter(logging.Formatter):
    """One JSON object per line: time/level/msg/filename plus any
    contextual fields attached via LoggerAdapter extras. Lines emitted
    inside a traced sync additionally carry ``trace_id``/``span`` from
    the ambient trace context (runtime/trace.py), so logs and
    ``/debug/traces`` cross-reference (docs/observability.md)."""

    _SKIP = frozenset(
        logging.makeLogRecord({}).__dict__) | {"message", "asctime"}

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "time": _dt.datetime.fromtimestamp(
                record.created, _dt.timezone.utc).isoformat(),
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
            "filename": f"{record.filename}:{record.lineno}",
            "logger": record.name,
        }
        trace_id, span = trace_mod.current_ids()
        if trace_id:
            out["trace_id"] = trace_id
            out["span"] = span
        for k, v in record.__dict__.items():
            if k not in self._SKIP and not k.startswith("_"):
                out[k] = v
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_logging(json_format: bool = False,
                  level: int = logging.INFO) -> None:
    handler = logging.StreamHandler()
    if json_format:
        handler.setFormatter(JSONFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s %(filename)s:%(lineno)d] "
            "%(message)s"))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)


def logger_for_job(base: logging.Logger, job,
                   rtype: Optional[str] = None,
                   index: Optional[int] = None) -> logging.LoggerAdapter:
    """Contextual logger (reference LoggerForJob/LoggerForReplica,
    util/logger.go:46-96)."""
    extra = {
        "job": f"{job.metadata.namespace}.{job.metadata.name}",
        "uid": job.metadata.uid,
    }
    if rtype is not None:
        extra["replica_type"] = rtype
    if index is not None:
        extra["replica_index"] = index
    return logging.LoggerAdapter(base, extra)
