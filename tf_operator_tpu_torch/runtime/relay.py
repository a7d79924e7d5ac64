"""Shared notice/checkpoint relay — the contract between the control
plane and the worker process, factored out of the data planes.

Both node planes implement the same loop (SURVEY §3.3's kubelet status
feedback, specialized to checkpoint coordination): a preemption notice
stamped on the pod must reach the worker as a file at
``TPUJOB_PREEMPT_FILE``, and the worker's checkpoint state published at
``TPUJOB_CKPT_FILE`` must flow back into its ``CheckpointRecord`` so
controller/ckpt.py can run save-before-evict barriers and derive
restore steps. ``LocalProcessBackend`` (runtime/local.py) does this for
subprocesses it spawned; ``runtime/nodeagent.py`` does it for pods the
kubelet runs, through a shared relay volume. This module holds the
path derivation, the atomic notice publish, and the checkpoint-file →
CheckpointRecord mirror so the two planes cannot drift.

File paths are keyed by the pod's relay token — the controller-stamped
``tpu-operator.dev/relay-token`` annotation when present, else the pod
uid. Either way the key is per-incarnation: a restart-with-identity
(same name, new pod) must never read the dead incarnation's notice and
"ack" a barrier it never saved under. The token exists because on kube
the file path is rendered into container env at pod-create time, before
the apiserver assigns a uid.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Tuple

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CheckpointRecord,
    CheckpointRecordStatus,
    ObjectMeta,
    Pod,
)
from tf_operator_tpu_torch.runtime import store as store_mod

log = logging.getLogger("tpu_operator.relay")


def pod_token(pod: Pod) -> str:
    """Per-incarnation file key: the controller's relay token when
    stamped, else the first 8 uid chars (the local backend's historical
    scheme — paths there are unchanged by the token's existence)."""
    token = pod.metadata.annotations.get(constants.ANNOTATION_RELAY_TOKEN, "")
    if token:
        return token
    return (pod.metadata.uid or "nouid")[:8]


def preempt_path(base_dir: str, pod: Pod) -> str:
    """Where this pod's worker process finds a preemption notice."""
    return os.path.join(
        base_dir,
        f"{pod.metadata.namespace}.{pod.metadata.name}.{pod_token(pod)}"
        ".preempt.json")


def ckpt_path(base_dir: str, pod: Pod) -> str:
    """Where this pod's worker process publishes checkpoint state
    (saves / barrier acks / restore confirmation)."""
    return os.path.join(
        base_dir,
        f"{pod.metadata.namespace}.{pod.metadata.name}.{pod_token(pod)}"
        ".ckpt.json")


def forward_notice(base_dir: str, pod: Pod, notice: str,
                   last_written: str) -> str:
    """Atomically publish the pod's preemption notice to its notice
    file (the training loop polls it each step). Returns the new
    dedup marker — callers persist it per pod so each barrier's notice
    hits the file once. Raises ``OSError`` on write failure; callers
    retry on the next event/poll."""
    if not notice or last_written == notice:
        return last_written
    path = preempt_path(base_dir, pod)
    os.makedirs(base_dir, exist_ok=True)
    with open(path + ".tmp", "w") as f:
        f.write(notice)
    os.replace(path + ".tmp", path)
    log.info("preemption notice forwarded to pod %s/%s",
             pod.metadata.namespace, pod.metadata.name)
    return notice


def read_ckpt_file(path: str,
                   last_mtime: int) -> Tuple[Optional[dict], int]:
    """Read the worker's checkpoint file if it changed since
    ``last_mtime`` (st_mtime_ns). Returns ``(data, new_mtime)``; data
    is None when the file is absent, unchanged, or partially written
    (the next poll retries — mtime only advances on a full parse)."""
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None, last_mtime
    if mtime == last_mtime:
        return None, last_mtime
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None, last_mtime
    if not isinstance(data, dict):
        return None, last_mtime
    return data, mtime


def ckpt_status_from_data(data: dict, now) -> CheckpointRecordStatus:
    """Convert a worker checkpoint-file payload (or its annotation
    mirror) into a CheckpointRecordStatus."""
    restored = data.get("restored_from_step")
    return CheckpointRecordStatus(
        step=int(data.get("step", -1)),
        progress_step=int(data.get("progress_step", data.get("step", -1))),
        barrier_id=str(data.get("barrier", "")),
        directory=str(data.get("directory", "")),
        save_seconds=float(data.get("save_seconds", 0.0)),
        restored_from_step=(int(restored) if restored is not None else None),
        updated_at=now)


def upsert_checkpoint_record(store, pod: Pod, data: dict, now) -> bool:
    """Mirror a worker checkpoint payload into the pod's
    CheckpointRecord (create-or-update-status, named after the pod,
    labeled/owned like it). Returns False on a store race — the caller
    resets its mtime/dedup marker so the next tick re-mirrors."""
    status = ckpt_status_from_data(data, now)
    ns, name = pod.metadata.namespace, pod.metadata.name
    try:
        existing = store.try_get(store_mod.CHECKPOINTRECORDS, ns, name)
        if existing is None:
            record = CheckpointRecord(
                metadata=ObjectMeta(
                    name=name, namespace=ns,
                    labels={k: v for k, v in pod.metadata.labels.items()
                            if k in (constants.LABEL_JOB_NAME,
                                     constants.LABEL_REPLICA_TYPE,
                                     constants.LABEL_REPLICA_INDEX)},
                    owner_references=[r.deepcopy() for r in
                                      pod.metadata.owner_references]),
                status=status)
            store.create(store_mod.CHECKPOINTRECORDS, record)
        else:
            existing.status = status
            store.update_status(store_mod.CHECKPOINTRECORDS, existing)
    except (store_mod.AlreadyExistsError, store_mod.ConflictError,
            store_mod.NotFoundError):
        return False
    return True


def cleanup(base_dir: str, pod: Pod) -> None:
    """Remove the pod's relay files — retention follows the pod object
    (kubelet log-retention semantics)."""
    for path in (preempt_path(base_dir, pod), ckpt_path(base_dir, pod)):
        try:
            os.unlink(path)
        except OSError:
            pass
