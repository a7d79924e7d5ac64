"""TPUJobClient: the user-facing job API (port of
tf_operator_tpu/sdk/client.py: in-process, over the served API, or
straight against Kubernetes).

Reference parity: sdk/python/kubeflow/tfjob/api/tf_job_client.py:55-446 —
create/get/patch/delete, wait_for_job/wait_for_condition, status
helpers (is_job_running/succeeded), get_pod_names/get_logs. The client
talks to a Store (in-process or served); conditions/statuses have the
same shape as the reference SDK's V1JobStatus.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Union

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import Pod, TPUJob
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.store import EVENTS, Store


class TimeoutError_(TimeoutError):
    pass


class TPUJobClient:
    def __init__(self, store: Store, namespace: str = "default"):
        self.store = store
        self.namespace = namespace

    @classmethod
    def connect(cls, server_url: str,
                namespace: str = "default",
                token: Optional[str] = None,
                ca_file: Optional[str] = None,
                insecure_skip_verify: bool = False) -> "TPUJobClient":
        """Client against a served control plane (reference: TFJobClient
        building a kubernetes client from kubeconfig and talking HTTPS,
        tf_job_client.py:55-100). Works from any process or host:

            client = TPUJobClient.connect(
                "https://operator-host:8080",
                token="...", ca_file="/etc/tpu-operator/ca.pem")

        ``token`` is the bearer credential the server's token file
        grants (admin or read-only); ``ca_file`` verifies a self-signed
        server certificate. Defaults to $TPU_OPERATOR_TOKEN when unset.
        """
        import os

        from tf_operator_tpu_torch.runtime.remote import RemoteStore

        token = token or os.environ.get("TPU_OPERATOR_TOKEN") or None
        return cls(RemoteStore(server_url, token=token, ca_file=ca_file,
                               insecure_skip_verify=insecure_skip_verify),
                   namespace=namespace)

    @classmethod
    def connect_kube(cls, kubeconfig: Optional[str] = None,
                     namespace: Optional[str] = None) -> "TPUJobClient":
        """Client directly against a Kubernetes cluster running the
        operator with ``--backend=kube`` — the reference SDK's shape
        (kubernetes-client from kubeconfig, tf_job_client.py:55-100):

            client = TPUJobClient.connect_kube()          # ~/.kube/config
            client = TPUJobClient.connect_kube("/path/to/kubeconfig")
        """
        from tf_operator_tpu_torch.runtime.kube import (
            KubeClient,
            KubeConfig,
            KubeSdkStore,
        )

        config = KubeConfig.resolve(kubeconfig)
        ns = namespace or config.namespace or "default"
        return cls(KubeSdkStore(KubeClient(config), namespace=ns),
                   namespace=ns)

    # -- CRUD (reference tf_job_client.py:77-222) -----------------------

    def create(self, job: Union[TPUJob, dict],
               namespace: Optional[str] = None) -> TPUJob:
        if isinstance(job, dict):
            job = TPUJob.from_dict(job)
        if namespace:
            job.metadata.namespace = namespace
        elif not job.metadata.namespace:
            job.metadata.namespace = self.namespace
        return self.store.create(store_mod.TPUJOBS, job)

    def get(self, name: str, namespace: Optional[str] = None) -> TPUJob:
        return self.store.get(store_mod.TPUJOBS,
                              namespace or self.namespace, name)

    def patch(self, name: str, patch_fn: Callable[[TPUJob], None],
              namespace: Optional[str] = None) -> TPUJob:
        """Optimistic-concurrency read-modify-write (the SDK's patch)."""
        ns = namespace or self.namespace
        for _ in range(10):
            job = self.store.get(store_mod.TPUJOBS, ns, name)
            patch_fn(job)
            try:
                return self.store.update(store_mod.TPUJOBS, job)
            except store_mod.ConflictError:
                continue
        raise store_mod.ConflictError(f"patch of {ns}/{name} kept conflicting")

    def delete(self, name: str, namespace: Optional[str] = None) -> None:
        self.store.delete(store_mod.TPUJOBS, namespace or self.namespace, name)

    def list(self, namespace: Optional[str] = None) -> List[TPUJob]:
        return self.store.list(store_mod.TPUJOBS,
                               namespace=namespace or self.namespace)

    # -- waiting (reference tf_job_client.py:223-305) -------------------

    def wait_for_condition(self, name: str, expected_condition: str,
                           timeout: float = 60.0,
                           namespace: Optional[str] = None,
                           poll_interval: float = 0.05) -> TPUJob:
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            last = self.get(name, namespace)
            if cond.has_condition(last.status, expected_condition):
                return last
            time.sleep(poll_interval)
        conds = [(c.type, c.status) for c in last.status.conditions] if last else []
        raise TimeoutError_(
            f"timed out waiting for {expected_condition} on {name}; "
            f"conditions={conds}")

    def wait_for_job(self, name: str, timeout: float = 60.0,
                     namespace: Optional[str] = None) -> TPUJob:
        """Wait until Succeeded or Failed (reference wait_for_job)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.get(name, namespace)
            if cond.is_finished(job.status):
                return job
            time.sleep(0.05)
        raise TimeoutError_(f"timed out waiting for {name} to finish")

    def watch(self, name: Optional[str] = None,
              namespace: Optional[str] = None,
              timeout: Optional[float] = None,
              until_finished: bool = False):
        """Generator of ``(event_type, TPUJob)`` — the reference
        TFJobWatch analog (sdk api/tf_job_watch.py). Existing jobs are
        replayed as ADDED, then live events stream until ``timeout``
        elapses, the generator is closed, or (with ``until_finished``)
        the named job reaches a terminal condition."""
        import queue as _queue

        ns = namespace or self.namespace
        q: "_queue.Queue" = _queue.Queue()
        watcher = self.store.watch(
            store_mod.TPUJOBS, lambda et, obj: q.put((et, obj)))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                try:
                    event_type, job = q.get(timeout=remaining)
                except _queue.Empty:
                    return
                if job.metadata.namespace != ns:
                    continue
                if name is not None and job.metadata.name != name:
                    continue
                yield event_type, job
                if (until_finished and name is not None
                        and (cond.is_finished(job.status)
                             or event_type == store_mod.DELETED)):
                    # DELETED is terminal too: no further events for
                    # this job will ever arrive.
                    return
        finally:
            watcher.stop()

    def wait_for_delete(self, name: str, timeout: float = 60.0,
                        namespace: Optional[str] = None) -> None:
        deadline = time.monotonic() + timeout
        ns = namespace or self.namespace
        while time.monotonic() < deadline:
            if self.store.try_get(store_mod.TPUJOBS, ns, name) is None:
                return
            time.sleep(0.05)
        raise TimeoutError_(f"timed out waiting for {name} to be deleted")

    # -- status helpers (reference tf_job_client.py:306-342) ------------

    def get_job_status(self, name: str,
                       namespace: Optional[str] = None) -> str:
        job = self.get(name, namespace)
        if job.status.conditions:
            return job.status.conditions[-1].type
        return ""

    def is_job_running(self, name: str, namespace: Optional[str] = None) -> bool:
        return cond.is_running(self.get(name, namespace).status)

    def is_job_succeeded(self, name: str,
                         namespace: Optional[str] = None) -> bool:
        return cond.is_succeeded(self.get(name, namespace).status)

    # -- pods (reference tf_job_client.py:343-446) ----------------------

    def get_pod_names(self, name: str, namespace: Optional[str] = None,
                      replica_type: Optional[str] = None,
                      replica_index: Optional[int] = None) -> List[str]:
        selector: Dict[str, str] = {
            constants.LABEL_GROUP_NAME: constants.GROUP,
            constants.LABEL_JOB_NAME: name,
        }
        if replica_type is not None:
            selector[constants.LABEL_REPLICA_TYPE] = replica_type.lower()
        if replica_index is not None:
            selector[constants.LABEL_REPLICA_INDEX] = str(replica_index)
        pods = self.store.list(store_mod.PODS,
                               namespace=namespace or self.namespace,
                               selector=selector)
        return sorted(p.metadata.name for p in pods)

    def get_pods(self, name: str, namespace: Optional[str] = None) -> List[Pod]:
        return self.store.list(
            store_mod.PODS, namespace=namespace or self.namespace,
            selector={constants.LABEL_GROUP_NAME: constants.GROUP,
                      constants.LABEL_JOB_NAME: name})

    def get_logs(self, pod_name: str, namespace: Optional[str] = None,
                 tail_lines: Optional[int] = None) -> str:
        """One pod's captured stdout/stderr (reference
        tf_job_client.py:380-446 read_namespaced_pod_log analog). Against
        a served control plane this reads through the API server's log
        proxy (kubelet log API); in-process it reads the local file."""
        ns = namespace or self.namespace
        read_remote = getattr(self.store, "read_logs", None)
        if read_remote is not None:
            return read_remote(ns, pod_name, tail_lines=tail_lines)
        pod = self.store.try_get(store_mod.PODS, ns, pod_name)
        if pod is None or not pod.status.log_path:
            return ""
        try:
            with open(pod.status.log_path, errors="replace") as f:
                text = f.read()
        except OSError:
            return ""
        if tail_lines is not None:
            lines = text.splitlines()[-tail_lines:] if tail_lines > 0 else []
            text = "\n".join(lines)
        return text

    def stream_logs(self, pod_name: str, namespace: Optional[str] = None):
        """Follow one pod's log live until it reaches a terminal phase
        (kubectl logs -f). Yields text chunks."""
        import os as _os

        ns = namespace or self.namespace
        remote = getattr(self.store, "stream_logs", None)
        if remote is not None:
            yield from remote(ns, pod_name)
            return
        pos = 0
        while True:
            pod = self.store.try_get(store_mod.PODS, ns, pod_name)
            path = pod.status.log_path if pod is not None else ""
            chunk = b""
            if path and _os.path.exists(path):
                # Binary reads with byte offsets: a text-mode seek with a
                # character count lands mid-codepoint on non-ASCII logs.
                with open(path, "rb") as f:
                    f.seek(pos)
                    chunk = f.read()
            if chunk:
                pos += len(chunk)
                yield chunk.decode(errors="replace")
                continue
            from tf_operator_tpu_torch.api.types import PodPhase

            if pod is None or pod.status.phase in (PodPhase.SUCCEEDED,
                                                   PodPhase.FAILED):
                return
            time.sleep(0.05)

    def follow_job_logs(self, name: str, namespace: Optional[str] = None,
                        replica_type: Optional[str] = None,
                        timeout: Optional[float] = None):
        """Interleaved live tail across every pod of a job (the reference
        SDK's multi-pod follow, tf_job_client.py:380-446: one thread +
        queue per pod). Yields ``(pod_name, chunk)`` until every pod's
        stream ends or ``timeout`` elapses."""
        import queue as _queue
        import threading as _threading

        pods = self.get_pod_names(name, namespace=namespace,
                                  replica_type=replica_type)
        # Bounded queue + stop flag: when the consumer stops (timeout or
        # generator close), pumps must not keep accumulating chunks
        # forever for a still-running job.
        q: "_queue.Queue" = _queue.Queue(maxsize=256)
        stop = _threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def pump(pod_name: str) -> None:
            try:
                for chunk in self.stream_logs(pod_name, namespace=namespace):
                    if not put((pod_name, chunk)):
                        return
            finally:
                put((pod_name, done))

        threads = [_threading.Thread(target=pump, args=(p,), daemon=True)
                   for p in pods]
        for t in threads:
            t.start()
        live = set(pods)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while live:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                try:
                    pod_name, chunk = q.get(timeout=remaining)
                except _queue.Empty:
                    return
                if chunk is done:
                    live.discard(pod_name)
                    continue
                yield pod_name, chunk
        finally:
            stop.set()

    def get_job_logs(self, name: str, namespace: Optional[str] = None,
                     replica_type: Optional[str] = None,
                     tail_lines: Optional[int] = None) -> Dict[str, str]:
        """Logs for every pod of a job, keyed by pod name (the
        reference's multi-pod get_logs surface)."""
        return {
            pod_name: self.get_logs(pod_name, namespace=namespace,
                                    tail_lines=tail_lines)
            for pod_name in self.get_pod_names(
                name, namespace=namespace, replica_type=replica_type)
        }

    def get_events(self, name: str, namespace: Optional[str] = None,
                   reason: str = "") -> List:
        """Lifecycle events for a job and its pods (K8s Events analog,
        persisted by the operator's recorder, attributed by the job-name
        label — never by name-prefix matching)."""
        ns = namespace or self.namespace
        selector = {constants.LABEL_JOB_NAME: name}
        return [e for e in self.store.list(EVENTS, namespace=ns,
                                           selector=selector)
                if not reason or e.reason == reason]

    def get_creation_failures(self, name: str,
                              namespace: Optional[str] = None) -> List[str]:
        """Messages of FailedCreate-class events for a job (reference
        get_creation_failures_from_tfjob, tf_job_client.py:363)."""
        return [e.message for e in self.get_events(name, namespace=namespace)
                if e.reason.startswith("FailedCreate")]

    # -- explain (flight-recorder decision journal) ---------------------

    def explain(self, name: str,
                namespace: Optional[str] = None) -> Dict:
        """Why is my job in this state — answered from the operator,
        not from log archaeology (docs/observability.md): the job's
        conditions, its decision-journal records (every admission
        defer/deny, barrier open/resolve, displacement, and resize the
        control plane decided, with reasons and trace ids), and its
        recent lifecycle events.

        The journal is read in-process (runtime/trace.py JOURNAL) —
        against a remote store this surface carries conditions/events
        only; the journal of a remote operator is served by ITS
        monitoring endpoint at ``/debug/jobs/<ns>/<name>``."""
        ns = namespace or self.namespace
        job = self.get(name, ns)
        from tf_operator_tpu_torch.runtime import trace as trace_lib

        decisions = trace_lib.JOURNAL.decisions(ns, name) or []
        return {
            "namespace": ns,
            "name": name,
            "phase": (job.status.conditions[-1].type
                      if job.status.conditions else ""),
            "conditions": [
                {"type": c.type, "status": c.status, "reason": c.reason,
                 "message": c.message}
                for c in job.status.conditions],
            "decisions": decisions,
            "events": [
                {"type": e.type, "reason": e.reason, "message": e.message}
                for e in self.get_events(name, namespace=ns)[-20:]],
        }

    def explain_text(self, name: str,
                     namespace: Optional[str] = None) -> str:
        """``tpujob explain``-style rendering of :meth:`explain` (the
        CLI surface: ``python -c`` one-liners and notebooks print it)."""
        info = self.explain(name, namespace=namespace)
        lines = [f"TPUJob {info['namespace']}/{info['name']}: "
                 f"{info['phase'] or 'no conditions yet'}"]
        for c in info["conditions"]:
            lines.append(f"  condition {c['type']}={c['status']} "
                         f"({c['reason']}): {c['message']}")
        if info["decisions"]:
            lines.append("  decision journal (oldest first):")
            for d in info["decisions"]:
                count = f" x{d['count']}" if d.get("count", 1) > 1 else ""
                tid = f" [{d['trace_id']}]" if d.get("trace_id") else ""
                lines.append(f"    {d['kind']}/{d['reason']}{count}"
                             f"{tid}: {d['message']}")
        else:
            lines.append("  decision journal: no control-plane decision "
                         "has touched this job")
        return "\n".join(lines)
