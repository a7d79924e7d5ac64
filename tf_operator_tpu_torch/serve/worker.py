"""Serving worker — what a ``serving``-role pod runs.

File-spool protocol (deterministic, dependency-free, worker_stub-style):
a shared spool directory (rendered from ServingPolicy.spoolDirectory as
``TPUJOB_SERVE_SPOOL``) holds::

    spool/pending/<id>.json      requests waiting for any replica
    spool/claimed/<pod>/<id>.json  requests this replica is serving
    spool/done/<id>.json         responses
    spool/.close                 sentinel: exit 0 once all work is done

Claiming is an atomic ``os.rename`` out of pending/ — exactly one
replica wins a request; the loser's rename raises and it moves on.

Drain-mid-traffic (the health path and the checkpoint barrier, applied to
inference): when the control plane opens a save-before-evict barrier,
the preemption notice arrives through ``TPUJOB_PREEMPT_FILE``. The
worker drains its engine — queued AND in-flight sequences go back to
pending/ (rename, so nothing is ever lost mid-copy) — then acks the
barrier through ``TPUJOB_CKPT_FILE`` (the data plane mirrors it into
this pod's CheckpointRecord) and stops claiming. The "checkpoint" of a
serving replica IS the re-spool: once it lands, evicting the pod drops
zero requests; the rebound replicas re-claim and complete them.

Copy of ``tf_operator_tpu/serve/worker.py`` on the port's serving modules,
byte-compatible with it on disk (both can share one spool). Its one
addition is ``--device``: the ``llama`` runner runs on the CUDA card
unless ``--device cpu`` is given.

Run as ``python -m tf_operator_tpu_torch.serve.worker [flags]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional

from tf_operator_tpu_torch.serve.batcher import ContinuousBatcher, FakeRunner
from tf_operator_tpu_torch.serve.engine import ServingEngine
from tf_operator_tpu_torch.serve.queue import (
    Request,
    RequestQueue,
    parse_tenant_weights,
)

log = logging.getLogger("tpu_operator.serve.worker")

CLOSE_SENTINEL = ".close"


class Spool:
    """The shared request spool; every mutation is an atomic rename or
    a tmp-write + replace, so a crash mid-operation never corrupts or
    drops a request."""

    def __init__(self, root: str, pod: str):
        self.root = root
        self.pending = os.path.join(root, "pending")
        self.claimed = os.path.join(root, "claimed", pod)
        self.done = os.path.join(root, "done")
        for d in (self.pending, self.claimed, self.done):
            os.makedirs(d, exist_ok=True)
        self.pod = pod

    def claim_one(self) -> Optional[Request]:
        """Atomically claim the lexically-first pending request; None
        when pending is empty (or every rename was lost to a peer)."""
        try:
            names = sorted(n for n in os.listdir(self.pending)
                           if n.endswith(".json"))
        except OSError:
            return None
        for name in names:
            src = os.path.join(self.pending, name)
            dst = os.path.join(self.claimed, name)
            try:
                os.rename(src, dst)
            except OSError:
                continue  # a peer won this one
            try:
                with open(dst) as f:
                    data = json.load(f)
                return Request(
                    id=str(data.get("id", name[:-len(".json")])),
                    tenant=str(data.get("tenant", "") or "default"),
                    prompt=[int(t) for t in data.get("prompt", [])],
                    max_new_tokens=int(data.get("maxNewTokens", 16)))
            except (OSError, ValueError, TypeError):
                # Unparseable claim: return it so another replica (or a
                # fixed producer) can retry; never serve garbage.
                self.requeue_id(name[:-len(".json")])
                continue
        return None

    def requeue_id(self, request_id: str) -> None:
        """Return a claimed request to pending/ (atomic rename)."""
        src = os.path.join(self.claimed, f"{request_id}.json")
        dst = os.path.join(self.pending, f"{request_id}.json")
        try:
            os.rename(src, dst)
        except OSError:
            pass  # already finished or already returned

    def finish(self, request: Request) -> None:
        path = os.path.join(self.done, f"{request.id}.json")
        payload = {
            "id": request.id,
            "tenant": request.tenant,
            "tokens": list(request.output),
            "servedBy": self.pod,
            "ttftSeconds": request.ttft_seconds,
        }
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(path + ".tmp", path)
        try:
            os.unlink(os.path.join(self.claimed, f"{request.id}.json"))
        except OSError:
            pass

    def closed(self) -> bool:
        return os.path.exists(os.path.join(self.root, CLOSE_SENTINEL))

    def pending_empty(self) -> bool:
        try:
            return not any(n.endswith(".json")
                           for n in os.listdir(self.pending))
        except OSError:
            return True

    def claimed_empty(self) -> bool:
        try:
            return not any(n.endswith(".json")
                           for n in os.listdir(self.claimed))
        except OSError:
            return True


def _read_notice(path: str) -> Optional[dict]:
    if not path:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _publish_record(path: str, completed: int, barrier: str,
                    directory: str, restored: Optional[int]) -> None:
    """Publish serving state in the checkpoint-record wire format the
    data plane mirrors into this pod's CheckpointRecord
    (train/checkpoint.py CheckpointHook._publish): ``step`` counts
    completed requests, and ``barrier`` carries the drain ack."""
    if not path:
        return
    payload = {
        "step": completed,
        "progress_step": completed,
        "barrier": barrier,
        "directory": directory,
        "save_seconds": 0.0,
        "restored_from_step": restored,
    }
    try:
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(path + ".tmp", path)
    except OSError:
        pass


def _fake_runner(slots: int, device):
    return FakeRunner(max_slots=slots)


def _llama_runner(slots: int, device):
    from tf_operator_tpu_torch.serve.runner import LlamaRunner

    return LlamaRunner(max_slots=slots, device=device)


def _mixtral_runner(slots: int, device):
    from tf_operator_tpu_torch.serve.runner import MixtralRunner

    return MixtralRunner(max_slots=slots, device=device)


# Runner registry: factories import their model lazily, so the fake
# runner never builds one.
RUNNERS = {
    "fake": _fake_runner,
    "llama": _llama_runner,
    "mixtral": _mixtral_runner,
}


def build_runner(kind: str, slots: int, device=None):
    factory = RUNNERS.get(kind)
    if factory is None:
        raise ValueError(f"unknown runner {kind!r}; expected "
                         + "|".join(sorted(RUNNERS)))
    return factory(slots, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runner", default="fake",
                        choices=tuple(sorted(RUNNERS)),
                        help="decode backend: 'fake' = deterministic "
                             "model-free generator (hermetic e2e); "
                             "'llama'/'mixtral' = the incremental-decode "
                             "paths (models/llama.py, models/mixtral.py)")
    parser.add_argument("--poll-interval", type=float, default=0.02)
    parser.add_argument("--spool", default=None,
                        help="override TPUJOB_SERVE_SPOOL")
    parser.add_argument("--device", default=None,
                        help="torch device of the model runners (default: "
                             "the CUDA card)")
    args = parser.parse_args(argv)

    spool_root = args.spool or os.environ.get("TPUJOB_SERVE_SPOOL", "")
    if not spool_root:
        print("serving worker: TPUJOB_SERVE_SPOOL not set", flush=True)
        return 2
    pod = os.environ.get("TPUJOB_POD_NAME", f"pid-{os.getpid()}")
    slots = int(os.environ.get("TPUJOB_SERVE_SLOTS", "4") or 4)
    max_queue = int(os.environ.get("TPUJOB_SERVE_MAX_QUEUE", "64") or 64)
    max_tokens = int(os.environ.get("TPUJOB_SERVE_MAX_TOKENS", "64") or 64)
    weights = parse_tenant_weights(
        os.environ.get("TPUJOB_SERVE_TENANT_WEIGHTS", ""))
    preempt_file = os.environ.get("TPUJOB_PREEMPT_FILE", "")
    record_file = os.environ.get("TPUJOB_CKPT_FILE", "")
    restored = None
    raw_restore = os.environ.get("TPUJOB_RESTORE_STEP", "")
    if raw_restore:
        try:
            restored = int(raw_restore)
        except ValueError:
            restored = None

    spool = Spool(spool_root, pod)
    queue = RequestQueue(max_depth=max_queue, tenant_weights=weights)
    batcher = ContinuousBatcher(build_runner(args.runner, slots,
                                             args.device))
    engine = ServingEngine(queue, batcher,
                           on_complete=lambda r: spool.finish(r))

    if restored is not None:
        print(f"serving worker {pod} resumed after drain "
              f"(fleet had served {restored} requests)", flush=True)
    print(f"serving worker {pod} started (runner={args.runner} "
          f"slots={slots})", flush=True)
    # First record: makes this replica a required barrier participant
    # from the start (controller/ckpt.py _required_acks).
    _publish_record(record_file, 0, "", spool_root, restored)

    acked_barrier = ""
    draining = False
    while True:
        notice = _read_notice(preempt_file)
        if notice and notice.get("barrier") and \
                notice["barrier"] != acked_barrier:
            barrier = str(notice["barrier"])
            evicted = engine.drain()
            for request in evicted:
                spool.requeue_id(request.id)
            acked_barrier = barrier
            draining = True
            _publish_record(record_file, engine.completed_total,
                            barrier, spool_root, restored)
            print(f"serving worker {pod}: drained, requeued "
                  f"{len(evicted)} request(s) for barrier {barrier}",
                  flush=True)

        progressed = False
        if not draining:
            while queue.depth() < max_queue:
                request = spool.claim_one()
                if request is None:
                    break
                request.max_new_tokens = min(request.max_new_tokens,
                                             max_tokens)
                if not queue.submit(request):
                    spool.requeue_id(request.id)
                    break
                progressed = True
            if not engine.idle:
                done = engine.step()
                progressed = progressed or bool(done)
                for request in done:
                    print(f"served {request.id} "
                          f"({len(request.output)} tokens, "
                          f"tenant={request.tenant})", flush=True)
                if done:
                    _publish_record(record_file, engine.completed_total,
                                    acked_barrier, spool_root, restored)

        if (spool.closed() and engine.idle and spool.pending_empty()
                and spool.claimed_empty()):
            print(f"serving worker {pod} done: "
                  f"{engine.completed_total} request(s) served",
                  flush=True)
            return 0
        if not progressed:
            time.sleep(args.poll_interval)


if __name__ == "__main__":
    sys.exit(main())
