"""Apply a TPUJob file against the port's hermetic local runtime (port of
examples/run_local.py).

    python -m tf_operator_tpu_torch.run_local job.json|job.yaml [--workdir DIR]

The `kubectl apply -f` + `kubectl logs` analog (reference SDK
`TFJobClient.create`/`get_logs`, sdk/.../tf_job_client.py:77,380):
starts an in-process GPU operator with the subprocess pod backend, submits
the job, waits for Succeeded/Failed, and prints each replica's log: the
pods the job's ``cleanPodPolicy`` keeps running past its end (``None``)
are waited for within the same timeout, so their logs are whole. JSON
always loads; YAML needs ``pyyaml``. Pods run in a fresh directory under
the checkout's ``build/``, or from an install under the per-user cache
(``_paths.py``), never in the package's own directory; ``--workdir``
names another. The port's job catalogue is ``examples/`` beside this
module (``tf_operator_tpu_torch/examples/README.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

from tf_operator_tpu_torch import _paths
from tf_operator_tpu_torch.api.types import JobConditionType, PodPhase, TPUJob
from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.sdk.client import TPUJobClient


def load_job(path: str) -> TPUJob:
    """A TPUJob from a ``.json`` file, or from YAML through ``pyyaml``."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return TPUJob.from_dict(json.loads(text))
    try:
        import yaml
    except ImportError:
        raise SystemExit(f"{path}: reading YAML needs pyyaml, which is not "
                         "installed; give the job as .json") from None
    return TPUJob.from_dict(yaml.safe_load(text))


def wait_for_pods(client: TPUJobClient, name: str, deadline: float) -> None:
    """Wait until every pod the job still has has exited, or until
    ``deadline`` (``time.monotonic()``)."""
    done = (PodPhase.SUCCEEDED, PodPhase.FAILED)
    while time.monotonic() < deadline and not all(
            p.status.phase in done for p in client.get_pods(name)):
        time.sleep(0.1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("spec", help="TPUJob JSON or YAML file")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--workdir", default=None,
                    help="directory the pods run in (default: a fresh one "
                         "under build/ or the per-user cache)")
    args = ap.parse_args(argv)

    job = load_job(args.spec)
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        workdir = os.path.abspath(args.workdir)
    else:
        workdir = _paths.fresh_dir("run-local-")
    # Pods import the port this process imported, from the checkout or
    # the install, whatever their working directory.
    pythonpath = os.pathsep.join(p for p in (
        workdir, str(_paths.PACKAGE.parent), os.environ.get("PYTHONPATH"))
        if p)
    op = Operator.local(workdir=workdir,
                        extra_env={"PYTHONPATH": pythonpath})
    print(f"pods run in {workdir}")
    op.start(threadiness=2)
    client = TPUJobClient(op.store)
    deadline = time.monotonic() + args.timeout
    try:
        client.create(job)
        name = job.metadata.name
        print(f"submitted TPUJob {name}; waiting (timeout {args.timeout}s)")
        try:
            done = client.wait_for_job(name, timeout=args.timeout)
            state = "Succeeded" if any(
                c.type == JobConditionType.SUCCEEDED and c.status == "True"
                for c in done.status.conditions) else "Failed"
        except TimeoutError:
            # Still print the diagnostics the script exists to show.
            done = client.get(name)
            state = "TimedOut"
        wait_for_pods(client, name, deadline)
        print(f"TPUJob {name}: {state}")
        for cond in done.status.conditions:
            print(f"  condition {cond.type}={cond.status} ({cond.reason})")
        for pod_name in client.get_pod_names(name):
            print(f"--- logs {pod_name} ---")
            print(client.get_logs(pod_name) or "(no output)")
        return 0 if state == "Succeeded" else 1
    finally:
        op.stop()


if __name__ == "__main__":
    sys.exit(main())
