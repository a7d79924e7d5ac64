"""Cluster-spec construction and worker env rendering (port of
tf_operator_tpu/bootstrap/cluster.py with the GPU bootstrap contract).

This is the heart of distributed bootstrap — the replacement for the
reference's TF_CONFIG machinery
(pkg/controller.v1/tensorflow/tensorflow.go:97-173, pod.go:259-317):

- replica DNS naming keeps the reference contract
  ``{job}-{rtype}-{index}.{ns}.svc[.{domain}]`` (tensorflow.go:154-166).
- instead of TF_CONFIG the default container receives:
  * ``TPUJOB_CLUSTER_SPEC`` — full cluster JSON (same shape as TF_CONFIG:
    cluster/task/environment), byte-equal to the JAX package's;
  * ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``LOCAL_WORLD_SIZE`` and ``RANK`` / ``LOCAL_RANK`` (a one-process
    pod) or ``GROUP_RANK`` / ``GROUP_WORLD_SIZE`` (a pod of several) —
    torchrun's names: one process a GPU, the rendezvous the chief (or
    worker-0) at a dedicated port;
  * ``TPUJOB_ACCELERATOR_TYPE`` / ``TPUJOB_TOPOLOGY`` — slice shape for
    mesh construction.
- elastic mode renders a sparse cluster view (reference SparseClusterSpec,
  tensorflow.go:64-83): the worker sees itself plus parameter servers, so
  membership can change without restarting the world.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    ReplicaType,
    TPUJob,
    effective_role_policy,
    gen_general_name,
)
from tf_operator_tpu_torch.bootstrap.topology import parse_accelerator

# Replica-type ordering inside cluster specs and rank assignment: the
# coordinator-capable types come first so process 0 is always chief-like.
_RANKED_TYPES = (ReplicaType.CHIEF, ReplicaType.MASTER, ReplicaType.WORKER)


@dataclasses.dataclass
class ClusterSpec:
    """Full cluster view for one task (TF_CONFIG-shaped parity artifact)."""

    cluster: Dict[str, List[str]]
    task_type: str
    task_index: int
    environment: str = "cloud"

    def to_json(self) -> str:
        return json.dumps({
            "cluster": self.cluster,
            "task": {"type": self.task_type, "index": self.task_index},
            "environment": self.environment,
        }, sort_keys=True)


def replica_dns_name(job: TPUJob, rtype: str, index: int,
                     domain: str = "") -> str:
    """Reference naming contract (tensorflow.go:154-166)."""
    name = gen_general_name(job.metadata.name, rtype, index)
    host = f"{name}.{job.metadata.namespace}.svc"
    if domain:
        host = f"{host}.{domain}"
    return host


def replica_port(job: TPUJob, rtype: str) -> int:
    """Rendezvous port from the default container's named port (reference
    GetPortFromTFJob, tensorflow/util.go:28-43)."""
    spec = job.spec.replica_specs.get(rtype)
    if spec is not None:
        container = spec.template.spec.container(constants.DEFAULT_CONTAINER_NAME)
        if container is not None:
            port = container.ports.get(constants.DEFAULT_PORT_NAME)
            if port:
                return port
    return constants.DEFAULT_PORT


def is_distributed(job: TPUJob) -> bool:
    """More than one process in the cluster (reference isDistributed,
    pod.go:296-317)."""
    total = sum(s.replicas or 0 for s in job.spec.replica_specs.values())
    return total > 1


def _cluster_domain() -> str:
    return os.environ.get(constants.ENV_CUSTOM_CLUSTER_DOMAIN, "")


def build_cluster_spec(job: TPUJob, rtype: str, index: int,
                       domain: Optional[str] = None) -> ClusterSpec:
    """Build the cluster view task (rtype, index) should see.

    Dense mode lists every replica of every type (reference
    genClusterSpec, tensorflow.go:142-173). Elastic mode is sparse: the
    worker sees only itself plus all PS replicas (reference
    SparseClusterSpec, tensorflow.go:64-83); non-worker types see the
    dense view.
    """
    if domain is None:
        domain = _cluster_domain()
    rt = rtype.lower()
    sparse = (job.spec.enable_elastic_worker and rt == ReplicaType.WORKER)

    cluster: Dict[str, List[str]] = {}
    for repl_type, spec in sorted(job.spec.replica_specs.items()):
        port = replica_port(job, repl_type)
        n = spec.replicas or 0
        if sparse and repl_type not in (ReplicaType.PS, rt):
            continue
        if sparse and repl_type == rt:
            # Sparse: only this worker's own entry, keyed by its index.
            cluster[repl_type] = [
                f"{replica_dns_name(job, repl_type, index, domain)}:{port}"]
        else:
            entries = [
                f"{replica_dns_name(job, repl_type, i, domain)}:{port}"
                for i in range(n)]
            if repl_type == rt and index >= n:
                # Transient out-of-range render (elastic grow before
                # the spec settles): the view must contain THIS task —
                # it exists by construction — and nothing between n and
                # index, which does not exist yet.
                entries.append(
                    f"{replica_dns_name(job, repl_type, index, domain)}"
                    f":{port}")
            cluster[repl_type] = entries
    return ClusterSpec(cluster=cluster, task_type=rt, task_index=index)


def pod_gpus(job: TPUJob, rtype: str) -> int:
    """GPUs each ``rtype`` pod holds: the template's explicit
    ``nvidia.com/gpu`` request (summed over its containers), else the
    slice topology's GPUs a host on a GPU-holding role (what
    ``GPUJobController.set_cluster_spec`` stamps), else 0."""
    spec = job.spec.replica_specs.get(rtype.lower())
    containers = spec.template.spec.containers if spec is not None else []
    declared = [c.resources[constants.RESOURCE_GPU] for c in containers
                if constants.RESOURCE_GPU in c.resources]
    if declared:
        total = 0
        for raw in declared:
            try:
                total += int(float(raw or "0"))
            except ValueError:
                pass
        return total
    sl = job.spec.slice
    if sl.accelerator and effective_role_policy(job, rtype).chip_consuming:
        return parse_accelerator(sl.accelerator, sl.topology,
                                 max(1, sl.num_slices)).devices_per_host
    return 0


def process_ranks(job: TPUJob) -> Dict[str, List[int]]:
    """Each data-plane pod's place among the ranked pods (chief/master
    first, then workers): its ``GROUP_RANK``, and its ``RANK`` where it
    runs one process. PS/evaluator replicas are not ranked processes;
    they keep cluster-spec entries only."""
    ranks: Dict[str, List[int]] = {}
    next_rank = 0
    for rtype in _RANKED_TYPES:
        spec = job.spec.replica_specs.get(rtype)
        if spec is None:
            continue
        n = spec.replicas or 0
        ranks[rtype] = list(range(next_rank, next_rank + n))
        next_rank += n
    return ranks


def coordinator_address(job: TPUJob, domain: Optional[str] = None) -> str:
    """Process-0's address for the torch.distributed rendezvous: the
    chief/master when present, else worker-0, on the coordinator port."""
    if domain is None:
        domain = _cluster_domain()
    for rtype in _RANKED_TYPES:
        if rtype in job.spec.replica_specs:
            host = replica_dns_name(job, rtype, 0, domain)
            return f"{host}:{constants.DEFAULT_COORDINATOR_PORT}"
    raise ValueError(f"job {job.key()} has no coordinator-capable replica type")


def learner_endpoints(job: TPUJob, domain: Optional[str] = None) -> str:
    """Comma-joined 'dns:port' endpoints of the job's learner (ranked)
    replicas — what an RL actor dials to stream experience and fetch
    parameters (docs/rl.md). The ps/evaluator treatment in reverse:
    actors discover learners through env OUTSIDE every bootstrap hash,
    so neither side restarts when the other churns. Rendered from the
    current spec at pod-create time; like the sparse-elastic ps view it
    may go stale across a learner resize (actors re-resolve by DNS or
    get the fresh list on their next recreate)."""
    if domain is None:
        domain = _cluster_domain()
    endpoints: List[str] = []
    for rtype in _RANKED_TYPES:
        spec = job.spec.replica_specs.get(rtype)
        if spec is None:
            continue
        port = replica_port(job, rtype)
        for i in range(spec.replicas or 0):
            endpoints.append(
                f"{replica_dns_name(job, rtype, i, domain)}:{port}")
    return ",".join(endpoints)


def render_worker_env(job: TPUJob, rtype: str, index: int,
                      domain: Optional[str] = None) -> Dict[str, str]:
    """Env the engine injects into the default container at pod-create time
    (the SetClusterSpec plugin hook): the GPU contract.

    ``TPUJOB_ACCELERATOR_TYPE`` / ``TPUJOB_TOPOLOGY`` where the job declares
    a slice; for a job of one pod that holds g > 1 GPUs,
    ``LOCAL_WORLD_SIZE`` = g (its g processes are one world, as the JAX
    process drives every chip of its host); for a distributed job also
    ``TPUJOB_CLUSTER_SPEC`` (byte-equal to the JAX package's) and, on
    ranked pods, torchrun's env with one process a GPU: ``MASTER_ADDR`` /
    ``MASTER_PORT`` (process 0, from ``coordinator_address``),
    ``WORLD_SIZE`` (the processes of every ranked pod) and
    ``LOCAL_WORLD_SIZE`` (this pod's: its ``pod_gpus``, at least one). A
    pod of one process also gets ``RANK`` and ``LOCAL_RANK`` = 0; a pod
    of several gets ``GROUP_RANK`` (its place among the ranked pods) and
    ``GROUP_WORLD_SIZE`` (their count), from which the payload's local
    launch (``parallel.distributed.launch_local_processes``), where
    ``TPUJOB_JAX_DISTRIBUTED=1`` turns the job-wide world on, gives each
    of its processes ``RANK`` = ``WORLD_SIZE`` - (``GROUP_WORLD_SIZE`` -
    ``GROUP_RANK``) x ``LOCAL_WORLD_SIZE`` + ``LOCAL_RANK``:
    ``GROUP_RANK`` x ``LOCAL_WORLD_SIZE`` + ``LOCAL_RANK`` when every
    ranked pod runs as many, and right too behind a one-process chief, as
    the ranked pods after a pod hold as many GPUs as it does (one
    template a replica type, the types in rank order); without it the
    pod's processes are a world of their own. No libtpu or DCN
    keys: the hosts are in the cluster spec, and a job of several slices
    is one world."""
    if domain is None:
        domain = _cluster_domain()
    rt = rtype.lower()
    env: Dict[str, str] = {}

    sl = job.spec.slice
    if sl.accelerator:
        topo = parse_accelerator(sl.accelerator, sl.topology, sl.num_slices)
        env["TPUJOB_ACCELERATOR_TYPE"] = topo.accelerator
        env["TPUJOB_TOPOLOGY"] = topo.topology_str

    if not is_distributed(job):
        own = pod_gpus(job, rt)
        if own > 1:
            env["LOCAL_WORLD_SIZE"] = str(own)
        return env

    env["TPUJOB_CLUSTER_SPEC"] = build_cluster_spec(job, rt, index, domain).to_json()

    ranks = process_ranks(job)
    num_pods = sum(len(v) for v in ranks.values())
    if rt in ranks and num_pods > 0:
        if index < len(ranks[rt]):
            group_rank = ranks[rt][index]
        else:
            # Transient out-of-range render (elastic scale-up before the
            # spec settles): offset by the type's base rank and widen the
            # pod count so the id is unique and in range.
            base = ranks[rt][0] if ranks[rt] else num_pods
            group_rank = base + index
        # Processes a pod, by place: one a GPU it holds, one for a pod
        # that holds none; a place past the ranked pods (a transient
        # render) runs as many as this pod.
        own = max(1, pod_gpus(job, rt))
        sizes = [0] * num_pods
        for t, places in ranks.items():
            for place in places:
                sizes[place] = max(1, pod_gpus(job, t))
        sizes += [own] * max(0, group_rank + 1 - num_pods)
        first = sum(sizes[:group_rank])
        host, _, port = coordinator_address(job, domain).rpartition(":")
        env["MASTER_ADDR"] = host
        env["MASTER_PORT"] = port
        env["WORLD_SIZE"] = str(max(sum(sizes[:num_pods]), first + own))
        if own == 1:
            env["RANK"] = str(first)
            env["LOCAL_RANK"] = "0"
        else:
            env["GROUP_RANK"] = str(group_rank)
            env["GROUP_WORLD_SIZE"] = str(max(num_pods, group_rank + 1))
        env["LOCAL_WORLD_SIZE"] = str(own)

    return env
