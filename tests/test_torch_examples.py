"""The port's job catalogue (``tf_operator_tpu_torch/examples/``) against
the JAX package's (``examples/``).

Static cases (``control_plane``): every JAX file ``examples/*/*.yaml`` has
a port file of the same directory and name, which is the JAX file under
the mapping below and nothing else, before and after defaulting; the
queue config loads through both packages to the same queues; the PS
NetworkPolicy selects the pods the port's engine makes.

Runs (``e2e``), on the CPU as the files stand (the files that pin the
CPU carry ``--device cpu``, as their JAX files carry ``JAX_PLATFORMS:
cpu``; a pod that holds no GPU runs on the host by the operator's device
key, as the ps file's pods do). The payload files go through ``python -m
tf_operator_tpu_torch.run_local`` as subprocesses and must reach
Succeeded with each pod's log ending in its payload's success line, and
the pods of roles that hold no GPU logging the host; the test host
stands for one host of 8 GPUs (``CUDA_VISIBLE_DEVICES`` names 8 cards for
run_local's card inventory), so the pods of an ``h100-32`` job, 8 GPUs
and 8 processes each, one world a pod, take the host in turn. The files whose
header names operator flags run under an operator of each package built
from exactly those flags, as ``cli.py`` builds it, and must give the
same conditions, replica set and observed state. Every ``/tmp`` path a
file names is moved under ``tmp_path``; all runs go at once.
"""

import copy
import glob
import json
import os
import re
import shlex
import subprocess
import sys
import threading
import time

import pytest
import yaml

from tf_operator_tpu import api as japi
from tf_operator_tpu import cli as jcli
from tf_operator_tpu import operator as jop
from tf_operator_tpu.api.validation import validation_warnings as j_warnings
from tf_operator_tpu.controller import quota as jquota
from tf_operator_tpu.runtime import store as jstore
from tf_operator_tpu.sdk.client import TPUJobClient as JClient
from tf_operator_tpu_torch import api as tapi
from tf_operator_tpu_torch import cli as tcli
from tf_operator_tpu_torch import operator as top
from tf_operator_tpu_torch.api import constants as tconst
from tf_operator_tpu_torch.api.validation import (
    validation_warnings as t_warnings,
)
from tf_operator_tpu_torch.controller import quota as tquota
from tf_operator_tpu_torch.runtime import store as tstore
from tf_operator_tpu_torch.sdk.client import TPUJobClient as TClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "examples")
PORT_DIR = os.path.join(REPO, "tf_operator_tpu_torch", "examples")


def catalogue(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "*", "*.yaml")))


FILES = catalogue(JAX_DIR)
JOBS = [f for f in FILES if os.path.basename(f).startswith("tpujob_")]

# The mapping from a JAX file to its port file; anything else must be
# equal. Accelerators keep their host count (8 GPUs a host).
ACCELERATORS = {"v5e-8": "h100-8", "v5e-16": "h100-16", "v5p-32": "h100-32"}
# The head of a JAX command -> the head of the port's.
COMMANDS = {
    ("python", "examples/smoke/tpu_smoke.py"):
        ("python", "-m", "tf_operator_tpu_torch.train.gpu_smoke"),
    ("python", "examples/dist_mnist/dist_mnist.py"):
        ("python", "-m", "tf_operator_tpu_torch.train.dist_mnist"),
    ("python", "examples/dist_mnist/dist_mnist_ps.py"):
        ("python", "-m", "tf_operator_tpu_torch.train.dist_mnist_ps"),
    ("python", "-m", "tf_operator_tpu.train.ps"):
        ("python", "-m", "tf_operator_tpu_torch.train.ps"),
    ("python", "examples/llama_spmd/train_llama.py"):
        ("python", "-m", "tf_operator_tpu_torch.train.train_llama"),
    ("python", "examples/resnet_dp/train_resnet.py"):
        ("python", "-m", "tf_operator_tpu_torch.train.train_resnet"),
    ("python", "examples/bert_gang/train_bert.py"):
        ("python", "-m", "tf_operator_tpu_torch.train.train_bert"),
    ("python", "examples/mixtral_moe/train_mixtral.py"):
        ("python", "-m", "tf_operator_tpu_torch.train.train_mixtral"),
    ("python", "-m", "tf_operator_tpu.runtime.worker_stub"):
        ("python", "-m", "tf_operator_tpu_torch.runtime.worker_stub"),
    ("python", "-m", "tf_operator_tpu.serve.worker"):
        ("python", "-m", "tf_operator_tpu_torch.serve.worker"),
}
# The JAX files' CPU pin and the port's.
JAX_CPU_PIN = ("JAX_PLATFORMS", "cpu")
PORT_CPU_PIN = ["--device", "cpu"]


def load(root, rel):
    with open(os.path.join(root, rel)) as f:
        return yaml.safe_load(f)


def containers(raw):
    for spec in raw["spec"]["replicaSpecs"].values():
        yield from spec["template"]["spec"]["containers"]


def port_of(jax_raw):
    """The port file that ``jax_raw`` maps to."""
    raw = copy.deepcopy(jax_raw)
    if raw.get("kind") != "TPUJob":
        return raw
    sl = raw["spec"].get("slice")
    if sl and sl.get("accelerator"):
        sl["accelerator"] = ACCELERATORS[sl["accelerator"]]
    for c in containers(raw):
        (head,) = [h for h in COMMANDS if tuple(c["command"][:len(h)]) == h]
        c["command"] = [*COMMANDS[head], *c["command"][len(head):]]
        env = c.get("env", {})
        if env.get(JAX_CPU_PIN[0]) == JAX_CPU_PIN[1]:
            del env[JAX_CPU_PIN[0]]
            c["command"] += PORT_CPU_PIN
            if not env:
                del c["env"]
    return raw


def differences(want, got, path=""):
    """Field paths where ``got`` differs from ``want``."""
    if isinstance(want, dict) and isinstance(got, dict):
        return [d for k in sorted(set(want) | set(got), key=str)
                for d in differences(want.get(k, "<absent>"),
                                     got.get(k, "<absent>"), f"{path}.{k}")]
    if want != got:
        return [f"{path}: {want!r} -> {got!r}"]
    return []


def mapped_job_dict(jjob):
    """A JAX job's wire dict under the mapping (what ``port_of`` does to
    the file, done to the parsed and defaulted job)."""
    return port_of({"kind": "TPUJob", **jjob.to_dict()})


@pytest.mark.control_plane
def test_every_jax_file_has_a_port_file():
    assert len(FILES) == 14
    assert catalogue(PORT_DIR) == FILES


@pytest.mark.control_plane
@pytest.mark.parametrize("rel", FILES)
def test_port_file_is_the_jax_file_under_the_mapping(rel):
    jraw, traw = load(JAX_DIR, rel), load(PORT_DIR, rel)
    assert differences(port_of(jraw), traw) == []
    if rel not in JOBS:
        return
    jjob = japi.TPUJob.from_dict(copy.deepcopy(jraw))
    tjob = tapi.TPUJob.from_dict(copy.deepcopy(traw))
    assert differences(mapped_job_dict(jjob), tjob.to_dict()) == []
    japi.set_defaults(jjob)
    tapi.set_defaults(tjob)
    assert differences(mapped_job_dict(jjob), tjob.to_dict()) == []
    tapi.validate_job(tjob)
    assert t_warnings(tjob) == j_warnings(jjob)


@pytest.mark.control_plane
def test_queue_config_loads_to_the_same_queues():
    loaded = []
    for module, root in ((jquota, JAX_DIR), (tquota, PORT_DIR)):
        cqs, tqs = module.load_queue_config(
            os.path.join(root, "quota", "queues.yaml"))
        loaded.append(([(q.metadata.name, q.spec.to_dict()) for q in cqs],
                       [(q.metadata.namespace, q.metadata.name,
                         q.spec.to_dict()) for q in tqs]))
    assert loaded[1] == loaded[0]
    assert [spec["nominalChips"] for _, spec in loaded[1][0]] == [16, 16]


@pytest.mark.control_plane
def test_ps_network_policy_selects_the_port_engines_pods():
    """The policy's target is the job's ps pods alone, and its peers
    are every pod of the job, by the labels the port's engine stamps."""
    policy = load(PORT_DIR, "dist_mnist/ps_networkpolicy.yaml")
    raw = load(PORT_DIR, "dist_mnist/tpujob_dist_mnist_ps.yaml")
    op = top.Operator(backend=None)
    op.start(threadiness=1)
    try:
        client = TClient(op.store)
        client.create(tapi.TPUJob.from_dict(raw))
        deadline = time.monotonic() + 20
        while len(client.get_pods("dist-mnist-ps")) < 4:
            assert time.monotonic() < deadline, "pods never created"
            time.sleep(0.02)
        labels = {p.metadata.name: p.metadata.labels
                  for p in client.get_pods("dist-mnist-ps")}
    finally:
        op.stop()

    def selects(selector):
        return sorted(n for n, lab in labels.items()
                      if all(lab.get(k) == v
                             for k, v in selector["matchLabels"].items()))

    assert {k for lab in labels.values() for k in lab} >= {
        tconst.LABEL_JOB_NAME, tconst.LABEL_REPLICA_TYPE}
    assert selects(policy["spec"]["podSelector"]) == [
        "dist-mnist-ps-ps-0", "dist-mnist-ps-ps-1"]
    (peer,) = policy["spec"]["ingress"][0]["from"]
    assert selects(peer["podSelector"]) == sorted(labels)


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------

# Payload files: the success line each pod's log ends in, and which of
# the runs' CPUs (RUN_CPUS) its run keeps to: the three runs of 8
# processes a pod (one world a pod, about a minute each on one CPU) get
# one each, the light runs shared out beside them.
PAYLOADS = {
    "smoke/tpujob_smoke.yaml": (r"smoke OK on \d+ device\(s\)", 0),
    "dist_mnist/tpujob_dist_mnist.yaml": (r"done: loss \S+ -> \S+", 0),
    "dist_mnist/tpujob_dist_mnist_ps.yaml": (r"done: first=\S+ last=\S+", 2),
    "llama_spmd/tpujob_llama.yaml": (r"llama training OK", 2),
    "resnet_dp/tpujob_resnet.yaml": (r"resnet training OK", 1),
    "bert_gang/tpujob_bert.yaml": (r"bert training OK", 0),
    "mixtral_moe/tpujob_mixtral.yaml": (r"mixtral training OK", 1),
}
# The roles that hold no GPU (as in JAX): their pods run on the host.
NO_GPU_ROLES = ("chief", "ps")
# The files that name operator flags in their header.
FLAGGED = ("checkpoint/tpujob_checkpoint.yaml", "elastic/tpujob_elastic.yaml",
           "quota/tpujob_quota.yaml", "rl/tpujob_rl.yaml",
           "serving/tpujob_serving.yaml")
# Requests the serving file's replicas answer before the spool closes.
SERVING_REQUESTS = 4
HOST_CARDS = ",".join(str(i) for i in range(8))
RUN_TIMEOUT_S = 240.0
# The runs keep to 4 of the host's CPUs, one process a CPU at a time
# (torch sizes its thread pool to the CPUs a process may use), so the
# rest of a parallel test session keeps the others: 3 for the payload
# runs (PAYLOADS), the last for the flagged runs' operators and pods.
RUN_CPUS = 4


@pytest.mark.control_plane
def test_the_runs_cover_the_catalogue():
    """Every job file runs, one way or the other; the flagged ones are
    those whose header names flags, in both packages alike."""
    assert not set(PAYLOADS) & set(FLAGGED)
    assert sorted([*PAYLOADS, *FLAGGED]) == JOBS
    for rel in JOBS:
        named = []
        for root in (JAX_DIR, PORT_DIR):
            with open(os.path.join(root, rel)) as f:
                if "python -m tf_operator_tpu" in f.read():
                    named.append(root)
        assert len(named) in (0, 2), rel
        assert (rel in FLAGGED) == bool(named), rel
        if named:
            (jpkg, jflags), (tpkg, tflags) = (
                header_flags(root, rel) for root in named)
            assert (jpkg, tpkg) == ("tf_operator_tpu", "tf_operator_tpu_torch")
            assert [os.path.basename(f) for f in tflags] == [
                os.path.basename(f) for f in jflags]


def header_flags(root, rel):
    """The package and operator flags of the ``python -m <package> ...``
    command in a file's header (its lines joined where they end in a
    backslash), bracketed optional flags left out, paths made absolute
    from the repo root."""
    with open(os.path.join(root, rel)) as f:
        header = [line[1:].strip() for line in f
                  if line.startswith("#")]
    (start,) = [i for i, line in enumerate(header)
                if line.startswith("python -m ")]
    command = header[start]
    while command.endswith("\\"):
        start += 1
        command = command[:-1] + " " + header[start]
    words = shlex.split(re.sub(r"\[[^]]*\]", " ", command))
    return words[2], [os.path.join(REPO, w) if w.endswith(".yaml") else w
                      for w in words[3:]]


def operator_kwargs(cli, flags):
    """The ``Operator`` keywords that ``cli.Server`` gives a local
    backend for ``flags``."""
    args = cli.build_parser().parse_args(flags)
    return dict(
        enable_gang_scheduling=args.enable_gang_scheduling,
        total_chips=args.total_chips,
        enable_slice_health=args.slice_health and args.enable_gang_scheduling,
        enable_tenant_queues=args.enable_tenant_queues,
        queue_config=args.queue_config,
        enable_ckpt_coordination=args.enable_ckpt_coordination,
        enable_serving=args.enable_serving,
        enable_elastic=args.enable_elastic)


def moved_off_tmp(raw, root):
    """The file with each ``/tmp`` directory it names moved under
    ``root``."""
    raw = copy.deepcopy(raw)
    policy = raw["spec"].get("runPolicy", {})
    for field, key in (("checkpointPolicy", "directory"),
                       ("servingPolicy", "spoolDirectory")):
        path = policy.get(field, {}).get(key)
        if path:
            assert path.startswith("/tmp/")
            policy[field][key] = os.path.join(root, os.path.basename(path))
    return raw


SIDES = {
    "jax": (JAX_DIR, jop, japi, jcli, JClient, jstore),
    "port": (PORT_DIR, top, tapi, tcli, TClient, tstore),
}


def run_flagged(side, rel, tmp):
    """Run ``rel`` under an operator of ``side`` built from its header's
    flags. Returns what the run showed."""
    root, opmod, api, cli, Client, store_mod = SIDES[side]
    package, flags = header_flags(root, rel)
    assert package == {"jax": "tf_operator_tpu",
                       "port": "tf_operator_tpu_torch"}[side]
    work = os.path.join(tmp, side, os.path.dirname(rel))
    os.makedirs(work)
    raw = moved_off_tmp(load(root, rel), work)
    op = opmod.Operator.local(workdir=work,
                              extra_env={"PYTHONPATH": work + os.pathsep
                                         + REPO},
                              **operator_kwargs(cli, flags))
    pods, phases = set(), []

    def on_pod(event, pod):
        if event == store_mod.ADDED:
            lab = pod.metadata.labels
            pods.add((pod.metadata.name, lab.get("replica-type"),
                      lab.get("replica-index")))

    def on_group(_event, group):
        phase = group.status.phase
        if phase and (not phases or phases[-1] != phase):
            phases.append(phase)

    watches = [op.store.watch(store_mod.PODS, on_pod),
               op.store.watch(store_mod.SLICEGROUPS, on_group)]
    op.start(threadiness=2)
    try:
        client = Client(op.store)
        client.create(api.TPUJob.from_dict(raw))
        name = raw["metadata"]["name"]
        answered = None
        if "servingPolicy" in raw["spec"]["runPolicy"]:
            answered = serve_and_close(client, name, raw)
        job = client.wait_for_job(name, timeout=RUN_TIMEOUT_S)
    finally:
        op.stop()
        for w in watches:
            w.stop()
    return {
        "conditions": [(c.type, c.status, c.reason)
                       for c in job.status.conditions],
        "pods": sorted(pods),
        "group_phases": phases,
        "num_slices": job.spec.slice.num_slices,
        "replicas": {k: v.replicas for k, v in
                     job.spec.replica_specs.items()},
        "answered": answered,
    }


def serve_and_close(client, name, raw):
    """Once both serving replicas run, drop requests into the spool,
    wait for every response, then close the spool (the worker's exit)."""
    spool = raw["spec"]["runPolicy"]["servingPolicy"]["spoolDirectory"]
    want = raw["spec"]["replicaSpecs"]["serving"]["replicas"]
    deadline = time.monotonic() + RUN_TIMEOUT_S
    while sum(p.status.phase == "Running"
              for p in client.get_pods(name)) < want:
        assert time.monotonic() < deadline, "serving replicas never ran"
        time.sleep(0.05)
    os.makedirs(os.path.join(spool, "pending"), exist_ok=True)
    for i in range(SERVING_REQUESTS):
        path = os.path.join(spool, "pending", f"req{i}.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"id": f"req{i}", "tenant": "team-a",
                       "prompt": [i + 1, i + 2, i + 3], "maxNewTokens": 4},
                      f)
        os.replace(path + ".tmp", path)
    done = os.path.join(spool, "done")
    while len([n for n in os.listdir(done) if n.endswith(".json")]
              if os.path.isdir(done) else []) < SERVING_REQUESTS:
        assert time.monotonic() < deadline, "requests never answered"
        time.sleep(0.05)
    open(os.path.join(spool, ".close"), "w").close()
    return sorted(n for n in os.listdir(done) if n.endswith(".json"))


def start_run_local(rel, tmp, cores):
    """run_local on ``rel``, its pods kept to the CPUs ``cores``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=HOST_CARDS,
               PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.run_local",
         os.path.join(PORT_DIR, rel), "--timeout", str(RUN_TIMEOUT_S),
         "--workdir", os.path.join(tmp, "pods", os.path.dirname(rel))],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, preexec_fn=lambda: os.sched_setaffinity(0, cores))


def pod_logs(stdout):
    """Pod name -> its log, from run_local's output."""
    logs, name = {}, None
    for line in stdout.splitlines():
        m = re.fullmatch(r"--- logs (\S+) ---", line)
        if m:
            name = m[1]
            logs[name] = []
        elif name is not None:
            logs[name].append(line)
    return {n: [line for line in lines if line.strip()]
            for n, lines in logs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run at once: the payload files through run_local, each
    flagged file through both packages' operators."""
    tmp = str(tmp_path_factory.mktemp("catalogue"))
    started = time.monotonic()
    own = os.sched_getaffinity(0)
    cpus = sorted(own)[-RUN_CPUS:]
    slots = [{cpus[i % len(cpus)]} for i in range(RUN_CPUS)]
    procs = {rel: start_run_local(rel, tmp, slots[slot])
             for rel, (_, slot) in PAYLOADS.items()}
    flagged, errors = {}, {}

    def one(side, rel):
        try:
            flagged[side, rel] = run_flagged(side, rel, tmp)
        except Exception as e:  # reported by the case that reads it
            errors[side, rel] = e

    # The operators' threads and their pods inherit the CPU this thread
    # keeps to while it starts them.
    os.sched_setaffinity(0, slots[-1])
    try:
        threads = [threading.Thread(target=one, args=(side, rel))
                   for rel in FLAGGED for side in SIDES]
        for t in threads:
            t.start()
    finally:
        os.sched_setaffinity(0, own)
    payloads = {}
    for rel, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=RUN_TIMEOUT_S + 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        payloads[rel] = (proc.returncode, out)
    for t in threads:
        t.join()
    print(f"catalogue runs: {time.monotonic() - started:.1f} s")
    yield {"payloads": payloads, "flagged": flagged, "errors": errors}


@pytest.mark.e2e
@pytest.mark.parametrize("rel", sorted(PAYLOADS))
def test_payload_file_succeeds_through_run_local(runs, rel):
    rc, out = runs["payloads"][rel]
    name = load(PORT_DIR, rel)["metadata"]["name"]
    assert rc == 0 and f"TPUJob {name}: Succeeded" in out, out[-4000:]
    logs = pod_logs(out)
    assert logs, out[-4000:]
    for pod, lines in logs.items():
        assert lines and re.fullmatch(PAYLOADS[rel][0], lines[-1]), (
            pod, lines[-20:])
        if pod.split("-")[-2] in NO_GPU_ROLES:
            assert "device: cpu (TPUJOB_DEVICE=cpu)" in lines, (
                pod, lines[-20:])


@pytest.mark.e2e
@pytest.mark.parametrize("rel", FLAGGED)
def test_flagged_file_runs_as_its_jax_file(runs, rel):
    for side in SIDES:
        if (side, rel) in runs["errors"]:
            raise runs["errors"][side, rel]
    jax, port = runs["flagged"]["jax", rel], runs["flagged"]["port", rel]
    assert port == jax
    assert port["conditions"][-1][:2] == ("Succeeded", "True"), port
    assert port["pods"], port
