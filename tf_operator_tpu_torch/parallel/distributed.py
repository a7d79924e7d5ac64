"""Multi-process bring-up from the operator's env (port of the payloads'
``maybe_init_distributed``, examples/dist_mnist/dist_mnist.py).

The port's operator renders the torch.distributed env: ``MASTER_ADDR`` /
``MASTER_PORT`` (process 0), ``WORLD_SIZE`` and ``RANK``. Under the JAX
package's operator the same facts come as ``JAX_COORDINATOR_ADDRESS``
(host:port), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``
(``TPU_WORKER_ID`` where the id is missing); each is read only where its
torch key is absent, so a payload runs under either operator. A process
joins the job-wide run only where the JAX payload joins one:
``TPUJOB_JAX_DISTRIBUTED=1``, more than one process, and a coordinator
address. Without the flag, the processes of a pod that holds several
GPUs (one a GPU, ``launch_local_processes``) join a world of their own,
as the JAX process of such a pod builds its mesh over its host's chips:
``RANK`` = ``LOCAL_RANK``, ``WORLD_SIZE`` = ``LOCAL_WORLD_SIZE``, the
store at 127.0.0.1 on a port the launch picks. Either way a process
joins ``torch.distributed`` through a
``TCPStore`` at the coordinator's host:port, served by process 0: NCCL
when the process drives the card, gloo when the caller asked for the
CPU. That follows the port's device rule (``_device.py``): a missing card
never turns into a gloo run, and a failed NCCL init raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.api.constants import ENV_CKPT_FILE

# The flag that turns the job-wide world on, the JAX payloads' own.
ENV_JOB_WORLD = "TPUJOB_JAX_DISTRIBUTED"
# Copy of tf_operator_tpu/api/constants.py DEFAULT_COORDINATOR_PORT: the
# port a coordinator address without one means.
DEFAULT_COORDINATOR_PORT = 8476
# How long a process waits for the others to reach the store.
JOIN_TIMEOUT_S = 300.0
# How long a pod's local processes get between SIGTERM and SIGKILL when
# one of them failed (the local backend's own grace, runtime/local.py).
LOCAL_GRACE_S = 3.0


@dataclasses.dataclass(frozen=True)
class ProcessEnv:
    """What the operator's env says about this process."""

    num_processes: int = 1
    process_id: int = 0
    coordinator: str = ""
    distributed: bool = False      # TPUJOB_JAX_DISTRIBUTED=1
    pod_world: bool = False        # one of a pod's own world's processes

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "ProcessEnv":
        env = os.environ if environ is None else environ
        coordinator = env.get("JAX_COORDINATOR_ADDRESS", "")
        if env.get("MASTER_ADDR"):
            coordinator = env["MASTER_ADDR"]
            if env.get("MASTER_PORT"):
                coordinator += f":{env['MASTER_PORT']}"
        return cls(
            num_processes=int(env.get("WORLD_SIZE")
                              or env.get("JAX_NUM_PROCESSES") or 1),
            process_id=int(env.get("RANK") or env.get("JAX_PROCESS_ID")
                           or env.get("TPU_WORKER_ID") or 0),
            coordinator=coordinator,
            distributed=env.get(ENV_JOB_WORLD) == "1",
            # What launch_local_processes gives a pod's own world (and
            # torchrun a one-node run): every process is local.
            pod_world=(env.get("LOCAL_RANK") is not None
                       and int(env.get("LOCAL_WORLD_SIZE") or 1) > 1
                       and env.get("WORLD_SIZE")
                       == env.get("LOCAL_WORLD_SIZE")))

    @property
    def joins(self) -> bool:
        """Whether this process joins a multi-process run: the JAX
        payload's three conditions, or one of a pod's own world."""
        return ((self.distributed or self.pod_world)
                and self.num_processes > 1 and bool(self.coordinator))


def coordinator_host_port(address: str) -> Tuple[str, int]:
    """``host:port`` (or a bare host, meaning the default port)."""
    host, sep, port = address.rpartition(":")
    if not sep:
        return address, DEFAULT_COORDINATOR_PORT
    return host.strip("[]"), int(port)


def backend_for(device: torch.device) -> str:
    """NCCL for the card, gloo for the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def maybe_init_distributed(device: DeviceLike = None,
                           environ: Optional[Mapping[str, str]] = None,
                           timeout_s: float = JOIN_TIMEOUT_S) -> int:
    """Join the multi-process run the env describes, if it describes one,
    and return this process's rank (the env's process id; 0 when it names
    none). ``device`` is the device this process trains on: the card
    unless ``"cpu"``."""
    env = ProcessEnv.from_env(environ)
    if not env.joins or dist.is_initialized():
        return env.process_id
    device = resolve_device(device)
    backend = backend_for(device)
    host, port = coordinator_host_port(env.coordinator)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, env.num_processes,
                          is_master=env.process_id == 0, timeout=timeout)
    kwargs = {}
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        torch.cuda.set_device(index)
        # Eager init: a communicator that cannot be made raises here.
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, store=store, rank=env.process_id,
                            world_size=env.num_processes, timeout=timeout,
                            **kwargs)
    return env.process_id


def job_world(environ: Optional[Mapping[str, str]] = None) -> bool:
    """Whether a pod's processes join the job-wide world: the flag
    (``TPUJOB_JAX_DISTRIBUTED=1``) and a ``WORLD_SIZE`` the operator
    rendered for it. Otherwise a pod of several GPUs is a world of its
    own."""
    env = os.environ if environ is None else environ
    return env.get(ENV_JOB_WORLD) == "1" and bool(env.get("WORLD_SIZE"))


def local_ranks(environ: Optional[Mapping[str, str]] = None
                ) -> Optional[range]:
    """The ranks of this pod's processes, where the env asks for several
    (``LOCAL_WORLD_SIZE`` > 1, torchrun's names, as
    ``bootstrap/cluster.py`` renders them) and this process is none of
    them yet (no ``LOCAL_RANK``); else None. In the job-wide world
    (``job_world``) they are global: the pod's first rank is
    ``WORLD_SIZE`` - (``GROUP_WORLD_SIZE`` - ``GROUP_RANK``) x
    ``LOCAL_WORLD_SIZE`` (``GROUP_RANK`` x ``LOCAL_WORLD_SIZE`` where
    ``GROUP_WORLD_SIZE`` is missing, as under torchrun). Otherwise they
    are 0 .. ``LOCAL_WORLD_SIZE`` - 1, the pod's own world."""
    env = os.environ if environ is None else environ
    size = int(env.get("LOCAL_WORLD_SIZE") or 1)
    if size <= 1 or env.get("LOCAL_RANK") is not None:
        return None
    if not job_world(env):
        return range(size)
    group = int(env.get("GROUP_RANK") or 0)
    if env.get("GROUP_WORLD_SIZE"):
        first = (int(env["WORLD_SIZE"])
                 - (int(env["GROUP_WORLD_SIZE"]) - group) * size)
    else:
        first = group * size
    return range(first, first + size)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_processes(module: str,
                           argv: Optional[Sequence[str]] = None
                           ) -> Optional[int]:
    """Run a pod's local processes, one a GPU it holds, as torchrun does:
    where ``local_ranks`` names several, start ``python -m module argv``
    once for each, with ``LOCAL_RANK`` = i and ``RANK`` = its rank from
    ``local_ranks`` (only local rank 0 keeps ``TPUJOB_CKPT_FILE``; every
    one reads ``TPUJOB_PREEMPT_FILE``). Outside the job-wide world they
    are a world of their own: ``WORLD_SIZE`` = their count and the store
    at 127.0.0.1 on a free port (``MASTER_ADDR``/``MASTER_PORT``), with
    no ``GROUP_*`` key. Wait for them and return the exit
    code: the first non-zero one, after stopping the others (SIGTERM,
    SIGKILL after ``LOCAL_GRACE_S``), else 0. A SIGTERM to this process
    reaches every one. Returns None, starting nothing, where the env asks
    for one process: the caller is that process. Every payload that
    joins a world calls this first in its ``main``."""
    ranks = local_ranks()
    if ranks is None:
        return None
    argv = list(sys.argv[1:] if argv is None else argv)
    own_world = {} if job_world() else {
        "WORLD_SIZE": str(len(ranks)), "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(_free_port())}
    procs = []
    for i, rank in enumerate(ranks):
        env = dict(os.environ, LOCAL_RANK=str(i), RANK=str(rank),
                   **own_world)
        if own_world:
            env.pop("GROUP_RANK", None)
            env.pop("GROUP_WORLD_SIZE", None)
        if i:
            env.pop(ENV_CKPT_FILE, None)
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv],
                                      env=env))

    def forward(signum, _frame):
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signum)

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, forward)
    except ValueError:
        pass  # not the main thread: the pod's process group gets it
    try:
        while True:
            codes = [p.poll() for p in procs]
            code = next((c for c in codes if c not in (None, 0)), 0)
            if code or None not in codes:
                break
            time.sleep(0.05)
        if code:
            forward(signal.SIGTERM, None)
            deadline = time.monotonic() + LOCAL_GRACE_S
            for proc in procs:
                try:
                    proc.wait(timeout=max(0.05,
                                          deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        # A process a signal ended exits as a shell reports it: 128 + n.
        return code if code >= 0 else 128 - code
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


@contextlib.contextmanager
def process_group_scope():
    """Leave, on the way out, a process group made inside the block (by
    ``maybe_init_distributed`` or a world of one from
    ``parallel/mesh.py``); one that stood before stays. A block that ends
    normally first waits for every process, so process 0 serves the store
    until the last one is done."""
    owned = not dist.is_initialized()
    ok = False
    try:
        yield
        ok = True
    finally:
        if owned and dist.is_initialized():
            if ok and dist.get_world_size() > 1:
                dist.barrier()
            dist.destroy_process_group()
