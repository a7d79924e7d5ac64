"""Port parity: the port's serving plane against the JAX package's.

The same request traces go through each package's ``RequestQueue`` +
``ContinuousBatcher`` + ``ServingEngine`` and must give the same pop order,
outputs, outcomes, completion order and metric values (each package's own
metrics). The port's ``LlamaRunner`` on the CPU and the JAX one on the same
f32 weights give identical greedy tokens. The two workers share one spool
directory, and the port's worker serves to ``.close``, drains on a
barrier and acks it.
"""

import dataclasses
import importlib
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.runtime import metrics as jmetrics
from tf_operator_tpu.serve import batcher as jbatcher
from tf_operator_tpu.serve import engine as jengine
from tf_operator_tpu.serve import queue as jqueue
from tf_operator_tpu.serve import runner as jrunner
from tf_operator_tpu.serve import worker as jworker
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.models.convert import llama_params_from_flax
from tf_operator_tpu_torch.runtime import metrics as tmetrics
from tf_operator_tpu_torch.serve import batcher as tbatcher
from tf_operator_tpu_torch.serve import engine as tengine
from tf_operator_tpu_torch.serve import queue as tqueue
from tf_operator_tpu_torch.serve import runner as trunner
from tf_operator_tpu_torch.serve import worker as tworker

pytestmark = pytest.mark.compute

JAX = dict(queue=jqueue, batcher=jbatcher, engine=jengine, metrics=jmetrics,
           worker=jworker)
PORT = dict(queue=tqueue, batcher=tbatcher, engine=tengine, metrics=tmetrics,
            worker=tworker)


class Clock:
    """A clock that advances 10 ms a reading, so both packages see the
    same times."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        self.now += 0.01
        return self.now


def metric_snapshot(m, tenants):
    return {
        **{o: m.serving_requests_total.value(outcome=o)
           for o in ("completed", "rejected", "requeued")},
        "ttft_count": m.serving_ttft_seconds.count_value(),
        "ttft_sum": m.serving_ttft_seconds.sum_value(),
        **{f"depth_{t}": m.serving_queue_depth.value(tenant=t)
           for t in tenants},
    }


def run_trace(pkg, slots, tag):
    """Two tenants 2:1 at max depth 6: 8 submitted (2 rejected), two
    rounds, a drain mid-flight (in-flight back at the head of the lanes
    through requeue_front, queued re-submitted), one tenant removed, then
    serve until idle. Returns what each package must agree on."""
    q_mod, b_mod, e_mod, m = (pkg[k] for k in ("queue", "batcher", "engine",
                                                 "metrics"))
    a, b = f"{tag}-a", f"{tag}-b"
    before = metric_snapshot(m, (a, b))
    clock = Clock()
    queue = q_mod.RequestQueue(max_depth=6, tenant_weights={a: 2, b: 1},
                               clock=clock)
    popped = []
    pop = queue.pop

    def recording_pop():
        request = pop()
        if request is not None:
            popped.append(request.id)
        return request

    queue.pop = recording_pop
    engine = e_mod.ServingEngine(
        queue, b_mod.ContinuousBatcher(b_mod.FakeRunner(max_slots=slots),
                                       clock=clock), clock=clock)
    accepted = [queue.submit(q_mod.Request(
        id=f"r{i}", tenant=(a, b)[i % 3 == 2], prompt=[i, 2 * i + 1],
        max_new_tokens=3 + i % 4)) for i in range(8)]
    done = engine.step() + engine.step()
    evicted = engine.drain()
    in_flight = evicted[:slots]
    for request in reversed(in_flight):
        queue.requeue_front(request)
    for request in evicted[slots:]:
        queue.submit(request)
    removed = [r.id for r in queue.remove_tenant(b)]
    done += engine.run_until_idle()
    after = metric_snapshot(m, (a, b))
    return {
        "accepted": accepted,
        "evicted": [r.id for r in evicted],
        "removed": removed,
        "popped": popped,
        "completed": [r.id for r in done],
        "outputs": {r.id: list(r.output) for r in done},
        "outcomes": {r.id: r.outcome for r in done + evicted},
        "ttft": {r.id: r.ttft_seconds for r in done},
        "tokens_total": engine.tokens_total,
        "tokens_per_second": m.serving_tokens_per_second.value(),
        "metrics": {k: after[k] - before[k] for k in after},
    }


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_fake_runner_trace_matches_jax(slots):
    want = run_trace(JAX, slots, f"trace{slots}")
    got = run_trace(PORT, slots, f"trace{slots}")
    assert want["removed"] and want["evicted"] and not all(want["accepted"])
    # Deltas of a running sum: the two registries start from other totals.
    assert got["metrics"].pop("ttft_sum") == pytest.approx(
        want["metrics"].pop("ttft_sum"), abs=1e-9)
    assert got == want


def autoscaler_ttft_p99(root, pkg, spool):
    """Four requests through ``pkg``'s ``ServingEngine`` on a
    ``FakeRunner`` (TTFT counted from a fresh series), then the TTFT p99
    that ``pkg``'s autoscaler reads for a serving gang over ``spool``."""
    api = importlib.import_module(f"{root}.api")
    types = importlib.import_module(f"{root}.api.types")
    autoscaler = importlib.import_module(f"{root}.controller.autoscaler")
    store_mod = importlib.import_module(f"{root}.runtime.store")
    testutil = importlib.import_module(f"{root}.testutil")
    q_mod, b_mod, e_mod, m = (pkg[k] for k in ("queue", "batcher", "engine",
                                                 "metrics"))
    m.serving_ttft_seconds.remove()
    clock = Clock()
    queue = q_mod.RequestQueue(max_depth=8, clock=clock)
    engine = e_mod.ServingEngine(
        queue, b_mod.ContinuousBatcher(b_mod.FakeRunner(max_slots=2),
                                       clock=clock), clock=clock)
    for i in range(4):
        queue.submit(q_mod.Request(id=f"p{i}", tenant="ttft",
                                   prompt=[i + 1], max_new_tokens=2 + i))
    assert len(engine.run_until_idle()) == 4
    assert m.serving_ttft_seconds.count_value() == 4
    store = store_mod.Store()
    job = testutil.new_tpujob(worker=1, name="ttft", namespace="default")
    job.spec.run_policy.serving_policy = types.ServingPolicy(
        enabled=True, spool_directory=spool, target_queue_depth_per_slice=4)
    api.set_defaults(job)
    store.create(store_mod.TPUJOBS, job)
    scaler = autoscaler.ServingAutoscaler(store, gang=None)
    return scaler.signals("default", "ttft").get(autoscaler.SIGNAL_TTFT_P99)


def test_autoscaler_ttft_signal_matches_jax(tmp_path):
    """The port's engine counts into the registry its autoscaler reads,
    so a serving gang scales on TTFT as under JAX: the same requests give
    the same p99 signal in both packages."""
    want = autoscaler_ttft_p99("tf_operator_tpu", JAX, str(tmp_path))
    got = autoscaler_ttft_p99("tf_operator_tpu_torch", PORT, str(tmp_path))
    assert want is not None
    assert got == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("raw", ["a=3,b=1", "", "bad,x=2,y=zero", "z=0",
                                 " t = 4 , u=2"])
def test_parse_tenant_weights_matches_jax(raw):
    assert (tqueue.parse_tenant_weights(raw)
            == jqueue.parse_tenant_weights(raw))


def test_remove_tenant_prunes_the_port_gauge():
    queue = tqueue.RequestQueue(max_depth=8)
    queue.submit(tqueue.Request(id="x", tenant="ghost-tenant"))
    assert tmetrics.serving_queue_depth.value(tenant="ghost-tenant") == 1
    assert [r.id for r in queue.remove_tenant("ghost-tenant")] == ["x"]
    assert ("ghost-tenant",) not in tmetrics.serving_queue_depth._children


# ---------------------------------------------------------------------------
# LlamaRunner: identical greedy tokens on the same weights
# ---------------------------------------------------------------------------

VOCAB, MAX_SEQ = 64, 32
# (prompt length, max_new_tokens): buckets 8, 16 and 32; the 20-token
# prompt decodes to length 38, past max_seq_len.
LLAMA_TRACE = [(3, 6), (9, 4), (20, 18), (5, 5), (12, 3), (1, 8)]


def serve(runner, q_mod, b_mod, e_mod, prompts):
    queue = q_mod.RequestQueue(max_depth=16)
    engine = e_mod.ServingEngine(queue, b_mod.ContinuousBatcher(runner))
    for i, (prompt, budget) in enumerate(prompts):
        queue.submit(q_mod.Request(id=f"r{i}", prompt=prompt,
                                   max_new_tokens=budget))
    done = engine.run_until_idle()
    return [(r.id, list(r.output)) for r in done]


def test_llama_runner_tokens_match_jax():
    cfg = dataclasses.replace(jllama.llama_tiny(VOCAB, MAX_SEQ),
                              dtype=jnp.float32)
    params = jllama.Llama(cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tcfg = dataclasses.replace(tllama.llama_tiny(VOCAB, MAX_SEQ),
                               dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, VOCAB, n).tolist(), budget)
               for n, budget in LLAMA_TRACE]
    assert max(len(p) + b for p, b in prompts) > MAX_SEQ
    want = serve(jrunner.LlamaRunner(config=cfg, params=params, max_slots=2),
                 jqueue, jbatcher, jengine, prompts)
    port = trunner.LlamaRunner(config=tcfg,
                               params=llama_params_from_flax(params, tcfg),
                               max_slots=2, device="cpu")
    got = serve(port, tqueue, tbatcher, tengine, prompts)
    assert got == want
    assert [len(out) for _, out in sorted(got)] == [b for _, b in
                                                    LLAMA_TRACE]


def test_llama_runner_rejects_prompts_outside_the_cache():
    runner = trunner.LlamaRunner(config=tllama.llama_tiny(VOCAB, MAX_SEQ),
                                 max_slots=1, device="cpu")
    for length in (MAX_SEQ - 1, MAX_SEQ + 8):
        with pytest.raises(ValueError, match="prompt length"):
            runner.prefill([1] * length, 0)


# ---------------------------------------------------------------------------
# Spool and worker
# ---------------------------------------------------------------------------

def write_request(root, rid, tenant, prompt, max_new_tokens=4):
    os.makedirs(os.path.join(root, "pending"), exist_ok=True)
    path = os.path.join(root, "pending", f"{rid}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"id": rid, "tenant": tenant, "prompt": prompt,
                   "maxNewTokens": max_new_tokens}, f)
    os.replace(path + ".tmp", path)


def done_payloads(root):
    out = {}
    for name in sorted(os.listdir(os.path.join(root, "done"))):
        if name.endswith(".json"):
            with open(os.path.join(root, "done", name)) as f:
                payload = json.load(f)
            out[name] = {k: v for k, v in payload.items()
                         if k not in ("servedBy", "ttftSeconds")}
    return out


def serve_claimed(pkg, spool, request):
    """Serve one claimed request through pkg's engine and finish it."""
    queue = pkg["queue"].RequestQueue()
    engine = pkg["engine"].ServingEngine(
        queue, pkg["batcher"].ContinuousBatcher(
            pkg["batcher"].FakeRunner(max_slots=2)),
        on_complete=spool.finish)
    queue.submit(request)
    engine.run_until_idle()


@pytest.mark.parametrize("first, second", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_then_port", "port_then_jax"])
def test_shared_spool(first, second, tmp_path):
    """A request the first package claims and hands back is claimed,
    served and finished by the second; its done/ JSON equals the one the
    first package writes for the same request, bar servedBy and
    ttftSeconds."""
    shared, alone = str(tmp_path / "shared"), str(tmp_path / "alone")
    for root in (shared, alone):
        write_request(root, "req0", "team-a", [5, 6, 7], 5)
    one = first["worker"].Spool(shared, "pod-one")
    two = second["worker"].Spool(shared, "pod-two")
    assert one.claim_one().id == "req0"
    one.requeue_id("req0")
    serve_claimed(second, two, two.claim_one())
    solo = first["worker"].Spool(alone, "pod-solo")
    serve_claimed(first, solo, solo.claim_one())
    assert done_payloads(shared) == done_payloads(alone)
    assert done_payloads(shared)["req0.json"]["tokens"]
    for spool in (one, two):
        assert spool.pending_empty() and spool.claimed_empty()
    with open(os.path.join(shared, "done", "req0.json")) as f:
        assert json.load(f)["servedBy"] == "pod-two"


@pytest.fixture
def worker_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("TPUJOB_"):
            monkeypatch.delenv(name)
    monkeypatch.setenv("TPUJOB_POD_NAME", "serve-0")
    return monkeypatch


REQUESTS = [("q0", "a", [1, 2, 3], 4), ("q1", "b", [7], 6),
            ("q2", "a", [4, 4, 9, 2], 3)]


@pytest.mark.parametrize("runner", ["fake", "llama"])
def test_worker_serves_to_close(runner, worker_env, tmp_path):
    """The port's worker serves a spool to its .close sentinel and exits
    0; with the fake runner its responses equal the JAX worker's."""
    roots = {}
    for name in ("port", "jax"):
        roots[name] = str(tmp_path / name)
        for rid, tenant, prompt, budget in REQUESTS:
            write_request(roots[name], rid, tenant, prompt, budget)
        open(os.path.join(roots[name], ".close"), "w").close()
    args = ["--runner", runner, "--poll-interval", "0.001"]
    assert tworker.main(args + ["--spool", roots["port"], "--device",
                                "cpu"]) == 0
    got = done_payloads(roots["port"])
    assert sorted(got) == [f"{rid}.json" for rid, *_ in REQUESTS]
    assert [len(got[f"{rid}.json"]["tokens"]) for rid, *_ in REQUESTS] == [
        budget for *_, budget in REQUESTS]
    if runner == "fake":
        assert jworker.main(args + ["--spool", roots["jax"]]) == 0
        assert got == done_payloads(roots["jax"])


class GatedRunner(tbatcher.FakeRunner):
    """FakeRunner whose first decode waits for the test to open a gate, so
    the preemption notice lands while requests are in flight."""

    def __init__(self, max_slots):
        super().__init__(max_slots=max_slots)
        self.decoding = threading.Event()
        self.gate = threading.Event()

    def decode(self, last_tokens, lengths):
        self.decoding.set()
        assert self.gate.wait(timeout=30)
        return super().decode(last_tokens, lengths)


def test_worker_drains_and_acks_a_barrier(worker_env, tmp_path):
    root = str(tmp_path / "spool")
    notice, record = str(tmp_path / "notice.json"), str(tmp_path / "rec.json")
    worker_env.setenv("TPUJOB_PREEMPT_FILE", notice)
    worker_env.setenv("TPUJOB_CKPT_FILE", record)
    worker_env.setenv("TPUJOB_SERVE_SLOTS", "2")
    runners = []

    def gated(slots, device):
        runners.append(GatedRunner(slots))
        return runners[-1]

    worker_env.setitem(tworker.RUNNERS, "fake", gated)
    for rid, tenant, prompt, _ in REQUESTS:
        write_request(root, rid, tenant, prompt, 50)
    result = []
    thread = threading.Thread(target=lambda: result.append(tworker.main(
        ["--spool", root, "--poll-interval", "0.001"])), daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 30
        while not runners and time.monotonic() < deadline:
            time.sleep(0.001)
        assert runners and runners[0].decoding.wait(timeout=30)
        with open(notice, "w") as f:
            json.dump({"barrier": "b1"}, f)
    finally:
        if runners:
            runners[0].gate.set()

    def record_barrier():
        try:
            with open(record) as f:
                return json.load(f)["barrier"]
        except (OSError, ValueError):
            return ""

    deadline = time.monotonic() + 30
    while record_barrier() != "b1" and time.monotonic() < deadline:
        time.sleep(0.005)
    assert record_barrier() == "b1"
    spool = tworker.Spool(root, "serve-0")
    assert spool.claimed_empty() and not os.listdir(
        os.path.join(root, "done"))
    assert sorted(os.listdir(os.path.join(root, "pending"))) == [
        f"{rid}.json" for rid, *_ in REQUESTS]
    # Another replica serves the requeued requests; the drained worker
    # then exits at the sentinel.
    other = jworker.Spool(root, "serve-1")
    while (request := other.claim_one()) is not None:
        serve_claimed(JAX, other, request)
    open(os.path.join(root, ".close"), "w").close()
    thread.join(timeout=30)
    assert not thread.is_alive() and result == [0]
    assert len(os.listdir(os.path.join(root, "done"))) == len(REQUESTS)
