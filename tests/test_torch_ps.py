"""Port parity: the port's parameter-server runtime (train/ps.py) and its
MNIST worker (train/dist_mnist_ps.py) against the JAX package's, on the
CPU (``device="cpu"``).

The counterparts of ``tests/test_ps.py``'s unit tests, and across the two
packages: ``shard_of`` equal on a key set; each side's ``_unpack`` of the
other side's ``_pack`` equal, reserved and odd keys included; the JAX
``PSClient`` training against a port shard and the port's client against a
JAX shard; SGD steps, with and without momentum, equal to the JAX
server's within 1e-7; the worker's gradients against the JAX worker's
``loss_fn`` within 1e-6.
"""

import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.train import ps as jps
from tf_operator_tpu_torch.train import dist_mnist_ps as tworker
from tf_operator_tpu_torch.train import ps as tps

pytestmark = pytest.mark.compute

SGD_TOL = 1e-7
GRAD_TOL = 1e-6


@pytest.fixture
def servers():
    """Start servers through ``start(server)``; stops them all after."""
    started = []

    def start(server):
        started.append(server.serve())
        return server

    yield start
    for server in started:
        server.stop()


def addr(server):
    return f"127.0.0.1:{server.port}"


def port_server(**kwargs):
    return tps.ParameterServer(host="127.0.0.1", device="cpu", **kwargs)


# --- wire format ----------------------------------------------------------

def test_flatten_unflatten_round_trip_with_tensors():
    tree = {"a": {"b": torch.ones(2, 3), "c": np.zeros(4)},
            "d": torch.arange(5)}
    flat = tps.flatten_params(tree)
    assert sorted(flat) == ["a/b", "a/c", "d"]
    assert all(isinstance(v, np.ndarray) for v in flat.values())
    back = tps.unflatten_params(flat)
    np.testing.assert_array_equal(back["a"]["b"], np.ones((2, 3)))
    np.testing.assert_array_equal(back["d"], np.arange(5))
    want = jps.flatten_params({"a": {"b": np.ones((2, 3)), "c": np.zeros(4)},
                               "d": np.arange(5)})
    assert sorted(want) == sorted(flat)


def test_shard_of_matches_jax():
    keys = [f"layer{i}/w" for i in range(100)] + [
        "blocks/attn/wq/kernel", "a/b.c/d", "file", "ünïcode"]
    for n in (1, 2, 3, 8):
        assert [tps.shard_of(k, n) for k in keys] == [
            jps.shard_of(k, n) for k in keys]
    assert len({tps.shard_of(k, 3) for k in keys}) == 3


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_format_crosses_packages(direction):
    """'file' and 'allow_pickle' collide with np.savez's parameters;
    slashes and dots are normal in flax paths."""
    flat = {"file": np.ones(2, np.float32), "allow_pickle": np.zeros(3),
            "a/b.c/d": np.arange(4), "dense1/w": np.eye(3, dtype=np.float32)}
    pack, unpack = ((jps._pack, tps._unpack) if direction == "jax_to_port"
                    else (tps._pack, jps._unpack))
    back = unpack(pack(flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k])


# --- the server -----------------------------------------------------------

def test_single_server_applies_exact_sgd_step(servers):
    server = servers(port_server(lr=0.5))
    client = tps.PSClient([addr(server)])
    client.wait_ready(timeout=5)
    client.init({"w": np.array([1.0, 2.0], np.float32)})
    client.push({"w": torch.tensor([0.2, -0.2])})
    np.testing.assert_allclose(client.pull()["w"], [0.9, 2.1], rtol=1e-6)
    client.close()


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_steps_match_jax_server(servers, momentum):
    """Four pushes on the same init: each shard's parameters equal the JAX
    server's (optax.sgd) within 1e-7, with and without a momentum
    trace."""
    rng = np.random.default_rng(momentum > 0)
    init = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    pushes = [{k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in init.items()} for _ in range(4)]
    opt = (optax.sgd(0.1, momentum=momentum) if momentum
           else optax.sgd(0.1))
    jserver = jps.ParameterServer(optimizer=opt)
    tserver = port_server(lr=0.1, momentum=momentum)
    for s in (jserver, tserver):
        s.init(init)
    for g in pushes:
        assert jserver.push(g) == tserver.push(g)
    want, got = jserver.pull()[0], tserver.pull()[0]
    for k in init:
        np.testing.assert_allclose(got[k], want[k], atol=SGD_TOL, rtol=0,
                                   err_msg=k)
        assert not np.array_equal(got[k], init[k])


BAD_PUSH_INIT = {"a": np.ones(4, np.float32), "b": np.ones(3, np.float32)}
BAD_PUSH = {"a": np.full(4, 0.5, np.float32), "b": np.ones(5, np.float32)}


def _state(server):
    """(params, momentum trace leaves, version) of either side's shard."""
    params, version = server.pull()
    if isinstance(server, jps.ParameterServer):
        trace = [np.asarray(x)
                 for x in jax.tree_util.tree_leaves(server._opt_state)]
    else:
        trace = ([] if server._trace is None else
                 [server._trace[k].numpy() for k in sorted(server._trace)])
    return params, trace, version


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_failed_push_leaves_shard_as_jax_server(momentum):
    """A push whose second gradient does not fit its parameter leaves the
    port's shard as the JAX server leaves its own: params, momentum trace
    and version untouched (one good push first, so the trace is not
    zero). Both raise; the exception types differ by framework."""
    opt = (optax.sgd(0.1, momentum=momentum) if momentum
           else optax.sgd(0.1))
    jserver = jps.ParameterServer(optimizer=opt)
    tserver = port_server(lr=0.1, momentum=momentum)
    good = {"a": np.full(4, 0.25, np.float32), "b": np.ones(3, np.float32)}
    for s in (jserver, tserver):
        s.init(BAD_PUSH_INIT)
        s.push(good)
    before = _state(tserver)
    for s in (jserver, tserver):
        with pytest.raises(Exception):
            s.push(BAD_PUSH)
    (jp, jt, jv), (tp, tt, tv) = _state(jserver), _state(tserver)
    assert jv == tv == before[2] == 1
    for k in BAD_PUSH_INIT:
        np.testing.assert_allclose(tp[k], jp[k], atol=SGD_TOL, rtol=0)
        np.testing.assert_array_equal(tp[k], before[0][k])
    assert len(jt) == len(tt) == (2 if momentum else 0)
    # JAX's trace leaves follow its sorted keys, as the port's list does.
    for j, t in zip(jt, tt):
        np.testing.assert_allclose(t, j, atol=SGD_TOL, rtol=0)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_failed_push_drops_the_connection(servers, side):
    """Over HTTP a push that does not fit a momentum shard is no 400 on
    either side: the handler raises and the connection drops, and the
    shard is unmoved. (Without momentum the JAX server's numpy add raises
    a ValueError, which it answers with a 400; the port drops there too.)"""
    server = servers(jps.ParameterServer(
        optimizer=optax.sgd(0.1, momentum=0.9), host="127.0.0.1")
        if side == "jax" else port_server(lr=0.1, momentum=0.9))
    server.init(BAD_PUSH_INIT)
    with pytest.raises((urllib.error.URLError, ConnectionError)) as e:
        urllib.request.urlopen(urllib.request.Request(
            f"http://{addr(server)}/push", data=tps._pack(BAD_PUSH),
            method="POST"), timeout=5)
    assert not isinstance(e.value, urllib.error.HTTPError)
    params, version = server.pull()
    assert version == 0
    np.testing.assert_array_equal(params["a"], BAD_PUSH_INIT["a"])


def test_pull_is_a_copy_and_init_keeps_no_reference():
    server = port_server(lr=1.0)
    w = np.ones(3, np.float32)
    server.init({"w": w})
    pulled, version = server.pull()
    server.push({"w": np.ones(3, np.float32)})
    np.testing.assert_array_equal(pulled["w"], np.ones(3))
    np.testing.assert_array_equal(w, np.ones(3))
    assert version == 0 and server.pull()[1] == 1


def test_init_first_writer_wins(servers):
    server = servers(port_server())
    client = tps.PSClient([addr(server)])
    client.init({"w": np.zeros(2, np.float32)})
    client.init({"w": np.full(2, 9.0, np.float32)})  # loser
    np.testing.assert_array_equal(client.pull()["w"], np.zeros(2))


def test_params_sharded_across_servers(servers):
    shards = [servers(port_server(lr=1.0)) for _ in range(2)]
    client = tps.PSClient([addr(s) for s in shards])
    params = {f"l{i}": {"w": np.full(2, float(i), np.float32)}
              for i in range(8)}
    client.init(params)
    counts = [len(s.pull()[0]) for s in shards]
    assert all(c > 0 for c in counts) and sum(counts) == 8
    for i, s in enumerate(shards):
        assert all(tps.shard_of(k, 2) == i for k in s.pull()[0])
    client.push({k: {"w": np.ones(2, np.float32)} for k in params})
    out = client.pull()
    for i in range(8):
        np.testing.assert_allclose(out[f"l{i}"]["w"],
                                   np.full(2, float(i) - 1.0))
    client.close()


@pytest.mark.parametrize("path", ["/push", "/params"])
def test_before_init_is_409(servers, path):
    server = servers(port_server())
    client = tps.PSClient([addr(server)])
    with pytest.raises(urllib.error.HTTPError) as e:
        if path == "/push":
            client.push({"w": np.zeros(2, np.float32)})
        else:
            client.pull()
    assert e.value.code == 409


def test_push_missing_keys_is_400(servers):
    server = servers(port_server())
    url = f"http://{addr(server)}/push"
    server.init({"w": np.zeros(2, np.float32), "b": np.zeros(1, np.float32)})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            url, data=tps._pack({"w": np.ones(2, np.float32)}),
            method="POST"), timeout=5)
    assert e.value.code == 400
    assert b"missing" in e.value.read()


def test_token_gates_every_endpoint_but_healthz(servers):
    server = servers(port_server(lr=0.1, token="s3cret"))
    a = addr(server)
    with urllib.request.urlopen(f"http://{a}/healthz", timeout=5) as r:
        assert r.status == 200
    anon = tps.PSClient([a], token="", retry_seconds=0.1)
    with pytest.raises(urllib.error.HTTPError) as err:
        anon.init({"w": np.zeros(2, np.float32)})
    assert err.value.code == 401
    wrong = tps.PSClient([a], token="nope", retry_seconds=0.1)
    for call in (wrong.pull, lambda: wrong.push({"w": np.zeros(2)})):
        with pytest.raises(urllib.error.HTTPError) as err:
            call()
        assert err.value.code == 401
    good = tps.PSClient([a], token="s3cret")
    good.init({"w": np.ones(2, np.float32)})
    good.push({"w": np.ones(2, np.float32)})
    assert good.pull()["w"].shape == (2,)


# --- across packages ------------------------------------------------------

def _train_mlp(client, steps=12):
    """JAX-worker-style async steps through ``client``: pull, the MLP's
    gradient at a fixed batch, push. Returns the losses."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 784)).astype(np.float32)
    y = rng.integers(0, 10, 32)
    losses = []
    for _ in range(steps):
        p = {a: {b: torch.tensor(t) for b, t in layer.items()}
             for a, layer in client.pull().items()}
        loss, g = tworker.grads(p, torch.tensor(x), torch.tensor(y))
        client.push(g)
        losses.append(float(loss))
    return losses


def test_jax_client_trains_against_port_server(servers):
    shards = [servers(port_server(lr=0.2)) for _ in range(2)]
    client = jps.PSClient([addr(s) for s in shards])
    client.wait_ready(timeout=5)
    client.init({a: {b: t.numpy() for b, t in layer.items()}
                 for a, layer in tworker.init_params().items()})
    losses = _train_mlp(client)
    assert losses[-1] < losses[0] - 0.5, losses
    assert sum(s._version for s in shards) == 2 * len(losses)


def test_port_client_trains_against_jax_server(servers):
    shards = [servers(jps.ParameterServer(optimizer=optax.sgd(0.2),
                                          host="127.0.0.1"))
              for _ in range(2)]
    client = tps.PSClient([addr(s) for s in shards])
    client.wait_ready(timeout=5)
    client.init(tworker.init_params())
    losses = _train_mlp(client)
    client.close()
    assert losses[-1] < losses[0] - 0.5, losses
    # Both shards took every step.
    assert [s._version for s in shards] == [len(losses)] * 2


# --- persistence ----------------------------------------------------------

def test_state_persists_across_restart(tmp_path):
    path = str(tmp_path / "shard.ckpt")
    server = port_server(lr=0.5, momentum=0.9, state_path=path,
                         save_interval=1).serve()
    client = tps.PSClient([addr(server)])
    client.init({"w": np.zeros(4, np.float32)})
    for _ in range(3):
        client.push({"w": np.ones(4, np.float32)})
    trained = client.pull()["w"]
    server.stop()

    revived = port_server(lr=0.5, momentum=0.9, state_path=path).serve()
    try:
        client2 = tps.PSClient([addr(revived)])
        # A worker racing the restart re-inits: the restored state wins.
        client2.init({"w": np.zeros(4, np.float32)})
        np.testing.assert_allclose(client2.pull()["w"], trained)
        assert revived._version == 3
        # The momentum trace came back too: the next step is the one the
        # first server would have taken (trace 0.9·2.71 + 1).
        client2.push({"w": np.ones(4, np.float32)})
        np.testing.assert_allclose(client2.pull()["w"],
                                   trained - 0.5 * (0.9 * 2.71 + 1),
                                   rtol=1e-6)
    finally:
        revived.stop()


def test_corrupt_state_file_is_set_aside(tmp_path):
    path = str(tmp_path / "shard.ckpt")
    with open(path, "wb") as f:
        f.write(b"\x80\x04not-a-state-file")
    server = port_server(lr=0.1, state_path=path).serve()
    try:
        assert os.path.exists(path + ".corrupt")
        client = tps.PSClient([addr(server)])
        client.init({"w": np.ones(2, np.float32)})
        np.testing.assert_allclose(client.pull()["w"], np.ones(2))
    finally:
        server.stop()
    # The fresh state was written in its place.
    assert port_server(state_path=path)._version == 0
    assert os.path.exists(path)


def test_client_retries_through_server_restart(tmp_path):
    path = str(tmp_path / "shard.ckpt")
    server = port_server(lr=0.1, state_path=path, save_interval=1).serve()
    port = server.port
    client = tps.PSClient([addr(server)], retry_seconds=10.0)
    client.init({"w": np.zeros(2, np.float32)})
    client.push({"w": np.ones(2, np.float32)})
    server.stop()

    revived = []

    def revive():
        time.sleep(0.5)
        revived.append(port_server(lr=0.1, port=port,
                                   state_path=path).serve())

    t = threading.Thread(target=revive, daemon=True)
    t.start()
    try:
        pulled = client.pull()          # issued while the port is dead
        t.join(timeout=5)
        assert not t.is_alive()
        np.testing.assert_allclose(pulled["w"], [-0.1, -0.1])
    finally:
        t.join(timeout=5)
        for s in revived:
            s.stop()


# --- cluster spec and the worker -----------------------------------------

def _held_port():
    """A listening socket on a free loopback port, and the port."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen()
    return sock, sock.getsockname()[1]


def test_a_shard_binds_its_port_once_it_comes_free():
    """A revived shard's address is its predecessor's: the bind waits
    while the old server (here a listening socket) still holds it."""
    sock, port = _held_port()
    threading.Timer(0.5, sock.close).start()
    started = time.monotonic()
    server = tps.ParameterServer(host="127.0.0.1", port=port,
                                 device="cpu").serve()
    try:
        assert server.port == port
        assert time.monotonic() - started >= 0.4
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=5) as resp:
            assert resp.status == 200
    finally:
        server.stop()


def test_a_shard_gives_up_on_a_port_held_past_the_bound(monkeypatch):
    sock, port = _held_port()
    monkeypatch.setattr(tps, "BIND_RETRY_S", 0.3)
    try:
        with pytest.raises(OSError, match="in use"):
            tps.ParameterServer(host="127.0.0.1", port=port,
                                device="cpu").serve()
    finally:
        sock.close()


def test_cluster_ps_addrs_and_own_task():
    spec = ('{"cluster": {"ps": ["127.0.0.1:41000", "127.0.0.1:41001"], '
            '"worker": ["127.0.0.1:41002"]}, '
            '"task": {"type": "ps", "index": 1}}')
    assert tps.cluster_ps_addrs(spec) == jps.cluster_ps_addrs(spec) == [
        "127.0.0.1:41000", "127.0.0.1:41001"]
    assert tps.own_task(spec) == jps.own_task(spec) == ("ps", 1)
    assert tps.cluster_ps_addrs("") == [] and tps.own_task("") == ("", 0)


def test_ps_main_refuses_a_non_ps_task(monkeypatch):
    monkeypatch.setenv(tps.ENV_CLUSTER_SPEC,
                       '{"cluster": {"ps": ["127.0.0.1:1"]}, '
                       '"task": {"type": "worker", "index": 0}}')
    with pytest.raises(SystemExit, match="not 'ps'"):
        tps.main(["--device", "cpu"])


def test_worker_grads_match_jax_worker():
    """The JAX worker's loss_fn (examples/dist_mnist/dist_mnist_ps.py) and
    the port's at the same params and batch: loss and gradients within
    1e-6."""
    def jax_loss(p, x, y):
        h = jax.nn.relu(x @ p["dense1"]["w"] + p["dense1"]["b"])
        logits = h @ p["dense2"]["w"] + p["dense2"]["b"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    params = tworker.init_params()
    params["dense1"]["b"] += 0.01        # nonzero biases
    x, y = tworker.batch(worker_id=1, step=3, batch_size=16)
    loss, grads = tworker.grads(params, x, y)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jloss, jgrads = jax.value_and_grad(jax_loss)(
        jparams, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    np.testing.assert_allclose(float(loss), float(jloss), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    for a in params:
        for b in params[a]:
            np.testing.assert_allclose(grads[a][b].numpy(),
                                       np.asarray(jgrads[a][b]),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{a}/{b}")


def test_worker_batches_are_separable_and_seeded():
    x, y = tworker.batch(0, 0, 64)
    x2, y2 = tworker.batch(0, 0, 64)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(tworker.batch(1, 0, 64)[0], x)
    assert len(set(y.tolist())) > 3
