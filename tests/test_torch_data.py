"""Port parity: host -> device feeding (``train/data.py``).

``prefetch_to_device`` and ``DeviceFeeder`` against what
tests/test_native_data.py pins for the JAX ones: order kept, no more than
``depth`` + 1 batches pulled ahead (the same pull counts as the JAX
generator after every batch), finite and empty iterators, and
``run_train_steps(prefetch_device=...)`` feeding the same batches as the
loop without it. On the CPU the batches become torch tensors; the pinned
copies on a side stream run only on the card, where chip_smoke.py's remat
phase feeds training steps through them.
"""

import numpy as np
import pytest
import torch

from tf_operator_tpu.train import data as jdata
from tf_operator_tpu_torch.train import data as tdata
from tf_operator_tpu_torch.train.trainer import run_train_steps

pytestmark = pytest.mark.compute

CPU = torch.device("cpu")


def _jax_device():
    import jax

    return jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])


def test_prefetch_to_device_preserves_order_and_places():
    src = [{"x": np.full((2,), i, np.int32)} for i in range(7)]
    out = list(tdata.prefetch_to_device(iter(src), CPU, depth=2))
    assert [int(b["x"][0]) for b in out] == list(range(7))
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device == CPU
               for b in out)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetch_pulls_ahead_as_jax_does(depth):
    """Never more than depth + 1 batches pulled beyond the consumer: the
    same pull count as the JAX generator after every batch."""
    def pulls(prefetch, device):
        pulled, counts = [], []

        def source():
            for i in range(10):
                pulled.append(i)
                yield {"x": np.full((2,), i, np.int32)}

        for batch in prefetch(source(), device, depth=depth):
            counts.append((int(batch["x"][0]), len(pulled)))
        return counts

    got = pulls(tdata.prefetch_to_device, CPU)
    want = pulls(jdata.prefetch_to_device, {"x": _jax_device()})
    assert got == want
    assert [i for i, _ in got] == list(range(10))
    assert all(n <= i + 1 + depth for i, n in got)


def test_prefetch_to_device_short_iterator_and_empty():
    one = [{"x": np.zeros((1,), np.float32)}]
    assert len(list(tdata.prefetch_to_device(iter(one), CPU, depth=4))) == 1
    assert list(tdata.prefetch_to_device(iter([]), CPU, depth=2)) == []


def test_prefetch_copies_the_host_batch():
    """A staged batch does not alias the host array the source may
    reuse (as jax.device_put copies)."""
    host = np.zeros((3,), np.float32)
    (batch,) = tdata.prefetch_to_device(iter([{"x": host}]), CPU)
    host[:] = 7
    assert not batch["x"].any()


def test_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tdata.prefetch_to_device(iter([{"x": np.zeros(1)}])))


def test_run_train_steps_prefetch_flag_feeds_same_batches():
    def run(**prefetch):
        seen = []

        def step_fn(state, batch):
            seen.append(int(batch["x"][0]))
            return state + 1, {"loss": 0.0}

        src = [{"x": np.full((2,), i, np.int32)} for i in range(5)]
        assert run_train_steps(step_fn, 0, iter(src), num_steps=5,
                               **prefetch) == 5
        return seen

    assert run(prefetch_device=CPU, prefetch_depth=3) == run() == \
        list(range(5))


def test_device_feeder_finite_iterator_raises_stopiteration():
    batches = [{"inputs": np.ones((2, 2), np.float32) * i} for i in range(3)]
    feeder = tdata.DeviceFeeder(iter(batches), CPU)
    out = list(feeder)
    assert [float(b["inputs"][0, 0]) for b in out] == [0.0, 1.0, 2.0]
    feeder.stop()
    jfeeder = jdata.DeviceFeeder(iter(batches), {"inputs": _jax_device()})
    assert len(list(jfeeder)) == len(out)
    jfeeder.stop()


def test_device_feeder_stop_frees_a_blocked_producer():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((1,), i)}
            i += 1

    feeder = tdata.DeviceFeeder(endless(), CPU, prefetch=1)
    assert int(next(feeder)["x"][0]) == 0
    feeder.stop()
    feeder._thread.join(timeout=5)
    assert not feeder._thread.is_alive()
    with pytest.raises(StopIteration):
        next(feeder)


def test_device_feeder_stop_ends_iteration_after_a_late_put():
    """A producer blocked in _put may land one batch after stop() drained
    the queue (it does in some tries); next() must still end."""
    def endless():
        i = 0
        while True:
            yield {"x": np.full((1,), i)}
            i += 1

    late = 0
    for _ in range(30):
        feeder = tdata.DeviceFeeder(endless(), CPU, prefetch=1)
        next(feeder)
        feeder.stop()
        feeder._thread.join(timeout=5)
        assert not feeder._thread.is_alive()
        try:
            next(feeder)
            late += 1
        except StopIteration:
            pass
    assert late == 0


def test_device_feeder_surfaces_source_errors():
    def broken():
        yield {"x": np.zeros(1)}
        raise ValueError("bad record")

    feeder = tdata.DeviceFeeder(broken(), CPU)
    next(feeder)
    with pytest.raises(ValueError, match="bad record"):
        next(feeder)
    feeder.stop()
