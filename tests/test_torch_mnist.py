"""Port parity: the MNIST models, their weight bridge, the classification
loss, adam, and the restart-with-resume payload.

- ``MnistCNN`` and ``MnistMLP`` logits against flax on converted weights
  (f32, within 1e-5), and the bridge round-trips exactly;
- ``adam`` against ``optax.adam`` over 3 updates (1e-6), and 3 training
  steps of ``MnistCNN`` with ``classification_loss`` and ``adam(1e-3)``
  against the JAX ``Trainer`` on a one-device mesh (losses within 1e-5,
  parameters within 2e-4, a fifth of one step);
- ``train.dist_mnist``: a crash at step 3 exits 137, the rerun resumes
  there, and its step-6 parameters equal an uninterrupted run's bit for
  bit (the CPU sums in a fixed order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.models.resnet import param_logical_axes
from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
from tf_operator_tpu.parallel.sharding import CNN_RULES
from tf_operator_tpu.train import trainer as jtr
from tf_operator_tpu_torch.models import mnist as tmnist
from tf_operator_tpu_torch.models.convert import (
    mnist_params_from_flax,
    mnist_params_to_flax,
)
from tf_operator_tpu_torch.train import dist_mnist
from tf_operator_tpu_torch.train import trainer as ttr
from tf_operator_tpu_torch.train.checkpoint import Checkpointer

pytestmark = pytest.mark.compute

MODELS = {"cnn": (jmnist.MnistCNN, tmnist.MnistCNN),
          "mlp": (jmnist.MnistMLP, tmnist.MnistMLP)}


def images(batch=4, seed=0):
    return np.random.default_rng(seed).random((batch, 28, 28, 1),
                                              dtype=np.float32)


def build(which, seed=0):
    jcls, tcls = MODELS[which]
    jmodel = jcls()
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 28, 28, 1)))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tcls(device="cpu")
    tmodel.load_state_dict(mnist_params_from_flax(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("which", sorted(MODELS))
def test_logits_match_flax(which):
    jmodel, params, tmodel = build(which)
    x = images()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("which", sorted(MODELS))
def test_bridge_round_trips(which):
    _, params, tmodel = build(which, seed=1)
    back = mnist_params_to_flax(tmodel.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_bridge_raises_on_unknown_leaves():
    _, params, tmodel = build("mlp")
    with pytest.raises(KeyError, match="expected"):
        mnist_params_from_flax(dict(params, fc3={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="no weight or bias"):
        mnist_params_to_flax(dict(tmodel.state_dict(),
                                  **{"fc1.scale": torch.zeros(1)}))


def test_flatten_order_is_flax_hwc():
    """fc1 reads the conv output in flax's (h, w, c) order: fc1 rows laid
    out for a (c, h, w) flatten give other logits."""
    jmodel, params, tmodel = build("cnn")
    x = torch.tensor(images())
    kernel = params["fc1"]["kernel"].reshape(7, 7, 64, 512)
    chw = dict(params, fc1=dict(params["fc1"], kernel=np.ascontiguousarray(
        kernel.transpose(2, 0, 1, 3)).reshape(-1, 512)))
    wrong = tmnist.MnistCNN(device="cpu")
    wrong.load_state_dict(mnist_params_from_flax(chw))
    with torch.no_grad():
        assert not torch.allclose(wrong(x), tmodel(x), atol=1e-3)


def test_synthetic_batch_from_an_explicit_generator():
    a = tmnist.synthetic_batch(torch.Generator().manual_seed(3), 8)
    b = tmnist.synthetic_batch(torch.Generator().manual_seed(3), 8)
    assert a["inputs"].shape == (8, 28, 28, 1)
    assert a["labels"].shape == (8,) and a["labels"].dtype == torch.int64
    assert 0 <= float(a["inputs"].min()) and float(a["inputs"].max()) < 1
    assert 0 <= int(a["labels"].min()) and int(a["labels"].max()) < 10
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_adam_matches_optax():
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in [(8, 4), (4,), (3, 5)]]
    grads_seq = [[rng.standard_normal(p.shape).astype(np.float32)
                  for p in params] for _ in range(3)]
    tx = optax.adam(3e-3)
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for grads in grads_seq:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)

    opt = ttr.adam(3e-3)
    tparams = [nn.Parameter(torch.tensor(p)) for p in params]
    torch_opt = opt.make(tparams)
    for count, grads in enumerate(grads_seq):
        for p, g in zip(tparams, grads):
            p.grad = torch.tensor(g)
        opt.apply(torch_opt, count)
    for got, want in zip(tparams, jparams):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def test_three_steps_match_the_jax_trainer():
    """classification_loss and adam(1e-3) through both trainers."""
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jtrainer = jtr.Trainer(model=jmnist.MnistCNN(),
                           param_axes_fn=param_logical_axes, rules=CNN_RULES,
                           mesh=mesh, optimizer=optax.adam(1e-3),
                           loss_fn=jtr.classification_loss)
    data = np.random.default_rng(0)
    batches = [{"inputs": data.random((8, 28, 28, 1), dtype=np.float32),
                "labels": data.integers(0, 10, (8,))} for _ in range(3)]
    sample = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jstate, shardings = jtrainer.init(jax.random.PRNGKey(0), sample)
    jstep = jtrainer.make_train_step(shardings, sample)

    model = tmnist.MnistCNN(device="cpu")
    model.load_state_dict(mnist_params_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    ttrainer = ttr.Trainer(model=model, optimizer=ttr.adam(1e-3),
                           loss_fn=ttr.classification_loss, device="cpu")
    tstate, tstep = ttrainer.init(), ttrainer.make_train_step()
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=1e-5)
    # Adam divides by sqrt(v): for a weight whose gradient is near zero (11
    # of fc1's 1.6M here) each side's rounding sets the size of its step,
    # so parameters are held to a fifth of one 1e-3 step (2e-4).
    want = mnist_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(),
                                   want[name].numpy(), atol=2e-4, rtol=0,
                                   err_msg=name)


def _params(directory, step):
    model = tmnist.MnistCNN(device="cpu")
    state = ttr.Trainer(model=model, optimizer=ttr.adam(1e-3),
                        device="cpu").init()
    ckpt = Checkpointer(str(directory))
    ckpt.restore(state, step=step)
    ckpt.close()
    return dict(model.named_parameters())


def test_payload_crashes_resumes_and_matches_an_uninterrupted_run(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TPUJOB_CLUSTER_SPEC", json.dumps(
        {"task": {"type": "worker", "index": 0}}))
    args = ["--steps", "6", "--batch-size", "16", "--device", "cpu"]
    resumed, straight = tmp_path / "resumed", tmp_path / "straight"
    crash = ["--checkpoint-dir", str(resumed), "--crash-at-step", "3"]
    assert dist_mnist.main(args + crash) == 137
    first = capsys.readouterr().out
    assert dist_mnist.main(args + crash) == 0
    second = capsys.readouterr().out
    assert dist_mnist.main(args + ["--checkpoint-dir", str(straight)]) == 0
    third = capsys.readouterr().out
    assert first.splitlines() == ["replica worker-0 starting",
                                  "step 0: loss=" + first.split("=")[1]
                                  .splitlines()[0],
                                  "injected crash at step 3"]
    assert "resumed from checkpoint at step 3" in second
    assert "injected crash" not in second and "done: loss" in second
    # The resumed run logs step 5 exactly as the uninterrupted one.
    last = [ln for ln in third.splitlines() if ln.startswith("step 5")]
    assert last and last[0] in second.splitlines()
    for (name, a), b in zip(_params(resumed, 6).items(),
                            _params(straight, 6).values()):
        assert torch.equal(a, b), name
    assert sorted(os.listdir(straight)) == ["4", "5", "6"]
    # Nothing left to do after the last step.
    assert dist_mnist.main(args + ["--checkpoint-dir", str(straight)]) == 0
    assert "done: no steps remaining after resume" in capsys.readouterr().out


def test_payload_refuses_multi_process_training(monkeypatch):
    """Multi-process training runs on the card, or on the CPU (gloo) only
    where --device cpu asks for it: with the operator's multi-process env
    and no card the payload raises before it serves or dials the store.
    Without TPUJOB_JAX_DISTRIBUTED=1 a replica trains alone and its rank is
    the env's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("TPUJOB_JAX_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_mnist.main(["--steps", "1"])
    monkeypatch.delenv("TPUJOB_JAX_DISTRIBUTED")
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    assert dist_mnist.process_rank() == 1
