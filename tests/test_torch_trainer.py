"""Port parity: the port's loss, optimizer and trainer against the JAX ones.

The loss against ``cross_entropy_loss``; the schedule, the global-norm
clip and both AdamW variants against optax, one update on the same params
and grads (1e-6); a 3-step loss trajectory against the JAX ``Trainer`` on
a one-device mesh (1e-4); the step loop and the payload on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
from tf_operator_tpu.parallel.sharding import LLAMA_RULES
from tf_operator_tpu.train import trainer as jtr
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.models.convert import llama_params_from_flax
from tf_operator_tpu_torch.train import trainer as ttr

pytestmark = pytest.mark.compute


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 16, 32)).astype(np.float32) * 3
    targets = rng.integers(0, 32, (2, 16))
    mask = (rng.random((2, 16)) > 0.4) if masked else None
    want = jtr.cross_entropy_loss(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask))
    got = ttr.cross_entropy_loss(
        torch.tensor(logits).bfloat16(), torch.tensor(targets),
        None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_all_masked_loss_is_zero_not_nan():
    got = ttr.cross_entropy_loss(torch.zeros(1, 4, 8),
                                 torch.zeros(1, 4, dtype=torch.long),
                                 torch.zeros(1, 4))
    assert got.item() == 0.0


def test_warmup_cosine_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100,
                                              end_value=1e-5)
    got = ttr.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100,
                                           end_value=1e-5)
    for count in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(count))
    assert got(0) == 0.0


def _params_and_grads(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(8, 4), (4,), (3, 5)]
    return ([rng.standard_normal(s).astype(np.float32) for s in shapes],
            [rng.standard_normal(s).astype(np.float32) for s in shapes])


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    _, grads = _params_and_grads()
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.tensor(g) for g in grads]
    norm = ttr.clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(
        [jnp.asarray(g) for g in grads])), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def _run_optax(tx, params, grads_seq):
    params = [jnp.asarray(p) for p in params]
    state = tx.init(params)
    for grads in grads_seq:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _run_port(opt, params, grads_seq):
    tparams = [nn.Parameter(torch.tensor(p)) for p in params]
    torch_opt = opt.make(tparams)
    for count, grads in enumerate(grads_seq):
        for p, g in zip(tparams, grads):
            p.grad = torch.tensor(g)
        opt.apply(torch_opt, count)
    return [p.detach().numpy() for p in tparams]


@pytest.mark.parametrize("variant", ["adamw", "default"])
def test_optimizer_matches_optax(variant):
    """One update (adamw); three for default_optimizer, whose first
    update runs at schedule(0) = 0 and must leave the params unchanged."""
    params, grads = _params_and_grads(1)
    if variant == "adamw":
        tx, opt, steps = optax.adamw(3e-3), ttr.adamw(3e-3), 1
    else:
        tx = jtr.default_optimizer(3e-3, warmup_steps=2, total_steps=10,
                                   max_grad_norm=0.5)
        opt = ttr.default_optimizer(3e-3, warmup_steps=2, total_steps=10,
                                    max_grad_norm=0.5)
        steps = 3
    grads_seq = [[g * (i + 1) for g in grads] for i in range(steps)]
    want = _run_optax(tx, params, grads_seq)
    got = _run_port(opt, params, grads_seq)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    if variant == "default":
        first = _run_port(opt, params, grads_seq[:1])
        for g, p in zip(first, params):
            np.testing.assert_array_equal(g, p)


def test_three_step_trajectory_matches_jax_trainer():
    fields = dict(vocab_size=512, hidden=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=64,
                  rope_theta=10000.0, remat=False)
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **fields)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **fields)
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jtrainer = jtr.Trainer(model=jllama.Llama(jcfg),
                           param_axes_fn=jllama.param_logical_axes,
                           rules=LLAMA_RULES, mesh=mesh,
                           optimizer=optax.adamw(3e-4))
    sample = {"inputs": jnp.zeros((2, 33), jnp.int32)}
    jstate, shardings = jtrainer.init(jax.random.PRNGKey(0), sample)
    jstep = jtrainer.make_train_step(shardings, sample)

    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    ttrainer = ttr.Trainer(model=model, optimizer=ttr.adamw(3e-4),
                           device="cpu")
    tstate = ttrainer.init()
    tstep = ttrainer.make_train_step()

    data = np.random.default_rng(0)
    for i in range(3):
        toks = data.integers(0, 512, (2, 33))
        jstate, jm = jstep(jstate, {"inputs": jnp.asarray(toks, jnp.int32)})
        tstate, tm = tstep(tstate, {"inputs": toks})
        assert tm["step"] == int(jm["step"]) == i
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), atol=1e-4,
                                   rtol=1e-4)
    assert tstate.step == 3


def test_run_train_steps_calls_hook_and_metrics():
    calls, seen = [], []

    class Hook:
        def after_step(self, step, state):
            calls.append((step, state["n"]))

    def step_fn(state, batch):
        return {"n": state["n"] + batch}, {"loss": float(batch)}

    state = ttr.run_train_steps(step_fn, {"n": 0}, iter(range(1, 10)), 4,
                                start_step=0, ckpt_hook=Hook(),
                                on_metrics=lambda s, m: seen.append(s))
    assert calls == [(1, 1), (2, 3), (3, 6), (4, 10)]
    assert seen == [1, 2, 3, 4] and state == {"n": 10}
    ttr.run_train_steps(step_fn, state, iter([1]), 1, start_step=7,
                        ckpt_hook=Hook())
    assert calls[-1][0] == 8


def test_train_llama_payload_on_cpu(capsys):
    from tf_operator_tpu_torch.train import train_llama

    assert train_llama.main(["--size", "tiny", "--steps", "2",
                             "--batch-size", "2", "--seq-len", "32",
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 1: loss=" in out and "llama training OK" in out
