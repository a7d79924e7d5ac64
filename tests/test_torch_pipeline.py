"""Port parity: the pipeline schedules (``tf_operator_tpu_torch/parallel/
pipeline.py``) and the Llama pipeline (``parallel/llama_pp.py``) in one
process, at pp = 1, against the serial step and the JAX package.

The stages across processes (pp 2 and 4, and (dp 2, pp 2)) run in the
4-process world of ``tests/test_torch_distributed.py``. Tolerances are
``tests/test_pipeline.py``'s: losses 1e-5, gradients atol 1e-5 and rtol
1e-4 (2e-5/2e-4 for the Llama's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.parallel import pipeline as jpp
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.parallel import llama_pp as tlpp
from tf_operator_tpu_torch.parallel import pipeline as tpp
from tf_operator_tpu_torch.train import trainer as ttr

pytestmark = pytest.mark.compute

HID, V = 16, 32
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def stage_fn(params, x):
    """The JAX suite's residual MLP stage: x + gelu(x @ w1) @ w2."""
    return x + torch.nn.functional.gelu(x @ params["w1"]) @ params["w2"]


def toy_model(seed):
    rng = np.random.default_rng(seed)
    mk = lambda *shape, scale: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"stage": {"w1": mk(HID, 4 * HID, scale=0.1),
                      "w2": mk(4 * HID, HID, scale=0.1)},
            "embed": {"table": mk(V, HID, scale=0.5)},
            "head": {"w": mk(HID, V, scale=0.5)},
            "tokens": rng.integers(0, V, 16), "labels": rng.integers(0, V, 16)}


def embed_fn(ep, tok):
    return ep["table"][tok]


def loss_fn(y, t, hp):
    logp = torch.log_softmax(y @ hp["w"], dim=-1)
    return -torch.gather(logp, -1, t[..., None].long()).mean()


def test_split_merge_roundtrip():
    x = torch.arange(24.0).reshape(8, 3)
    mb = tpp.split_microbatches(x, 4)
    assert mb.shape == (4, 2, 3)
    assert torch.equal(tpp.merge_microbatches(mb), x)
    with pytest.raises(ValueError):
        tpp.split_microbatches(torch.zeros(6, 4), 4)
    stacked = tpp.stack_stage_params([{"w": torch.ones(2)},
                                      {"w": torch.zeros(2)}])
    assert stacked["w"].shape == (2, 2)


@pytest.mark.parametrize("peak,budget", [
    (10**6, None), (10**6, 10**9), (10**9, 10**6), (10**6, 10**6),
    (None, 10**9), (None, None), (-1, 10**9)])
def test_select_schedule_policy_matches_jax(peak, budget):
    assert tpp.select_schedule(peak, budget) == jpp.select_schedule(peak,
                                                                   budget)


@pytest.mark.parametrize("stages,m", [(1, 4), (2, 4), (4, 4), (4, 8),
                                      (3, 2)])
def test_1f1b_tick_plan(stages, m):
    """Each stage forwards and backwards every microbatch once, at the JAX
    schedule's ticks; a backward follows its forward and the next stage's
    backward; the stash of stage inputs never holds more than 2·pp."""
    plans = [tpp.tick_plan(s, stages, m) for s in range(stages)]
    for s, plan in enumerate(plans):
        assert len(plan) == m + 2 * (stages - 1)
        fwd = {j: t for t, (j, _) in enumerate(plan) if j is not None}
        bwd = {j: t for t, (_, j) in enumerate(plan) if j is not None}
        assert fwd == {j: s + j for j in range(m)}
        assert bwd == {j: 2 * (stages - 1) - s + j for j in range(m)}
        for j in range(m):
            assert bwd[j] >= fwd[j]
            if s + 1 < stages:
                assert bwd[j] == bwd_next(plans[s + 1], j) + 1
            live = sum(1 for k in range(m) if fwd[k] <= fwd[j] < bwd[k] + 1)
            assert live <= 2 * stages
    # The last stage runs forward and backward of a microbatch together.
    assert all(f == b for f, b in plans[-1])


def bwd_next(plan, j):
    return next(t for t, (_, b) in enumerate(plan) if b == j)


def test_gpipe_1f1b_and_serial_step_agree_at_one_stage():
    """The LM composition (embedding, one stage, untied head) at pp = 1
    in one process: both schedules against serial autograd, and against
    the JAX 1F1B step on one device."""
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh

    toy = toy_model(31)
    t = lambda d: {n: torch.tensor(a) for n, a in d.items()}
    tokens, labels = (torch.tensor(toy[n]) for n in ("tokens", "labels"))
    got = {sched: fn(stage_fn, loss_fn, embed_fn, t(toy["stage"]),
                     t(toy["embed"]), t(toy["head"]), tokens, labels, None,
                     4)
           for sched, fn in (("gpipe", tpp.pipeline_lm_train_gpipe),
                             ("1f1b", tpp.pipeline_lm_train_sharded))}
    stage, embed, head = (
        {n: a.requires_grad_() for n, a in t(toy[k]).items()}
        for k in ("stage", "embed", "head"))
    serial = loss_fn(stage_fn(stage, embed_fn(embed, tokens)), labels, head)
    leaves = [*stage.values(), *embed.values(), *head.values()]
    serial_grads = torch.autograd.grad(serial, leaves)

    mesh = make_mesh(MeshConfig(pp=1), devices=jax.devices()[:1])
    jstage = jpp.stack_stage_params([jax.tree.map(jnp.asarray,
                                                  toy["stage"])])
    jloss, jsg, jeg, jhg = jpp.pipeline_lm_train_sharded(
        lambda p, x: x + jax.nn.gelu(x @ p["w1"]) @ p["w2"],
        lambda y, tt, hp: -jnp.take_along_axis(
            jax.nn.log_softmax(y @ hp["w"]), tt[..., None], axis=-1).mean(),
        lambda ep, tok: ep["table"][tok], jstage,
        jax.tree.map(jnp.asarray, toy["embed"]),
        jax.tree.map(jnp.asarray, toy["head"]), jnp.asarray(toy["tokens"]),
        jnp.asarray(toy["labels"]), mesh, num_microbatches=4)
    jax_grads = [np.asarray(jsg["w1"][0]), np.asarray(jsg["w2"][0]),
                 np.asarray(jeg["table"]), np.asarray(jhg["w"])]
    for sched, (loss, sg, eg, hg) in got.items():
        grads = [sg["w1"], sg["w2"], eg["table"], hg["w"]]
        np.testing.assert_allclose(float(loss), float(serial.detach()),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        for a, b, c in zip(grads, serial_grads, jax_grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=sched)
            np.testing.assert_allclose(a.numpy(), c, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=sched)


def test_trunk_schedules_and_forward_at_one_stage():
    """The trunk alone, 1F1B (pipeline_train_sharded) and GPipe, and
    pipeline_sharded's forward against the serial stage."""
    toy = toy_model(7)
    params = {n: torch.tensor(a) for n, a in toy["stage"].items()}
    x = torch.tensor(np.random.default_rng(8).standard_normal(
        (8, HID)).astype(np.float32))
    target = torch.tensor(np.random.default_rng(9).standard_normal(
        (8, HID)).astype(np.float32))
    mse = lambda y, t: ((y - t) ** 2).mean()
    out = tpp.pipeline_sharded(stage_fn, params, x, None, 4)
    np.testing.assert_allclose(out.numpy(), stage_fn(params, x).numpy(),
                               atol=1e-6, rtol=1e-6)
    leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
    want_loss = mse(stage_fn(leaves, x), target)
    want = torch.autograd.grad(want_loss, list(leaves.values()))
    gpipe_loss, gpipe_grads, _ = tpp.pipeline_train_gpipe(
        stage_fn, mse, params, tpp.split_microbatches(x, 4),
        tpp.split_microbatches(target, 4), tpp.Pipe())
    for loss, grads in (tpp.pipeline_train_sharded(stage_fn, mse, params, x,
                                                   target, None, 4),
                        (gpipe_loss, gpipe_grads)):
        np.testing.assert_allclose(float(loss), float(want_loss.detach()),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        for g, w in zip(grads.values(), want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL)


def tiny_pp_config():
    return dataclasses.replace(tllama.llama_tiny(64, 32), n_layers=4,
                               dtype=torch.float32, attention_impl="xla")


def test_llama_stage_is_the_models_slice():
    """A stage drawn from the seed holds the whole model's layers of its
    range, under the same names; split and merge round-trip the layers."""
    cfg = tiny_pp_config()
    whole = tllama.Llama(cfg, device="cpu").state_dict()
    for stage in range(2):
        got = tlpp.LlamaStage(cfg, stage, 2, device="cpu").state_dict()
        layers = {n.split(".")[1] for n in got if n.startswith("layers.")}
        assert layers == {str(i) for i in range(2 * stage, 2 * stage + 2)}
        for name, value in got.items():
            assert torch.equal(value, whole[name]), name
    model = tllama.Llama(cfg, device="cpu")
    stages = tlpp.split_stage_params(model.layers, 2)
    assert [list(s) for s in stages] == [["0", "1"], ["2", "3"]]
    merged = tlpp.merge_stage_params(stages)
    assert all(a is b for a, b in zip(merged, model.layers))
    with pytest.raises(ValueError):
        tlpp.split_stage_params(model.layers, 3)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_llama_pp_matches_serial_model_and_jax(schedule):
    """The Llama through the pipeline at pp = 1 against the plain model's
    loss and gradients, and against the JAX llama_pp on converted weights
    (tests/test_pipeline.py's Llama tolerances, 2e-5/2e-4)."""
    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu.parallel import llama_pp as jlpp
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.models.convert import (
        llama_params_from_flax,
        llama_stage_params_from_flax,
        llama_stage_params_to_flax,
    )

    cfg = tiny_pp_config()
    jcfg = dataclasses.replace(jllama.llama_tiny(64, 32), n_layers=4,
                               dtype=jnp.float32, attention_impl="xla")
    rng = jax.random.PRNGKey(41)
    tokens = jax.random.randint(jax.random.fold_in(rng, 1), (8, 17), 0, 64)
    params = jax.tree.map(np.asarray,
                          jlpp.init_llama_params(jcfg, rng, tokens[:, :-1]))
    mesh = make_mesh(MeshConfig(pp=1), devices=jax.devices()[:1])
    jloss, jgrads = jax.jit(lambda p, t: jlpp.llama_pp_loss_and_grads(
        jcfg, p, t, mesh, num_microbatches=4, schedule=schedule))(params,
                                                                   tokens)
    want = llama_params_from_flax(jax.tree.map(np.asarray, jgrads), cfg)
    state = llama_params_from_flax(params, cfg)
    staged = jlpp.split_stage_params(params["blocks"], 1)
    assert all(torch.equal(a, b) for a, b in zip(
        llama_stage_params_from_flax({**params, "blocks": staged}, cfg, 0,
                                     1).values(), state.values()))
    back = llama_stage_params_to_flax([state], cfg)
    jax.tree.map(np.testing.assert_array_equal, back["blocks"], staged)

    stage = tlpp.LlamaStage(cfg, device="cpu")
    stage.load_state_dict(state)
    toks = torch.tensor(np.asarray(tokens))
    loss, grads = tlpp.llama_pp_loss_and_grads(stage, toks, None, 4,
                                               schedule=schedule)
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(state)
    serial = ttr.lm_loss(model, {"inputs": toks})
    serial.backward()
    np.testing.assert_allclose(float(loss), float(serial), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert set(grads) == set(want) == {n for n, _ in
                                       model.named_parameters()}
    for name, p in model.named_parameters():
        for other in (p.grad, want[name]):
            np.testing.assert_allclose(grads[name].numpy(), other.numpy(),
                                       atol=2e-5, rtol=2e-4, err_msg=name)


def test_pipeline_trainer_schedules_on_the_cpu():
    """auto keeps GPipe where the CPU reports no budget; a given budget
    with no peak to read fails safe to 1F1B; a forced schedule is kept;
    both train the same model the same way."""
    cfg = tiny_pp_config()
    tokens = np.random.default_rng(5).integers(0, 64, (8, 17))
    losses = {}
    for schedule, budget, want in (("auto", None, "gpipe"),
                                   ("auto", 1 << 40, "1f1b"),
                                   ("1f1b", None, "1f1b")):
        trainer = tlpp.LlamaPipelineTrainer(
            cfg, None, ttr.adam(3e-3), num_microbatches=4,
            schedule=schedule, memory_budget_bytes=budget, device="cpu")
        state = trainer.init()
        step = trainer.make_train_step(state, sample_tokens=tokens)
        assert trainer.resolved_schedule == want
        run = []
        for _ in range(4):
            state, metrics = step(state, tokens)
            run.append(float(metrics["loss"]))
        assert run[-1] < run[0], run
        assert state.step == 4
        losses[(schedule, budget)] = run
    runs = list(losses.values())
    for run in runs[1:]:
        np.testing.assert_allclose(run, runs[0], atol=LOSS_TOL, rtol=LOSS_TOL)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        tlpp.LlamaPipelineTrainer(cfg, None, ttr.adam(3e-3), 4,
                                  schedule="zb", device="cpu")
