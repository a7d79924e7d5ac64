"""Port parity, multi-process: the sharded port in a 4-process gloo world
against the JAX package on 4 of its virtual CPU devices.

One world of 4 CPU processes (``_worker`` below, joined through
``parallel/distributed.py`` from the env the operator renders) runs every
case once and rank 0 writes the results; the tests compare them with the
JAX side, which runs in the test process on ``jax.devices()[:4]``:

- ``llama_tiny`` (f32) from shared weights (``convert.py``), 3 AdamW steps
  at ``MeshConfig(fsdp=2, tp=2)``, ``MeshConfig(dp=2, fsdp=2)`` and
  ``MeshConfig(dcn=2, tp=2)``, and with a mask that falls unevenly on the
  slices at ``MeshConfig(dp=2, fsdp=2)``, against the JAX ``Trainer`` on the
  same mesh: losses, grad norms and every gathered parameter within 5e-4
  (``tests/test_torch_llama.py``'s grads tolerance);
- ``flash_attention_sharded`` at fsdp=2, tp=2 with GQA (the plain versions
  on the CPU) against the reference, as ``tests/test_flash_attention.py``'s
  sharded case (2e-5), and its gradients within 2e-4;
- a step at tp=4, which does not divide the 2 KV heads, raises;
- tp=2 prefill and decode logits against the unsharded JAX model within
  ``tests/test_llama_decode.py``'s ATOL (1e-5);
- a DCP save at (fsdp=2, tp=2) restored at (dp=4) and, after the world is
  gone, at world 1: parameters and AdamW moments bit-equal;
- ``mixtral_tiny`` (f32), 3 steps of ``make_moe_lm_loss`` under
  ``MOE_RULES`` at ``MeshConfig(dp=2, ep=2)`` with each dispatch path and
  at ``MeshConfig(fsdp=2, tp=2)``, against the JAX ``Trainer`` on the same
  mesh: losses, grad norms and gathered parameters within 5e-4 (the
  default capacity drops there, so routing over the global batch is held
  to JAX's);
- tp=2 Mixtral prefill and decode logits (``MeshConfig(dp=2, tp=2)``)
  against the unsharded drop-free JAX forward within 1e-5, as the Llama
  case (tighter than ``tests/test_mixtral_decode.py``'s 2e-5);
- a 2-rank ``dist_mnist`` step (a mesh over ranks 0 and 1) against the
  1-rank step on the global batch within 1e-5;
- a save whose write fails on one rank raises on every rank and commits
  nothing.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.compute

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 3
LR = 3e-4
BATCH, SEQ = 4, 32
# FSDP + TP; HSDP (2 replicas of 2 shards); replicas over dcn x dp
# flattened, with TP; HSDP on a masked batch (the MASKED cases).
TRAIN_MESHES = {"fsdp2_tp2": dict(fsdp=2, tp=2),
                "dp2_fsdp2": dict(dp=2, fsdp=2),
                "dcn2_tp2": dict(dcn=2, tp=2),
                "dp2_fsdp2_masked": dict(dp=2, fsdp=2)}
MASKED = ("dp2_fsdp2_masked",)
# Mixtral under MOE_RULES: experts over ep (each dispatch path), and the
# experts' mlp dim over tp with FSDP.
MOE_MESHES = {"moe_dp2_ep2_einsum": (dict(dp=2, ep=2), "einsum"),
              "moe_dp2_ep2_gather": (dict(dp=2, ep=2), "gather"),
              "moe_fsdp2_tp2": (dict(fsdp=2, tp=2), "einsum")}
TRAIN_TOL = 5e-4
FLASH_TOL, FLASH_GRAD_TOL = 2e-5, 2e-4
DECODE_ATOL = 1e-5
DECODE_SPLIT = 5
MNIST_TOL = 1e-5
MNIST_BATCH = 16


def tiny_fields():
    return dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4,
                n_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=64,
                rope_theta=10000.0, remat=False)


def moe_fields():
    return dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4,
                n_kv_heads=2, head_dim=16, mlp_dim=128, n_experts=4,
                experts_per_token=2, max_seq_len=64, rope_theta=10000.0,
                remat=False)


def flash_inputs():
    """The sharded flash case's q/k/v ([4, 128, 4|2, 128]) and
    cotangent."""
    rng = np.random.default_rng(5)
    b, s, h, h_kv, d = 4, 128, 4, 2, 128
    mk = lambda *shape: (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return {"q": mk(b, s, h, d), "k": mk(b, s, h_kv, d),
            "v": mk(b, s, h_kv, d), "do": mk(b, s, h, d)}


def train_batches(tokens, masks, name):
    """The training batches of the case ``name``."""
    if name in MASKED:
        return [{"inputs": t, "mask": m} for t, m in zip(tokens, masks)]
    return [{"inputs": t} for t in tokens]


# ---------------------------------------------------------------------------
# The worker: one rank of the gloo world (no JAX import)
# ---------------------------------------------------------------------------

def _gathered(model):
    return {n: p.full_tensor().detach().clone()
            for n, p in model.named_parameters()}


def _gathered_moments(opt):
    return {(i, name): t.full_tensor().clone()
            for i, per_param in enumerate(opt.state.values())
            for name, t in per_param.items() if name != "step"}


def _train_case(inputs, name, ckpt_dir=None):
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer

    cfg = tllama.LlamaConfig(dtype=torch.float32, **tiny_fields())
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(inputs["llama"])
    mesh = make_mesh(MeshConfig(**TRAIN_MESHES[name]), device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adamw(LR), device="cpu",
                          mesh=mesh, rules=LLAMA_RULES,
                          param_axes_fn=tllama.param_logical_axes)
    state = trainer.init()
    step = trainer.make_train_step()
    losses, norms = [], []
    for batch in train_batches(inputs["tokens"], inputs["masks"], name):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out = {"losses": losses, "grad_norms": norms,
           "params": _gathered(model)}
    if ckpt_dir is not None:
        ckpt = Checkpointer(ckpt_dir)
        ckpt.save(state.step, state)
        ckpt.close()
        out["moments"] = _gathered_moments(state.opt_state)
    return out


def _moe_train_case(inputs, name):
    from tf_operator_tpu_torch.models import mixtral as tmix
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import MOE_RULES
    from tf_operator_tpu_torch.train import trainer as ttr

    fields, dispatch = MOE_MESHES[name]
    cfg = tmix.MixtralConfig(dtype=torch.float32, dispatch=dispatch,
                             **moe_fields())
    model = tmix.Mixtral(cfg, device="cpu")
    model.load_state_dict(inputs["mixtral"])
    mesh = make_mesh(MeshConfig(**fields), device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adamw(LR), device="cpu",
                          loss_fn=tmix.make_moe_lm_loss(cfg.aux_loss_weight),
                          mesh=mesh, rules=MOE_RULES,
                          param_axes_fn=tmix.param_logical_axes)
    state = trainer.init()
    step = trainer.make_train_step()
    losses, norms = [], []
    for tokens in inputs["tokens"]:
        state, metrics = step(state, {"inputs": tokens})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    expert = model.layers[0].moe.w_gate
    return {"losses": losses, "grad_norms": norms,
            "params": _gathered(model),
            "expert_local_shape": tuple(expert.to_local().shape)}


def _moe_decode_case(inputs):
    from tf_operator_tpu_torch.models import mixtral as tmix
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        MOE_RULES,
        shard_model,
    )

    base = tmix.mixtral_tiny(64, 32)
    cfg = dataclasses.replace(base, dtype=torch.float32, decode=True,
                              capacity_factor=float(base.n_experts))
    model = tmix.Mixtral(cfg, device="cpu")
    model.load_state_dict(inputs["moe_decode_params"])
    mesh = make_mesh(MeshConfig(dp=2, tp=2), device="cpu")
    shard_model(model, mesh, MOE_RULES, tmix.param_logical_axes)
    toks = torch.as_tensor(inputs["moe_decode_tokens"])
    b, s = toks.shape
    cache = tmix.init_cache(model, b)
    positions = torch.arange(DECODE_SPLIT).expand(b, DECODE_SPLIT)
    logits, cache = tmix.prefill(model, cache, toks[:, :DECODE_SPLIT],
                                 positions)
    steps = [logits]
    for t in range(DECODE_SPLIT, s):
        logits, cache = tmix.decode_step(model, cache, toks[:, t:t + 1],
                                         torch.full((b, 1), t))
        steps.append(logits)
    return {"logits": torch.cat(steps, dim=1),
            "cache_kv_heads": cache["k"].shape[3]}


def _restore_case(inputs, ckpt_dir, seed):
    """A state of another seed on a dp=4 mesh, restored from the save."""
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer

    cfg = tllama.LlamaConfig(dtype=torch.float32, **tiny_fields())
    model = tllama.Llama(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    mesh = make_mesh(MeshConfig(dp=4), device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adamw(LR), device="cpu",
                          mesh=mesh, rules=LLAMA_RULES,
                          param_axes_fn=tllama.param_logical_axes)
    state = trainer.init()
    ckpt = Checkpointer(ckpt_dir)
    ckpt.restore(state)
    ckpt.close()
    return {"step": state.step, "params": _gathered(model),
            "moments": _gathered_moments(state.opt_state)}


def _flash_case(inputs):
    from tf_operator_tpu_torch.ops import flash_attention as tfa
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device="cpu")
    q, k, v = (torch.tensor(inputs["flash"][n]).requires_grad_()
               for n in ("q", "k", "v"))
    out = tfa.flash_attention_sharded(q, k, v, mesh, causal=True)
    local_heads = out.to_local().shape[2]
    full = out.full_tensor()
    (full * torch.tensor(inputs["flash"]["do"])).sum().backward()
    return {"out": full.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "local_heads": local_heads}


def _indivisible_heads_case(inputs):
    """A step at tp=4 of a model with 2 KV heads: the error it raises."""
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train import trainer as ttr

    cfg = tllama.LlamaConfig(dtype=torch.float32, **tiny_fields())
    mesh = make_mesh(MeshConfig(tp=4), device="cpu")
    trainer = ttr.Trainer(model=tllama.Llama(cfg, device="cpu"),
                          optimizer=ttr.adamw(LR), device="cpu", mesh=mesh,
                          rules=LLAMA_RULES,
                          param_axes_fn=tllama.param_logical_axes)
    try:
        trainer.make_train_step()(trainer.init(),
                                  {"inputs": inputs["tokens"][0]})
    except ValueError as err:
        return str(err)
    return None


def _decode_case(inputs):
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        LLAMA_RULES,
        shard_model,
    )

    cfg = dataclasses.replace(tllama.llama_tiny(64, 32), dtype=torch.float32,
                              decode=True)
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(inputs["decode_params"])
    mesh = make_mesh(MeshConfig(dp=2, tp=2), device="cpu")
    shard_model(model, mesh, LLAMA_RULES, tllama.param_logical_axes)
    toks = torch.as_tensor(inputs["decode_tokens"])
    b, s = toks.shape
    cache = tllama.init_cache(model, b)
    positions = torch.arange(DECODE_SPLIT).expand(b, DECODE_SPLIT)
    logits, cache = tllama.prefill(model, cache, toks[:, :DECODE_SPLIT],
                                   positions)
    steps = [logits]
    for t in range(DECODE_SPLIT, s):
        logits, cache = tllama.decode_step(model, cache, toks[:, t:t + 1],
                                           torch.full((b, 1), t))
        steps.append(logits)
    return {"logits": torch.cat(steps, dim=1),
            "cache_kv_heads": cache["k"].shape[3]}


def _mnist_case():
    """One payload step on a mesh over ranks 0 and 1 (every rank builds
    the mesh; ranks 2 and 3 then wait)."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.mnist import (
        MnistCNN,
        param_logical_axes,
    )
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        data_index,
        make_mesh,
    )
    from tf_operator_tpu_torch.parallel.sharding import CNN_RULES
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.data import multihost_batch
    from tf_operator_tpu_torch.train.dist_mnist import local_shard

    mesh = make_mesh(MeshConfig(dp=-1), devices=[0, 1], device="cpu")
    if dist.get_rank() >= 2:
        return None
    model = MnistCNN(device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adam(1e-3),
                          loss_fn=ttr.classification_loss, device="cpu",
                          mesh=mesh, rules=CNN_RULES,
                          param_axes_fn=param_logical_axes)
    state = trainer.init()
    batch = multihost_batch(local_shard(1, 2, data_index(mesh), MNIST_BATCH),
                            mesh)
    state, metrics = trainer.make_train_step()(state, batch)
    return {"loss": float(metrics["loss"]), "params": _gathered(model)}


def _failed_write_case(directory):
    """Rank 1's write fails after the save's collectives: every rank's
    wait() must raise and no step be committed."""
    import concurrent.futures

    import torch.distributed as dist

    from tf_operator_tpu_torch.train import checkpoint as tckpt

    ckpt = tckpt.Checkpointer(directory)
    real = tckpt.dcp.async_save

    def failing(*args, **kwargs):
        real(*args, **kwargs).result()
        out = concurrent.futures.Future()
        out.set_exception(OSError("disk full"))
        return out

    if dist.get_rank() == 1:
        tckpt.dcp.async_save = failing
    try:
        ckpt.save(1, {"w": torch.arange(8.0) + dist.get_rank()})
        try:
            ckpt.wait()
            raised = ""
        except Exception as err:
            raised = str(err)
    finally:
        tckpt.dcp.async_save = real
    errors = [None] * dist.get_world_size()
    dist.all_gather_object(errors, raised)
    dist.barrier()
    return {"errors": errors, "latest_step": ckpt.latest_step(),
            "entries": sorted(os.listdir(directory))}


def _worker(work_dir: str) -> None:
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
        process_group_scope,
    )

    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(work_dir, "inputs.pt"),
                        weights_only=False)
    ckpt_dir = os.path.join(work_dir, "ckpt")
    results = {}
    with process_group_scope():
        rank = maybe_init_distributed("cpu")
        assert dist.get_world_size() == WORLD
        for name in TRAIN_MESHES:
            results[name] = _train_case(
                inputs, name, ckpt_dir if name == "fsdp2_tp2" else None)
        for name in MOE_MESHES:
            results[name] = _moe_train_case(inputs, name)
        results["moe_decode"] = _moe_decode_case(inputs)
        results["restore_dp4"] = _restore_case(inputs, ckpt_dir, seed=1)
        results["flash"] = _flash_case(inputs)
        results["decode"] = _decode_case(inputs)
        results["mnist"] = _mnist_case()
        results["failed_write"] = _failed_write_case(
            os.path.join(work_dir, "failed"))
        results["indivisible_heads"] = _indivisible_heads_case(inputs)
    if rank == 0:
        results["restore_world1"] = _restore_world1(ckpt_dir)
        torch.save(results, os.path.join(work_dir, "results.pt"))


def _restore_world1(ckpt_dir):
    """With no process group: an unsharded state restored from the
    sharded save."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer

    assert not dist.is_initialized()
    cfg = tllama.LlamaConfig(dtype=torch.float32, **tiny_fields())
    model = tllama.Llama(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(2))
    state = ttr.Trainer(model=model, optimizer=ttr.adamw(LR),
                        device="cpu").init()
    ckpt = Checkpointer(ckpt_dir)
    ckpt.restore(state)
    ckpt.close()
    return {"step": state.step,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "moments": {(i, name): t.clone() for i, per_param
                        in enumerate(state.opt_state.state.values())
                        for name, t in per_param.items() if name != "step"}}


# ---------------------------------------------------------------------------
# The test process: the JAX side, and one run of the world
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_training(tokens, masks, init_params):
    """3 JAX Trainer steps per mesh, each from ``init_params`` (what the
    trainer's own init makes from PRNGKey(0))."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu.train import trainer as jtr

    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **tiny_fields())
    out = {}
    for name, fields in TRAIN_MESHES.items():
        mesh = make_mesh(MeshConfig(**fields), devices=jax.devices()[:WORLD])
        trainer = jtr.Trainer(model=jllama.Llama(jcfg),
                              param_axes_fn=jllama.param_logical_axes,
                              rules=LLAMA_RULES, mesh=mesh,
                              optimizer=optax.adamw(LR))
        batches = train_batches(tokens, masks, name)
        sample = jax.tree.map(jnp.zeros_like, batches[0])
        state, shardings = trainer.init(jax.random.PRNGKey(0), sample)
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, state.params), init_params)
        step = trainer.make_train_step(shardings, sample)
        losses, norms = [], []
        for batch in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "grad_norms": norms,
                     "params": jax.tree.map(np.asarray, state.params)}
    return out


def _jax_moe_training(tokens, init_params):
    """3 JAX Trainer steps of make_moe_lm_loss per MoE mesh, each from
    ``init_params``."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import mixtral as jmix
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu.parallel.sharding import MOE_RULES
    from tf_operator_tpu.train import trainer as jtr

    out = {}
    for name, (fields, dispatch) in MOE_MESHES.items():
        cfg = jmix.MixtralConfig(dtype=jnp.float32, dispatch=dispatch,
                                 **moe_fields())
        mesh = make_mesh(MeshConfig(**fields), devices=jax.devices()[:WORLD])
        trainer = jtr.Trainer(model=jmix.Mixtral(cfg),
                              param_axes_fn=jmix.param_logical_axes,
                              rules=MOE_RULES, mesh=mesh,
                              optimizer=optax.adamw(LR),
                              loss_fn=jmix.make_moe_lm_loss(
                                  cfg.aux_loss_weight))
        sample = {"inputs": jnp.zeros_like(jnp.asarray(tokens[0]))}
        state, shardings = trainer.init(jax.random.PRNGKey(0), sample)
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, state.params), init_params)
        step = trainer.make_train_step(shardings, sample)
        losses, norms = [], []
        for t in tokens:
            state, m = step(state, {"inputs": jnp.asarray(t)})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "grad_norms": norms,
                     "params": jax.tree.map(np.asarray, state.params)}
    return out


def _start_world(work):
    """Spawn the 4 ranks on ``work/inputs.pt``; returns (process, log)
    pairs."""
    port = _free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_distributed as t; t._worker({!r})").format(
                REPO, os.path.join(REPO, "tests"), str(work))
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, TPUJOB_JAX_DISTRIBUTED="1",
                   JAX_NUM_PROCESSES=str(WORLD), JAX_PROCESS_ID=str(rank),
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   OMP_NUM_THREADS="1")
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       cwd=REPO, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _join_world(work, procs):
    try:
        rcs = [p.wait(timeout=240) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            log.close()
    if any(rcs):
        logs = "".join((work / f"rank{r}.log").read_text()[-3000:]
                       for r in range(WORLD))
        pytest.fail(f"worker exit codes {rcs}:\n{logs}")
    return torch.load(work / "results.pt", weights_only=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results and the JAX side's; the JAX side runs while
    the world does."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu.models import mixtral as jmix
    from tf_operator_tpu.ops.layers import attention, repeat_kv
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.models import mixtral as tmix
    from tf_operator_tpu_torch.models.convert import (
        llama_params_from_flax,
        mixtral_params_from_flax,
    )

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} devices (conftest forces 8)")
    work = tmp_path_factory.mktemp("world")
    data = np.random.default_rng(0)
    tokens = [data.integers(0, tiny_fields()["vocab_size"],
                            (BATCH, SEQ + 1)) for _ in range(STEPS)]
    # Each row keeps a prefix of its own length: the slices count unevenly.
    masks = [(np.arange(SEQ) < data.integers(1, SEQ + 1, (BATCH, 1))
              ).astype(np.float32) for _ in range(STEPS)]
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **tiny_fields())
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **tiny_fields())
    init_params = jax.tree.map(np.asarray, jllama.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, SEQ + 1), jnp.int32))
        ["params"])
    # Decode: the JAX suite's setup (llama_tiny(64, 32), f32, seed 0).
    dcfg = dataclasses.replace(jllama.llama_tiny(vocab_size=64,
                                                 max_seq_len=32),
                               dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    dtoks = jax.random.randint(rng, (2, 12), 0, dcfg.vocab_size)
    dmodel = jllama.Llama(dcfg)
    dparams = jax.tree.map(np.asarray, dmodel.init(rng, dtoks)["params"])
    tdcfg = dataclasses.replace(tllama.llama_tiny(64, 32),
                                dtype=torch.float32)
    # Mixtral: the trainer's init params, and the drop-free decode setup
    # of tests/test_mixtral_decode.py.
    jmcfg = jmix.MixtralConfig(dtype=jnp.float32, **moe_fields())
    tmcfg = tmix.MixtralConfig(dtype=torch.float32, **moe_fields())
    moe_params = jax.tree.map(np.asarray, jmix.Mixtral(jmcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, SEQ + 1), jnp.int32))
        ["params"])
    mbase = jmix.mixtral_tiny(vocab_size=64, max_seq_len=32)
    mdcfg = dataclasses.replace(mbase, dtype=jnp.float32,
                                capacity_factor=float(mbase.n_experts))
    mtoks = jax.random.randint(rng, (2, 12), 0, mdcfg.vocab_size)
    mdmodel = jmix.Mixtral(mdcfg)
    mdparams = jax.tree.map(np.asarray, mdmodel.init(rng, mtoks)["params"])
    flash = flash_inputs()
    torch.save({"llama": llama_params_from_flax(init_params, tcfg),
                "tokens": tokens, "masks": masks, "flash": flash,
                "decode_params": llama_params_from_flax(dparams, tdcfg),
                "decode_tokens": np.asarray(dtoks),
                "mixtral": mixtral_params_from_flax(moe_params, tmcfg),
                "moe_decode_params": mixtral_params_from_flax(
                    mdparams, tmix.mixtral_tiny(64, 32)),
                "moe_decode_tokens": np.asarray(mtoks)},
               work / "inputs.pt")
    procs = _start_world(work)
    try:
        jax_train = _jax_training(tokens, masks, init_params)
        jax_moe = _jax_moe_training(tokens, moe_params)
        dfull = np.asarray(dmodel.apply({"params": dparams}, dtoks))
        mdfull = np.asarray(mdmodel.apply({"params": mdparams}, mtoks)[0])
        f = {n: jnp.asarray(a) for n, a in flash.items()}
        group = f["q"].shape[2] // f["k"].shape[2]

        def ref_loss(q, k, v):
            out = attention(q, repeat_kv(k, group), repeat_kv(v, group),
                            causal=True)
            return (out * f["do"]).sum(), out

        (_, ref), grads = jax.value_and_grad(
            ref_loss, argnums=(0, 1, 2), has_aux=True)(f["q"], f["k"],
                                                       f["v"])
    finally:
        results = _join_world(work, procs)
    jax_side = {"train": jax_train, "init_params": init_params,
                "flash": {"out": np.asarray(ref),
                          "dq": np.asarray(grads[0]),
                          "dk": np.asarray(grads[1]),
                          "dv": np.asarray(grads[2])},
                "decode_full": dfull, "tcfg": tcfg, "moe_train": jax_moe,
                "moe_init_params": moe_params, "tmcfg": tmcfg,
                "moe_decode_full": mdfull}
    return results, jax_side


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_sharded_steps_match_jax_trainer(world, mesh_name):
    from tf_operator_tpu_torch.models.convert import llama_params_from_flax

    results, jax_side = world
    got, want = results[mesh_name], jax_side["train"][mesh_name]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    want_params = llama_params_from_flax(want["params"], jax_side["tcfg"])
    assert set(got["params"]) == set(want_params)
    start = llama_params_from_flax(jax_side["init_params"],
                                   jax_side["tcfg"])
    for name, param in got["params"].items():
        np.testing.assert_allclose(param.numpy(), want_params[name].numpy(),
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=name)
        # The steps moved every parameter.
        assert not torch.equal(param, start[name]), name


@pytest.mark.parametrize("mesh_name", list(MOE_MESHES))
def test_sharded_moe_steps_match_jax_trainer(world, mesh_name):
    from tf_operator_tpu_torch.models.convert import mixtral_params_from_flax

    results, jax_side = world
    got, want = results[mesh_name], jax_side["moe_train"][mesh_name]
    fields, _ = MOE_MESHES[mesh_name]
    # Each rank held E/ep experts and mlp/tp columns (FSDP2 splits dim 0
    # further over fsdp).
    e, h, m = (moe_fields()[k] for k in ("n_experts", "hidden", "mlp_dim"))
    assert got["expert_local_shape"] == (
        e // fields.get("ep", 1) // fields.get("fsdp", 1), h,
        m // fields.get("tp", 1))
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    tmcfg = jax_side["tmcfg"]
    want_params = mixtral_params_from_flax(want["params"], tmcfg)
    start = mixtral_params_from_flax(jax_side["moe_init_params"], tmcfg)
    assert set(got["params"]) == set(want_params)
    for name, param in got["params"].items():
        np.testing.assert_allclose(param.numpy(), want_params[name].numpy(),
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=name)
        assert not torch.equal(param, start[name]), name


def test_tp2_sharded_moe_decode_matches_unsharded(world):
    results, jax_side = world
    got = results["moe_decode"]
    assert got["cache_kv_heads"] == 1
    np.testing.assert_allclose(got["logits"].numpy(),
                               jax_side["moe_decode_full"], atol=DECODE_ATOL)


def test_sharded_flash_gqa_matches_reference(world):
    results, jax_side = world
    got, want = results["flash"], jax_side["flash"]
    # Each rank held 2 of the 4 query heads (tp=2).
    assert got["local_heads"] == 2
    np.testing.assert_allclose(got["out"].numpy(), want["out"],
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   atol=FLASH_GRAD_TOL, rtol=FLASH_GRAD_TOL,
                                   err_msg=name)


def test_tp_indivisible_kv_heads_raises(world):
    """2 KV heads over tp=4: the JAX model falls back to the reference
    attention on the global heads; the port's, which works on local heads,
    raises."""
    results, _ = world
    assert "both head counts must divide tp" in (
        results["indivisible_heads"] or ""), results["indivisible_heads"]


def test_tp2_sharded_decode_matches_unsharded(world):
    results, jax_side = world
    got = results["decode"]
    # The cache holds this rank's KV heads: 2 // tp.
    assert got["cache_kv_heads"] == 1
    np.testing.assert_allclose(got["logits"].numpy(),
                               jax_side["decode_full"], atol=DECODE_ATOL)


@pytest.mark.parametrize("where", ["restore_dp4", "restore_world1"])
def test_sharded_checkpoint_restores_bit_equal(world, where):
    """Saved at (fsdp=2, tp=2) after 3 steps; restored into a state of
    another seed on another layout."""
    results, _ = world
    saved, got = results["fsdp2_tp2"], results[where]
    assert got["step"] == STEPS
    assert set(got["params"]) == set(saved["params"])
    for name, param in saved["params"].items():
        assert torch.equal(got["params"][name], param), name
    assert set(got["moments"]) == set(saved["moments"])
    for key, moment in saved["moments"].items():
        assert torch.equal(got["moments"][key], moment), key


def test_two_rank_mnist_step_matches_one_rank(world):
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.dist_mnist import local_shard

    results, _ = world
    got = results["mnist"]
    shards = [local_shard(1, 2, r, MNIST_BATCH) for r in range(2)]
    batch = {k: torch.cat([s[k] for s in shards]) for k in shards[0]}
    assert batch["inputs"].shape[0] == MNIST_BATCH
    model = MnistCNN(device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adam(1e-3),
                          loss_fn=ttr.classification_loss, device="cpu")
    _, metrics = trainer.make_train_step()(trainer.init(), batch)
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                               atol=MNIST_TOL, rtol=MNIST_TOL)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(got["params"][name].numpy(),
                                   param.detach().numpy(), atol=MNIST_TOL,
                                   rtol=0, err_msg=name)


def test_a_failed_write_on_one_rank_commits_nothing(world):
    results, _ = world
    got = results["failed_write"]
    assert "disk full" in got["errors"][1]
    assert all("another rank's write failed" in e
               for r, e in enumerate(got["errors"]) if r != 1), got
    assert got["latest_step"] is None
    assert got["entries"] == ["1.tmp"]
