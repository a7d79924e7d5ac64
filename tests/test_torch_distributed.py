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
- 3 steps at tp=4, which divides the 4 query heads but not the 2 KV heads
  (the KV projections gathered whole, the reference attention on each
  rank's heads), against the JAX ``Trainer`` at tp=4 within 5e-4;
- tp=2 prefill and decode logits against the unsharded JAX model within
  ``tests/test_llama_decode.py``'s ATOL (1e-5);
- a DCP save at (fsdp=2, tp=2) restored at (dp=4) and, after the world is
  gone, at world 1: parameters and AdamW moments bit-equal; and restored
  at (dp=4) into ``Trainer.abstract_state()`` of a meta build;
- the sharded-from-birth init: Llama at (fsdp=2, tp=2), (dp=2, fsdp=2)
  and (dcn=2, tp=2), Mixtral at (dp=2, ep=2) and BERT at (dp=2, tp=2),
  built on the meta device and materialised by ``Trainer.init()``, each
  parameter gathered bit-equal to today's eager build (the same seed,
  then sharded); and, counted by a dispatch mode over the floating-point
  CPU storages ops make, a rank of the meta build never holds more than its shards
  and one whole parameter, where the eager build holds the whole model;
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
  nothing;
- ring attention (``ops/ring_attention.py``), the einsum ring and the flash
  ring (the kernels' plain versions), at sp=2, sp=4 and (dp=2, sp=2),
  against JAX ``ring_attention_sharded`` on the same mesh: outputs 2e-5,
  gradients rtol 1e-4 and atol 1e-6 (``tests/test_models_parallel.py``);
- the ``Trainer`` with ``attention_impl`` "ring" and "ring_flash" at
  (dp=2, sp=2) (a head_dim-128 model, blocks of 64), 3 steps against the
  JAX ``Trainer`` within 5e-4;
- the pipeline LM step (``parallel/pipeline.py``), 1F1B and GPipe, at
  pp=2, pp=4 and (dp=2, pp=2), against JAX ``pipeline_lm_train_sharded``
  and ``pipeline_lm_train_gpipe``: loss 1e-5, gradients atol 1e-5 and rtol
  1e-4 (``tests/test_pipeline.py``);
- ``LlamaPipelineTrainer`` (1F1B) at (dp=2, pp=2), 3 steps from the JAX
  pipeline trainer's converted init against the JAX trainer within 5e-4;
  its state saved, restored into a trainer of another seed bit-equal, and
  the next step equal to the uninterrupted one's; the same restored into
  its ``abstract_state()``, from which a step before the restore raises;
- ``bert_tiny`` (f32, biased projections, LayerNorm; biases and norm
  scales drawn at random) with ``mlm_loss`` under ``LLAMA_RULES`` at
  ``MeshConfig(dp=2, tp=2)`` and ``MeshConfig(fsdp=2, tp=2)`` on padded,
  unevenly masked batches: the
  first batch's gradients of every parameter (the biases of the column-
  and row-parallel projections included) against JAX's unsharded
  gradients, then 3 adamw steps against the JAX ``Trainer`` on the same
  mesh: losses, grad norms and gathered parameters within 5e-4.
"""

import dataclasses
import functools
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
# tp=4 divides the 4 query heads of tiny_fields, not its 2 KV heads.
TP4 = dict(tp=4)
# Ring attention: [B, S, H|Hkv, D] inputs whose sp blocks the kernels take.
RING_MESHES = {"sp2": dict(sp=2), "sp4": dict(sp=4),
               "dp2_sp2": dict(dp=2, sp=2)}
RING_IMPLS = ("flash", "einsum")
RING_SHAPE = (2, 256, 4, 2, 128)
RING_TOL, RING_GRAD_RTOL, RING_GRAD_ATOL = 2e-5, 1e-4, 1e-6
RING_TRAIN_SEQ = 128
# Pipelines: (mesh fields, ranks in the mesh).
PIPE_MESHES = {"pp2": (dict(pp=2), 2), "pp4": (dict(pp=4), 4),
               "dp2_pp2": (dict(dp=2, pp=2), 4)}
PIPE_SCHEDULES = ("1f1b", "gpipe")
PIPE_HID, PIPE_VOCAB, PIPE_TOKENS, PIPE_MB = 16, 32, 16, 4
PIPE_LOSS_TOL, PIPE_GRAD_ATOL, PIPE_GRAD_RTOL = 1e-5, 1e-5, 1e-4
PP_LR = 3e-3
# BERT: data parallel and FSDP, each with tensor parallelism over the
# biased projections.
BERT_MESHES = {"bert_dp2_tp2": dict(dp=2, tp=2),
               "bert_fsdp2_tp2": dict(fsdp=2, tp=2)}
# Meta-built inits against today's eager build: (model, mesh fields).
META_MESHES = {"meta_fsdp2_tp2": ("llama", dict(fsdp=2, tp=2)),
               "meta_dp2_fsdp2": ("llama", dict(dp=2, fsdp=2)),
               "meta_dcn2_tp2": ("llama", dict(dcn=2, tp=2)),
               "meta_moe_dp2_ep2": ("mixtral", dict(dp=2, ep=2)),
               "meta_bert_dp2_tp2": ("bert", dict(dp=2, tp=2))}
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


def ring_fields():
    """A model whose head_dim (128) the flash ring takes."""
    return dict(vocab_size=256, hidden=256, n_layers=2, n_heads=2,
                n_kv_heads=1, head_dim=128, mlp_dim=512, max_seq_len=256,
                rope_theta=10000.0, remat=False)


def pp_fields():
    """tests/test_pipeline.py's pipeline Llama (f32, the reference
    attention)."""
    return dict(vocab_size=64, hidden=64, n_layers=4, n_heads=4,
                n_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=32,
                rope_theta=10000.0, remat=False, attention_impl="xla")


def ring_inputs():
    rng = np.random.default_rng(11)
    b, s, h, h_kv, d = RING_SHAPE
    mk = lambda *shape: (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return {"q": mk(b, s, h, d), "k": mk(b, s, h_kv, d), "v": mk(b, s, h_kv, d)}


def pipe_inputs(stages):
    """tests/test_pipeline.py's LM pipeline: a residual MLP per stage, an
    embedding table and an untied head."""
    rng = np.random.default_rng(31 + stages)
    mk = lambda *shape, scale: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"stages": [{"w1": mk(PIPE_HID, 4 * PIPE_HID, scale=0.1),
                        "w2": mk(4 * PIPE_HID, PIPE_HID, scale=0.1)}
                       for _ in range(stages)],
            "embed": {"table": mk(PIPE_VOCAB, PIPE_HID, scale=0.5)},
            "head": {"w": mk(PIPE_HID, PIPE_VOCAB, scale=0.5)},
            "tokens": rng.integers(0, PIPE_VOCAB, PIPE_TOKENS),
            "labels": rng.integers(0, PIPE_VOCAB, PIPE_TOKENS)}


def bert_batches():
    """MLM batches (15% masked, sentinel 3) with an attn_mask: one row
    padded at its tail, one all padding."""
    rng = np.random.default_rng(41)
    out = []
    for _ in range(STEPS):
        targets = rng.integers(0, 256, (BATCH, SEQ))
        mask = rng.random((BATCH, SEQ)) < 0.15
        attn = np.ones((BATCH, SEQ), np.int32)
        attn[1, SEQ // 2:] = 0
        attn[3] = 0
        out.append({"inputs": np.where(mask, 3, targets),
                    "targets": targets, "mask": mask.astype(np.float32),
                    "attn_mask": attn})
    return out


def randomized_norms_and_biases(params, seed):
    """``params`` with every bias and LayerNorm scale drawn at random:
    flax makes them 0 and 1, and a bias added tp times, or a gradient of
    one off by tp, would not show on zeros."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


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


def _train_case(inputs, name, fields=None, ckpt_dir=None,
                model_fields=None, weights="llama", batches=None):
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer

    cfg = tllama.LlamaConfig(dtype=torch.float32,
                             **(model_fields or tiny_fields()))
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(inputs[weights])
    mesh = make_mesh(MeshConfig(**(fields or TRAIN_MESHES[name])),
                     device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adamw(LR), device="cpu",
                          mesh=mesh, rules=LLAMA_RULES,
                          param_axes_fn=tllama.param_logical_axes)
    state = trainer.init()
    step = trainer.make_train_step()
    losses, norms = [], []
    if batches is None:
        batches = train_batches(inputs["tokens"], inputs["masks"], name)
    for batch in batches:
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


def _bert_case(inputs, name):
    """The first batch's gradients through the sharded model (whole), then
    3 Trainer steps."""
    import dataclasses as dc

    from tf_operator_tpu_torch.models import bert as tbert
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        use_mesh,
    )
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.data import local_batch

    cfg = dc.replace(tbert.bert_tiny(), dtype=torch.float32)
    model = tbert.Bert(cfg, device="cpu")
    model.load_state_dict(inputs["bert"])
    mesh = make_mesh(MeshConfig(**BERT_MESHES[name]), device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adamw(LR),
                          loss_fn=tbert.mlm_loss, device="cpu", mesh=mesh,
                          rules=LLAMA_RULES,
                          param_axes_fn=tbert.param_logical_axes)
    state = trainer.init()
    batches = inputs["bert_batches"]
    first = {k: torch.as_tensor(v)
             for k, v in local_batch(batches[0], mesh).items()}
    first["mask_count"] = ttr.slice_mask_count(first["mask"], mesh)
    with use_mesh(mesh):
        tbert.mlm_loss(model, first).backward()
    grads = {n: p.grad.full_tensor().clone()
             for n, p in model.named_parameters()}
    step = trainer.make_train_step()
    losses, norms = [], []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    attn = model.layers[0].attn
    tp_placement = lambda p: str(dict(zip(p.device_mesh.mesh_dim_names,
                                          p.placements))["tp"])
    return {"grads": grads, "losses": losses, "grad_norms": norms,
            "params": _gathered(model),
            "wq_bias_local": tuple(attn.wq.bias.to_local().shape),
            "tp_placements": {n: tp_placement(getattr(attn, n).bias)
                              for n in ("wq", "wo")}}


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


def _restore_case(inputs, ckpt_dir, seed, abstract=False):
    """A state of another seed on a dp=4 mesh, restored from the save;
    with ``abstract``, the abstract state of a meta build."""
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer

    cfg = tllama.LlamaConfig(dtype=torch.float32, **tiny_fields())
    model = tllama.Llama(cfg, device="meta" if abstract else "cpu",
                         generator=torch.Generator().manual_seed(seed))
    mesh = make_mesh(MeshConfig(dp=4), device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adamw(LR), device="cpu",
                          mesh=mesh, rules=LLAMA_RULES,
                          param_axes_fn=tllama.param_logical_axes)
    state = trainer.abstract_state() if abstract else trainer.init()
    ckpt = Checkpointer(ckpt_dir)
    ckpt.restore(state)
    ckpt.close()
    return {"step": state.step, "params": _gathered(model),
            "moments": _gathered_moments(state.opt_state)}


def _caught(case, *args):
    """``case(*args)``, or its error (every rank fails alike: the world
    goes on to its other cases)."""
    import traceback

    try:
        return case(*args)
    except Exception:
        return {"error": traceback.format_exc()}


def _meta_model(kind, device):
    """(model, rules, logical axes, loss) of the tiny f32 ``kind``."""
    from tf_operator_tpu_torch.models import bert as tbert
    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.models import mixtral as tmix
    from tf_operator_tpu_torch.parallel.sharding import (
        LLAMA_RULES,
        MOE_RULES,
    )
    from tf_operator_tpu_torch.train import trainer as ttr

    if kind == "llama":
        cfg = tllama.LlamaConfig(dtype=torch.float32, **tiny_fields())
        return (tllama.Llama(cfg, device=device), LLAMA_RULES,
                tllama.param_logical_axes, ttr.lm_loss)
    if kind == "mixtral":
        cfg = tmix.MixtralConfig(dtype=torch.float32, **moe_fields())
        return (tmix.Mixtral(cfg, device=device), MOE_RULES,
                tmix.param_logical_axes,
                tmix.make_moe_lm_loss(cfg.aux_loss_weight))
    cfg = dataclasses.replace(tbert.bert_tiny(), dtype=torch.float32)
    return (tbert.Bert(cfg, device=device), LLAMA_RULES,
            tbert.param_logical_axes, tbert.mlm_loss)


def _meta_init_case(name):
    """The model of ``name`` built on meta and materialised by
    ``Trainer.init()`` on its mesh, against today's build (eager, the same
    seed, then sharded): every parameter gathered, and each state's
    DTensor count."""
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.train import trainer as ttr

    kind, fields = META_MESHES[name]
    mesh = make_mesh(MeshConfig(**fields), device="cpu")
    params = []
    for device in ("cpu", "meta"):
        model, rules, axes, loss = _meta_model(kind, device)
        state = ttr.Trainer(model=model, optimizer=ttr.adamw(LR),
                            loss_fn=loss, device="cpu", mesh=mesh,
                            rules=rules, param_axes_fn=axes).init()
        params.append({n: p for n, p in state.model.named_parameters()})
    eager, meta = params
    return {"params": len(eager),
            "dtensors": [sum(map(is_dtensor, p.values())) for p in params],
            "differ": [n for n, p in eager.items()
                       if not torch.equal(p.full_tensor(),
                                          meta[n].full_tensor())]}


def is_dtensor(t):
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class LiveBytes:
    """A dispatch mode's count of the bytes in floating-point CPU storages
    that ops made while it is on, as they live and die (a storage's Python
    object lives as long as the storage), and its peak. Index tensors
    (DTensor's own bookkeeping) are not counted."""

    def __init__(self):
        import weakref

        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        live = self.live = {}
        self.peak = 0
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_leaves(out):
                    if not isinstance(t, torch.Tensor):
                        continue
                    local = t.to_local() if is_dtensor(t) else t
                    if (local.device.type != "cpu"
                            or not local.is_floating_point()):
                        continue
                    storage = local.untyped_storage()
                    if id(storage) not in live:
                        live[id(storage)] = storage.nbytes()
                        weakref.finalize(storage, live.pop, id(storage),
                                         None)
                counter.peak = max(counter.peak, sum(live.values()))
                return out

        self.mode = Mode()


def _init_memory_case():
    """Peak bytes a rank holds while it builds and inits ``llama_tiny``
    at (fsdp 2, tp 2), today's way (eager, then sharded) and built on
    meta; the bytes of its shards and of its largest whole parameter."""
    import gc

    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.train import trainer as ttr

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device="cpu")
    out = {}
    for device in ("cpu", "meta"):
        gc.collect()
        counter = LiveBytes()
        with counter.mode:
            model, rules, axes, loss = _meta_model("llama", device)
            state = ttr.Trainer(model=model, optimizer=ttr.adamw(LR),
                                device="cpu", mesh=mesh, rules=rules,
                                param_axes_fn=axes).init()
        out[device] = counter.peak
        tensors = [p.to_local() for p in state.model.parameters()]
        tensors += list(state.model.buffers())
        storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in tensors}
        out["held"] = sum(storages.values())
        out["whole_model"] = sum(p.numel() * p.element_size()
                                 for p in state.model.parameters())
        out["largest_whole"] = max(p.numel() * p.element_size()
                                   for p in state.model.parameters())
        del model, state, tensors
    return out


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


def _ring_case(inputs):
    """Ring attention of the global inputs (the same on every rank) per
    mesh and ring: the output and the gradients of mean(out²), whole."""
    from tf_operator_tpu_torch.ops.ring_attention import (
        ring_attention_sharded,
    )
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    out = {}
    for name, fields in RING_MESHES.items():
        mesh = make_mesh(MeshConfig(**fields), device="cpu")
        for impl in RING_IMPLS:
            q, k, v = (torch.tensor(inputs["ring"][n]).requires_grad_()
                       for n in ("q", "k", "v"))
            o = ring_attention_sharded(q, k, v, mesh, causal=True,
                                       impl=impl)
            local_seq = o.to_local().shape[1]
            full = o.full_tensor()
            (full ** 2).mean().backward()
            out[(name, impl)] = {"out": full.detach(), "dq": q.grad,
                                 "dk": k.grad, "dv": v.grad,
                                 "local_seq": local_seq}
    return out


def _pipe_case(inputs):
    """The LM pipeline step per mesh and schedule; rank 0 gets every
    stage's gradients (from the first data replica)."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel import pipeline as tpp
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        axis_index,
        data_index,
        make_mesh,
    )

    def stage_fn(p, x):
        return x + torch.nn.functional.gelu(x @ p["w1"]) @ p["w2"]

    def loss_fn(y, t, hp):
        logp = torch.log_softmax(y @ hp["w"], dim=-1)
        return -torch.gather(logp, -1, t[..., None].long()).mean()

    def embed_fn(ep, tok):
        return ep["table"][tok]

    out = {}
    for name, (fields, ranks) in PIPE_MESHES.items():
        mesh = make_mesh(MeshConfig(**fields), devices=list(range(ranks)),
                         device="cpu")
        toy = inputs["pipe"][fields["pp"]]
        for schedule in PIPE_SCHEDULES:
            got = None
            if dist.get_rank() < ranks:
                stage = axis_index(mesh, "pp")
                t = lambda d: {n: torch.tensor(a) for n, a in d.items()}
                fn = (tpp.pipeline_lm_train_sharded if schedule == "1f1b"
                      else tpp.pipeline_lm_train_gpipe)
                loss, sg, eg, hg = fn(
                    stage_fn, loss_fn, embed_fn, t(toy["stages"][stage]),
                    t(toy["embed"]), t(toy["head"]),
                    torch.tensor(toy["tokens"]), torch.tensor(toy["labels"]),
                    mesh, PIPE_MB)
                got = {"stage": stage, "replica": data_index(mesh),
                       "loss": float(loss), "stage_grads": sg,
                       "embed_grads": eg, "head_grads": hg}
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, got)
            out[(name, schedule)] = [g for g in every if g is not None]
    return out


def _gathered_stages(model):
    """Every stage's parameters and AdamW moments, by name, on every rank
    (each rank holds its stage's layers and the replicated head)."""
    import torch.distributed as dist

    mine = {n: p.detach().clone() for n, p in model.named_parameters()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    merged = {}
    for part in every:
        merged.update(part)
    return merged


def _llama_pp_case(inputs, ckpt_dir):
    """LlamaPipelineTrainer (1F1B) at (dp=2, pp=2): 3 steps from the
    converted weights; then the state saved, restored into a trainer of
    another seed, and one more step on both."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import llama as tllama
    from tf_operator_tpu_torch.parallel.llama_pp import LlamaPipelineTrainer
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer

    cfg = tllama.LlamaConfig(dtype=torch.float32, **pp_fields())
    mesh = make_mesh(MeshConfig(dp=2, pp=2), device="cpu")

    def trainer():
        return LlamaPipelineTrainer(cfg, mesh, ttr.adam(PP_LR),
                                    num_microbatches=PIPE_MB,
                                    schedule="1f1b", device="cpu")

    first = trainer()
    state = first.init(state_dict=inputs["pp_llama"])
    step = first.make_train_step(state)
    tokens = inputs["pp_tokens"]
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
    out = {"losses": losses, "params": _gathered_stages(state.model),
           "layers_per_rank": len(state.model.layers)}
    ckpt = Checkpointer(ckpt_dir)
    ckpt.save(state.step, state)
    ckpt.wait()
    second = trainer()
    restored = second.init(generator=torch.Generator().manual_seed(1))
    ckpt.restore(restored)
    # The abstract restore target: no step before the restore.
    third = trainer()
    abstract = third.abstract_state()
    third_step = third.make_train_step(abstract)
    try:
        third_step(abstract, tokens)
        unrestored_raised = False
    except RuntimeError:
        unrestored_raised = True
    ckpt.restore(abstract)
    ckpt.close()
    moments = lambda st: [t.clone() for per in st.opt_state.state.values()
                          for n, t in sorted(per.items())]

    def equal(st):
        return (st.step == state.step and all(
            torch.equal(a, b) for a, b in zip(moments(st), moments(state)))
            and all(torch.equal(a, b) for a, b in zip(
                st.model.parameters(), state.model.parameters())))

    same, same_abstract = equal(restored), equal(abstract)
    state, kept = step(state, tokens)
    restored, again = second.make_train_step(restored)(restored, tokens)
    abstract, from_abstract = third_step(abstract, tokens)
    after = lambda st: all(torch.equal(a, b) for a, b in zip(
        st.model.parameters(), state.model.parameters()))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (same, after(restored), same_abstract,
                                   after(abstract), unrestored_raised))
    out["resume"] = {"restored_equal": [e[0] for e in every],
                     "next_params_equal": [e[1] for e in every],
                     "next_loss": float(again["loss"]),
                     "kept_loss": float(kept["loss"])}
    out["abstract_resume"] = {
        "restored_equal": [e[2] for e in every],
        "next_params_equal": [e[3] for e in every],
        "unrestored_step_raised": [e[4] for e in every],
        "next_loss": float(from_abstract["loss"]),
        "kept_loss": float(kept["loss"])}
    return out


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
                inputs, name,
                ckpt_dir=ckpt_dir if name == "fsdp2_tp2" else None)
        for name in MOE_MESHES:
            results[name] = _moe_train_case(inputs, name)
        results["moe_decode"] = _moe_decode_case(inputs)
        results["restore_dp4"] = _restore_case(inputs, ckpt_dir, seed=1)
        results["restore_dp4_abstract"] = _caught(
            _restore_case, inputs, ckpt_dir, 1, True)
        for name in META_MESHES:
            results[name] = _caught(_meta_init_case, name)
        results["init_memory"] = _caught(_init_memory_case)
        results["flash"] = _flash_case(inputs)
        results["decode"] = _decode_case(inputs)
        results["mnist"] = _mnist_case()
        results["failed_write"] = _failed_write_case(
            os.path.join(work_dir, "failed"))
        results["tp4"] = _train_case(inputs, "tp4", fields=TP4)
        results["ring_attention"] = _ring_case(inputs)
        for impl in ("ring", "ring_flash"):
            results[impl] = _train_case(
                inputs, impl, fields=dict(dp=2, sp=2),
                model_fields={**ring_fields(), "attention_impl": impl},
                weights="ring_llama",
                batches=[{"inputs": t} for t in inputs["ring_tokens"]])
        results["pipe"] = _pipe_case(inputs)
        results["llama_pp"] = _llama_pp_case(
            inputs, os.path.join(work_dir, "pp-ckpt"))
        for name in BERT_MESHES:
            results[name] = _bert_case(inputs, name)
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


def _jax_trainer_run(fields, batches, init_params, model_fields=None):
    """3 JAX Trainer steps on the mesh ``fields`` from ``init_params``
    (what the trainer's own init makes from PRNGKey(0))."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu.train import trainer as jtr

    jcfg = jllama.LlamaConfig(dtype=jnp.float32,
                              **(model_fields or tiny_fields()))
    mesh = make_mesh(MeshConfig(**fields), devices=jax.devices()[:WORLD])
    trainer = jtr.Trainer(model=jllama.Llama(jcfg),
                          param_axes_fn=jllama.param_logical_axes,
                          rules=LLAMA_RULES, mesh=mesh,
                          optimizer=optax.adamw(LR))
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
    return {"losses": losses, "grad_norms": norms,
            "params": jax.tree.map(np.asarray, state.params)}


def _jax_training(tokens, masks, init_params):
    out = {name: _jax_trainer_run(fields,
                                  train_batches(tokens, masks, name),
                                  init_params)
           for name, fields in TRAIN_MESHES.items()}
    out["tp4"] = _jax_trainer_run(TP4, train_batches(tokens, masks, "tp4"),
                                  init_params)
    return out


def _jax_ring(ring):
    """JAX ring_attention_sharded per mesh and ring: the output and the
    gradients of mean(out²)."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.ring_attention import ring_attention_sharded
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh

    out = {}
    for name, fields in RING_MESHES.items():
        mesh = make_mesh(MeshConfig(**fields), devices=jax.devices()[:WORLD])
        for impl in RING_IMPLS:
            def loss(q, k, v, impl=impl):
                o = ring_attention_sharded(mesh, q, k, v, causal=True,
                                           head_axis=None, impl=impl)
                return (o ** 2).mean(), o

            (_, o), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(ring[n]) for n in ("q", "k", "v")))
            out[(name, impl)] = {"out": np.asarray(o),
                                 **{f"d{n}": np.asarray(g)
                                    for n, g in zip("qkv", grads)}}
    return out


def _jax_pipe(pipes):
    """JAX pipeline_lm_train_sharded (1F1B) and pipeline_lm_train_gpipe per
    mesh: loss, stage gradients [pp, ...], embedding and head gradients."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import pipeline as jpp
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh

    def stage_fn(p, x):
        return x + jax.nn.gelu(x @ p["w1"]) @ p["w2"]

    def loss_fn(y, t, hp):
        logp = jax.nn.log_softmax(y @ hp["w"])
        return -jnp.take_along_axis(logp, t[..., None], axis=-1).mean()

    def embed_fn(ep, tok):
        return ep["table"][tok]

    out = {}
    for name, (fields, ranks) in PIPE_MESHES.items():
        toy = jax.tree.map(jnp.asarray, pipes[fields["pp"]])
        mesh = make_mesh(MeshConfig(**fields), devices=jax.devices()[:ranks])
        stacked = jpp.stack_stage_params(toy["stages"])
        for schedule in PIPE_SCHEDULES:
            fn = (jpp.pipeline_lm_train_sharded if schedule == "1f1b"
                  else jpp.pipeline_lm_train_gpipe)
            loss, sg, eg, hg = jax.jit(lambda sp, ep, hp, tok, lab, fn=fn: fn(
                stage_fn, loss_fn, embed_fn, sp, ep, hp, tok, lab, mesh,
                PIPE_MB))(stacked, toy["embed"], toy["head"], toy["tokens"],
                          toy["labels"])
            out[(name, schedule)] = jax.tree.map(
                np.asarray, {"loss": loss, "stage_grads": sg,
                             "embed_grads": eg, "head_grads": hg})
    return out


def _jax_llama_pp_init():
    """The JAX pipeline trainer at (dp=2, pp=2), its init state and token
    batch (tests/test_pipeline.py's setup)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu.parallel.llama_pp import LlamaPipelineTrainer
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh

    cfg = jllama.LlamaConfig(dtype=jnp.float32, **pp_fields())
    mesh = make_mesh(MeshConfig(dp=2, pp=2), devices=jax.devices()[:WORLD])
    trainer = LlamaPipelineTrainer(cfg, mesh, optax.adam(PP_LR),
                                   num_microbatches=PIPE_MB,
                                   schedule="1f1b")
    rng = jax.random.PRNGKey(51)
    tokens = jax.random.randint(jax.random.fold_in(rng, 1), (8, 17), 0,
                                cfg.vocab_size)
    state, shardings = trainer.init(rng, tokens[:, :-1])
    return trainer, state, shardings, tokens


def _jax_llama_pp_run(trainer, state, shardings, tokens):
    step = trainer.make_train_step(shardings)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, tokens)
        losses.append(float(m["loss"]))
    import jax

    return {"losses": losses, "params": jax.tree.map(np.asarray,
                                                     state.params)}


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


def _jax_bert(batches, init_params):
    """JAX's unsharded gradients on the first batch, and 3 JAX Trainer
    steps per BERT mesh, each from ``init_params``."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import bert as jbert
    from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu.train import trainer as jtr

    cfg = dataclasses.replace(jbert.bert_tiny(), dtype=jnp.float32)
    model = jbert.Bert(cfg)
    first = jax.tree.map(jnp.asarray, batches[0])
    grads = jax.grad(lambda p: jbert.mlm_loss(p, None, first,
                                              model.apply)[0])(init_params)
    out = {"grads": jax.tree.map(np.asarray, grads)}
    for name, fields in BERT_MESHES.items():
        mesh = make_mesh(MeshConfig(**fields), devices=jax.devices()[:WORLD])
        trainer = jtr.Trainer(model=model,
                              param_axes_fn=jbert.param_logical_axes,
                              rules=LLAMA_RULES, mesh=mesh,
                              optimizer=optax.adamw(LR),
                              loss_fn=jbert.mlm_loss)
        state, shardings = trainer.init(jax.random.PRNGKey(0), first)
        # Both sides start from the same weights (the sharded init draws
        # the kernels within an ulp of the unsharded one's, and the norms
        # and biases are drawn at random).
        state = dataclasses.replace(state, params=jax.device_put(
            init_params, shardings.params))
        step = trainer.make_train_step(shardings, first)
        losses, norms = [], []
        for batch in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, batch))
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
    from tf_operator_tpu.models import bert as jbert
    from tf_operator_tpu_torch.models import bert as tbert
    from tf_operator_tpu_torch.models.convert import (
        bert_params_from_flax,
        llama_params_from_flax,
        llama_stage_params_from_flax,
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
    # Ring attention and the ring-trained model.
    ring = ring_inputs()
    rcfg = tllama.LlamaConfig(dtype=torch.float32, **ring_fields())
    ring_init = jax.tree.map(np.asarray, jllama.Llama(jllama.LlamaConfig(
        dtype=jnp.float32, **ring_fields())).init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, RING_TRAIN_SEQ + 1),
                                         jnp.int32))["params"])
    ring_tokens = [data.integers(0, ring_fields()["vocab_size"],
                                 (BATCH, RING_TRAIN_SEQ + 1))
                   for _ in range(STEPS)]
    # Pipelines: the toy LM per stage count, the Llama pipeline trainer.
    pipes = {pp: pipe_inputs(pp) for pp in (2, 4)}
    pp_trainer, pp_state, pp_shardings, pp_tokens = _jax_llama_pp_init()
    pcfg = tllama.LlamaConfig(dtype=torch.float32, **pp_fields())
    pp_init = jax.tree.map(np.asarray, pp_state.params)
    pp_llama = {}
    for stage in range(2):
        pp_llama.update(llama_stage_params_from_flax(pp_init, pcfg, stage, 2))
    # BERT: the JAX trainer's init params, and padded MLM batches.
    bcfg = dataclasses.replace(tbert.bert_tiny(), dtype=torch.float32)
    bert_batch = bert_batches()
    bert_init = randomized_norms_and_biases(jax.tree.map(
        np.asarray, jbert.Bert(dataclasses.replace(
            jbert.bert_tiny(), dtype=jnp.float32)).init(
            jax.random.PRNGKey(0), jnp.asarray(bert_batch[0]["inputs"]))
        ["params"]), seed=43)
    torch.save({"llama": llama_params_from_flax(init_params, tcfg),
                "bert": bert_params_from_flax(bert_init, bcfg),
                "bert_batches": bert_batch,
                "ring": ring, "ring_tokens": ring_tokens,
                "ring_llama": llama_params_from_flax(ring_init, rcfg),
                "pipe": pipes, "pp_llama": pp_llama,
                "pp_tokens": np.asarray(pp_tokens),
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
        jax_ring = _jax_ring(ring)
        for impl in ("ring", "ring_flash"):
            jax_train[impl] = _jax_trainer_run(
                dict(dp=2, sp=2), [{"inputs": t} for t in ring_tokens],
                ring_init, {**ring_fields(), "attention_impl": impl})
        jax_pipe = _jax_pipe(pipes)
        jax_pp = _jax_llama_pp_run(pp_trainer, pp_state, pp_shardings,
                                   pp_tokens)
        jax_moe = _jax_moe_training(tokens, moe_params)
        jax_bert = _jax_bert(bert_batch, bert_init)
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
                "moe_decode_full": mdfull, "ring_attention": jax_ring,
                "ring_init": ring_init, "rcfg": rcfg, "pipe": jax_pipe,
                "llama_pp": jax_pp, "pp_init": pp_init, "pcfg": pcfg,
                "bert": jax_bert, "bert_init": bert_init, "bcfg": bcfg}
    return results, jax_side


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_sharded_steps_match_jax_trainer(world, mesh_name):
    results, jax_side = world
    assert_train_matches(results[mesh_name], jax_side["train"][mesh_name],
                         jax_side["tcfg"], jax_side["init_params"])


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


def assert_train_matches(got, want, tcfg, init, convert=None):
    """Losses, grad norms and every gathered parameter within TRAIN_TOL of
    the JAX Trainer's; the steps moved every parameter."""
    from tf_operator_tpu_torch.models.convert import llama_params_from_flax

    convert = convert or llama_params_from_flax
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    if "grad_norms" in want:
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL)
    want_params, start = convert(want["params"], tcfg), convert(init, tcfg)
    assert set(got["params"]) == set(want_params)
    for name, param in got["params"].items():
        np.testing.assert_allclose(param.numpy(), want_params[name].numpy(),
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=name)
        assert not torch.equal(param, start[name]), name


def test_tp_indivisible_kv_heads_raises(world):
    """tp=4 divides the 4 query heads but not the 2 KV heads. The JAX
    model runs the reference attention on the global heads there; the
    port's KV projections gather every KV head, each rank takes its query
    heads' share and runs the reference on them, and nothing raises: 3
    steps match the JAX Trainer at tp=4 within 5e-4 (the test keeps the
    name it had while the port raised)."""
    results, jax_side = world
    assert_train_matches(results["tp4"], jax_side["train"]["tp4"],
                         jax_side["tcfg"], jax_side["init_params"])


@pytest.mark.parametrize("impl", RING_IMPLS)
@pytest.mark.parametrize("mesh_name", list(RING_MESHES))
def test_ring_attention_matches_jax(world, mesh_name, impl):
    results, jax_side = world
    got = results["ring_attention"][(mesh_name, impl)]
    want = jax_side["ring_attention"][(mesh_name, impl)]
    # Each rank held its sp block of the sequence.
    assert got["local_seq"] == RING_SHAPE[1] // RING_MESHES[mesh_name]["sp"]
    np.testing.assert_allclose(got["out"].numpy(), want["out"],
                               atol=RING_TOL, rtol=RING_TOL)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   atol=RING_GRAD_ATOL, rtol=RING_GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_ring_trainer_matches_jax_trainer(world, impl):
    """3 steps at (dp=2, sp=2): the batch over dp, the sequence's ring
    over sp, the parameters' gradients whole on each sp rank (not summed
    over sp)."""
    results, jax_side = world
    assert_train_matches(results[impl], jax_side["train"][impl],
                         jax_side["rcfg"], jax_side["ring_init"])


@pytest.mark.parametrize("schedule", PIPE_SCHEDULES)
@pytest.mark.parametrize("mesh_name", list(PIPE_MESHES))
def test_pipeline_lm_step_matches_jax(world, mesh_name, schedule):
    results, jax_side = world
    got = results["pipe"][(mesh_name, schedule)]
    want = jax_side["pipe"][(mesh_name, schedule)]
    fields, ranks = PIPE_MESHES[mesh_name]
    assert sorted((g["stage"], g["replica"]) for g in got) == sorted(
        (s, r) for s in range(fields["pp"])
        for r in range(ranks // fields["pp"]))
    close = functools.partial(np.testing.assert_allclose,
                              atol=PIPE_GRAD_ATOL, rtol=PIPE_GRAD_RTOL)
    for g in got:
        np.testing.assert_allclose(g["loss"], float(want["loss"]),
                                   atol=PIPE_LOSS_TOL, rtol=PIPE_LOSS_TOL)
        for n, grad in g["stage_grads"].items():
            close(grad.numpy(), want["stage_grads"][n][g["stage"]],
                  err_msg=f"stage {g['stage']} {n}")
        # Every stage's copy of the embedding and head gets the same
        # gradient.
        for kind in ("embed_grads", "head_grads"):
            for n, grad in g[kind].items():
                close(grad.numpy(), want[kind][n], err_msg=f"{kind} {n}")


def test_llama_pipeline_trainer_matches_jax(world):
    from tf_operator_tpu_torch.models.convert import (
        llama_stage_params_from_flax,
    )

    results, jax_side = world
    got = results["llama_pp"]
    # Each rank built and trained its own 2 of the 4 layers.
    assert got["layers_per_rank"] == 2

    def convert(params, cfg):
        whole = {}
        for stage in range(2):
            whole.update(llama_stage_params_from_flax(params, cfg, stage, 2))
        return whole

    assert_train_matches(got, jax_side["llama_pp"], jax_side["pcfg"],
                         jax_side["pp_init"], convert)


def test_llama_pipeline_trainer_resumes_bit_equal(world):
    """Saved at (dp=2, pp=2) after 3 steps, each stage its own layers:
    a trainer of another seed restores parameters and Adam moments
    bit-equal on every rank, and its next step equals the uninterrupted
    one's."""
    results, _ = world
    resume = results["llama_pp"]["resume"]
    assert all(resume["restored_equal"]), resume
    assert all(resume["next_params_equal"]), resume
    assert resume["next_loss"] == resume["kept_loss"]


def test_tp2_sharded_decode_matches_unsharded(world):
    results, jax_side = world
    got = results["decode"]
    # The cache holds this rank's KV heads: 2 // tp.
    assert got["cache_kv_heads"] == 1
    np.testing.assert_allclose(got["logits"].numpy(),
                               jax_side["decode_full"], atol=DECODE_ATOL)


@pytest.mark.parametrize("where", ["restore_dp4", "restore_world1",
                                   "restore_dp4_abstract"])
def test_sharded_checkpoint_restores_bit_equal(world, where):
    """Saved at (fsdp=2, tp=2) after 3 steps; restored into a state of
    another seed on another layout, or into the abstract state of a meta
    build at dp=4."""
    results, _ = world
    saved, got = results["fsdp2_tp2"], results[where]
    assert "error" not in got, got.get("error")
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


@pytest.mark.parametrize("mesh_name", list(BERT_MESHES))
def test_sharded_bert_matches_jax(world, mesh_name):
    """The first batch's gradients (every bias among them) within 5e-4 of
    JAX's unsharded ones: a row-parallel bias added on every tp rank
    before the sum would double the activations, an unsummed or
    tp-split bias gradient would be off by tp; then 3 steps against the
    JAX Trainer on the same mesh."""
    from tf_operator_tpu_torch.models.convert import bert_params_from_flax

    results, jax_side = world
    got, want = results[mesh_name], jax_side["bert"]
    bcfg = jax_side["bcfg"]
    tp, fsdp = (BERT_MESHES[mesh_name].get(a, 1) for a in ("tp", "fsdp"))
    # wq's bias split with its output features over tp (and dim 0 again
    # over fsdp); wo's whole on the tp dim.
    assert got["wq_bias_local"] == (64 // tp // fsdp,)
    assert got["tp_placements"] == {"wq": "S(0)", "wo": "R"}
    want_grads = bert_params_from_flax(want["grads"], bcfg)
    assert set(got["grads"]) == set(want_grads)
    for name, grad in got["grads"].items():
        np.testing.assert_allclose(grad.numpy(), want_grads[name].numpy(),
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=name)
    for name in ("layers.0.attn.wq.bias", "layers.0.attn.wo.bias",
                 "layers.1.mlp_in.bias", "layers.1.mlp_out.bias",
                 "mlm_head.bias"):
        assert got["grads"][name].abs().max() > 1e-3, name
    assert_train_matches(got, want[mesh_name], bcfg, jax_side["bert_init"],
                         bert_params_from_flax)


@pytest.mark.parametrize("name", list(META_MESHES))
def test_meta_init_matches_eager_build(world, name):
    """Built on the meta device, each rank materialising its own shards:
    every parameter, gathered, bit-equal to today's eager build from the
    same seed, sharded the same."""
    results, _ = world
    got = results[name]
    assert "error" not in got, got.get("error")
    assert got["differ"] == [], got["differ"]
    assert got["dtensors"] == [got["params"]] * 2


def test_llama_pipeline_trainer_abstract_state_resumes_bit_equal(world):
    """Restored into ``abstract_state()`` (a step before that raises):
    parameters and Adam moments bit-equal on every rank, and the next step
    the uninterrupted one's."""
    results, _ = world
    resume = results["llama_pp"]["abstract_resume"]
    assert all(resume["unrestored_step_raised"]), resume
    assert all(resume["restored_equal"]), resume
    assert all(resume["next_params_equal"]), resume
    assert resume["next_loss"] == resume["kept_loss"]


def test_meta_init_holds_one_whole_parameter_beside_the_shards(world):
    """While it builds and inits the model at (fsdp 2, tp 2), a rank of
    the meta build holds no more than its shards and one whole parameter;
    today's eager build holds the whole model (the measure sees it)."""
    results, _ = world
    got = results["init_memory"]
    assert "error" not in got, got.get("error")
    bound = got["held"] + got["largest_whole"]
    assert got["meta"] <= bound, got
    assert got["cpu"] >= got["whole_model"] > bound, got
