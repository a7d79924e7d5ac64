"""Port parity: the mesh, the sharding rules and the multi-process bring-up
against the JAX package, in one process on the CPU.

- ``MeshConfig.resolve`` against the JAX one on the cases of
  ``tests/test_models_parallel.py`` and more, errors included;
- ``spec_for`` on every rule table against the JAX ``PartitionSpec``,
  translated into one DTensor placement per mesh axis, for every logical
  axes tuple the models use, and the Llama parameters' logical axes
  against the JAX model's (a Dense weight is the flax kernel transposed);
- the env the operator renders: a process joins a multi-process run only
  under the JAX payload's three conditions;
- a world of one: ``make_mesh`` without a process group makes one (gloo
  on the CPU) with all seven axis names; the flash op refuses DTensors;
  a sharded ``Trainer`` on it steps exactly as the unsharded one does.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding as jsharding
from tf_operator_tpu_torch.models import convert
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.parallel import distributed as tdist
from tf_operator_tpu_torch.parallel import mesh as tmesh
from tf_operator_tpu_torch.parallel import sharding as tsharding

pytestmark = pytest.mark.compute

RESOLVE_CASES = [
    (dict(dp=-1, tp=2), 8),
    (dict(dp=-1), 1),
    (dict(fsdp=2, tp=2), 4),
    (dict(dp=2, fsdp=2), 4),
    (dict(dcn=2, dp=-1, tp=2), 8),
    (dict(dp=1, fsdp=-1, tp=2), 8),
    (dict(dp=-1, tp=3), 8),         # not divisible
    (dict(dp=-1, tp=-1), 8),        # two wild axes
    (dict(dp=2), 8),                # fixed product != devices
]


@pytest.mark.parametrize("fields,n", RESOLVE_CASES)
def test_mesh_config_resolves_as_jax(fields, n):
    try:
        want = jmesh.MeshConfig(**fields).resolve(n)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tmesh.MeshConfig(**fields).resolve(n)
        assert str(got.value) == str(err)
        return
    assert tmesh.MeshConfig(**fields).resolve(n) == want
    assert tuple(want) == tmesh.AXIS_ORDER == jmesh.AXIS_ORDER


def _placements_of(spec: PartitionSpec, ndim: int):
    """A JAX spec as one DTensor placement per mesh axis."""
    out = {a: "R" for a in jmesh.AXIS_ORDER}
    for dim, axes in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        for axis in (axes,) if isinstance(axes, str) else axes or ():
            out[axis] = f"S({dim})"
    return [out[a] for a in jmesh.AXIS_ORDER]


def _axes_tuples():
    """Every logical axes tuple of the rule tables' users: the Llama leaves
    in both layouts, the batch, MoE's expert weights, a conv kernel."""
    tuples = set(jllama._LEAF_AXES.values()) | set(tllama._LEAF_AXES.values())
    tuples |= {("batch", None), ("batch", "seq", "heads", "head_dim"),
               ("expert", "embed", "mlp"), ("expert", "capacity", "embed"),
               ("layers", "embed", "heads"), (None, None, None, None)}
    return sorted(tuples, key=str)


@pytest.mark.parametrize("table", ["LLAMA_RULES", "MOE_RULES", "CNN_RULES"])
@pytest.mark.parametrize("axes", _axes_tuples(), ids=str)
def test_spec_for_matches_jax(table, axes):
    want = _placements_of(
        jsharding.spec_for(axes, getattr(jsharding, table)), len(axes))
    got = tsharding.spec_for(axes, getattr(tsharding, table))
    assert [str(p) for p in got] == want
    assert getattr(tsharding, table) == getattr(jsharding, table)


def test_llama_param_axes_match_jax():
    """Every parameter of the port's Llama has the JAX leaf's logical axes,
    reversed where the weight is the flax kernel transposed."""
    cfg = tllama.llama_tiny()
    model = tllama.Llama(cfg, device="cpu")
    leaves = {**{("blocks",) + p: (f"layers.0.{n}", t)
                 for p, (n, t) in convert._BLOCK_LEAVES.items()},
              **convert._TOP_LEAVES}
    names = dict(model.named_parameters())
    for path, (name, transposed) in leaves.items():
        value = names[name]
        want = jllama.param_logical_axes(path, np.zeros(value.shape))
        got = tllama.param_logical_axes(name, value)
        assert got == (tuple(reversed(want)) if transposed else want), name
    with pytest.raises(ValueError, match="no logical axes"):
        tllama.param_logical_axes("angles", torch.zeros(2))


ENV_CASES = [
    # (TPUJOB_JAX_DISTRIBUTED, JAX_NUM_PROCESSES, coordinator, joins)
    ("1", "2", "127.0.0.1:1234", True),
    ("1", "1", "127.0.0.1:1234", False),
    ("", "2", "127.0.0.1:1234", False),
    ("0", "2", "127.0.0.1:1234", False),
    ("1", "2", "", False),
]


@pytest.mark.parametrize("flag,num,coord,joins", ENV_CASES)
def test_process_env_joins_only_under_the_payload_conditions(flag, num,
                                                             coord, joins):
    env = {"TPUJOB_JAX_DISTRIBUTED": flag, "JAX_NUM_PROCESSES": num,
           "JAX_COORDINATOR_ADDRESS": coord, "JAX_PROCESS_ID": "1"}
    parsed = tdist.ProcessEnv.from_env(env)
    assert parsed.joins is joins
    assert parsed.process_id == 1
    if not joins:
        # No store is served or dialled and no group is made.
        assert tdist.maybe_init_distributed("cpu", env) == 1
        assert not dist.is_initialized()


TORCH_ENV_CASES = [
    # (env, (num_processes, process_id, coordinator), joins)
    ({"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "9000", "WORLD_SIZE": "4",
      "RANK": "3"}, (4, 3, "10.0.0.2:9000"), True),
    ({"MASTER_ADDR": "job-chief-0.ns.svc", "WORLD_SIZE": "2", "RANK": "1"},
     (2, 1, "job-chief-0.ns.svc"), True),
    ({"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "9000", "WORLD_SIZE": "1",
      "RANK": "0"}, (1, 0, "10.0.0.2:9000"), False),
    ({"WORLD_SIZE": "2", "RANK": "1"}, (2, 1, ""), False),
    # The torch keys win over the JAX keys, key by key.
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "5", "WORLD_SIZE": "2",
      "RANK": "1", "JAX_COORDINATOR_ADDRESS": "10.9.9.9:7",
      "JAX_NUM_PROCESSES": "8", "JAX_PROCESS_ID": "6", "TPU_WORKER_ID": "5"},
     (2, 1, "127.0.0.1:5"), True),
    ({"RANK": "0", "JAX_COORDINATOR_ADDRESS": "10.9.9.9:7",
      "JAX_NUM_PROCESSES": "8", "JAX_PROCESS_ID": "6"},
     (8, 0, "10.9.9.9:7"), True),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "5",
      "JAX_NUM_PROCESSES": "3", "TPU_WORKER_ID": "2"},
     (3, 2, "127.0.0.1:5"), True),
]


@pytest.mark.parametrize("env,parsed,joins", TORCH_ENV_CASES)
def test_process_env_reads_the_torch_keys_first(env, parsed, joins):
    got = tdist.ProcessEnv.from_env(dict(env, TPUJOB_JAX_DISTRIBUTED="1"))
    assert (got.num_processes, got.process_id, got.coordinator) == parsed
    assert got.joins is joins
    assert not tdist.ProcessEnv.from_env(env).joins   # no opt-in


def test_process_env_defaults_and_coordinator_parsing():
    assert tdist.ProcessEnv.from_env({}) == tdist.ProcessEnv()
    assert tdist.ProcessEnv.from_env({"TPU_WORKER_ID": "3"}).process_id == 3
    assert tdist.coordinator_host_port("10.0.0.2:9000") == ("10.0.0.2", 9000)
    assert tdist.coordinator_host_port("job-worker-0.job") == (
        "job-worker-0.job", tdist.DEFAULT_COORDINATOR_PORT)
    assert tdist.coordinator_host_port("[::1]:5") == ("::1", 5)
    assert tdist.backend_for(torch.device("cpu")) == "gloo"
    assert tdist.backend_for(torch.device("cuda")) == "nccl"


def test_make_mesh_without_a_group_makes_a_world_of_one():
    assert not dist.is_initialized()
    with tdist.process_group_scope():
        mesh = tmesh.make_mesh(device="cpu")
        assert dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == jmesh.AXIS_ORDER
        assert tmesh.mesh_shape(mesh) == {a: 1 for a in jmesh.AXIS_ORDER}
        assert tmesh.data_axes(mesh) == ("dcn", "dp", "fsdp")
        assert tmesh.data_parallel_size(mesh) == 1
        with tmesh.use_mesh(mesh):
            assert tmesh.active_mesh() is mesh
        assert tmesh.active_mesh() is None
    assert not dist.is_initialized()


def test_flash_attention_refuses_dtensors():
    """The outputs are compared bit for bit, so the test fixes what else
    could move them in a process that ran other tests first: the inputs
    come from its own generator (the global one's state depends on what
    ran before), both calls run on one intra-op thread (how the plain
    version's CPU reductions split depends on the thread count, which a
    loaded host or an earlier test can change), and the world of one is
    its own."""
    from torch.distributed.tensor import DTensor, Replicate

    from tf_operator_tpu_torch.ops import flash_attention as tfa

    assert not dist.is_initialized()
    q = torch.randn(1, 64, 2, 128,
                    generator=torch.Generator().manual_seed(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tdist.process_group_scope():
            mesh = tmesh.make_mesh(device="cpu")
            dq = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim)
            with pytest.raises(TypeError, match="local tensors"):
                tfa.flash_attention(dq, dq, dq)
            # Through the sharded entry the kernel sees local shards.
            out = tfa.flash_attention_sharded(q, q, q, mesh)
            torch.testing.assert_close(out.full_tensor(),
                                       tfa.flash_attention(q, q, q),
                                       rtol=0, atol=0)
    finally:
        torch.set_num_threads(threads)


def test_world_of_one_sharded_trainer_matches_unsharded():
    """The sharded path at world size 1 (the card's configuration): bf16
    compute, full remat, 3 AdamW steps; losses and parameters bit-equal to
    the unsharded Trainer's, grad norms within 1e-6."""
    from tf_operator_tpu_torch.train import trainer as ttr

    cfg = dataclasses.replace(tllama.llama_tiny(vocab_size=256,
                                                max_seq_len=64), remat=True)
    data = np.random.default_rng(0)
    batches = [{"inputs": data.integers(0, 256, (2, 33))} for _ in range(3)]
    runs = {}
    with tdist.process_group_scope():
        mesh = tmesh.make_mesh(tmesh.MeshConfig(dp=-1), device="cpu")
        for sharded in (True, False):
            model = tllama.Llama(cfg, device="cpu")
            kwargs = dict(mesh=mesh, rules=tsharding.LLAMA_RULES,
                          param_axes_fn=tllama.param_logical_axes)
            trainer = ttr.Trainer(model=model, optimizer=ttr.adamw(3e-4),
                                  device="cpu", **(kwargs if sharded else {}))
            state, step = trainer.init(), trainer.make_train_step()
            metrics = [step(state, b)[1] for b in batches]
            params = {n: (p.full_tensor() if sharded else p).detach()
                      for n, p in model.named_parameters()}
            runs[sharded] = ([float(m["loss"]) for m in metrics],
                             [float(m["grad_norm"]) for m in metrics],
                             params)
    (loss_s, norm_s, par_s), (loss_u, norm_u, par_u) = runs[True], runs[False]
    assert loss_s == loss_u
    np.testing.assert_allclose(norm_s, norm_u, rtol=1e-6)
    for name, param in par_u.items():
        assert torch.equal(par_s[name], param), name


def test_local_batch_slices_by_data_index():
    from tf_operator_tpu_torch.train.data import local_batch, multihost_batch

    batch = {"inputs": np.arange(12).reshape(4, 3)}
    with tdist.process_group_scope():
        mesh = tmesh.make_mesh(device="cpu")
        assert tmesh.data_index(mesh) == 0
        np.testing.assert_array_equal(local_batch(batch, mesh)["inputs"],
                                      batch["inputs"])
        glob = multihost_batch(batch, mesh)
        assert tuple(glob["inputs"].shape) == (4, 3)
        np.testing.assert_array_equal(
            local_batch(glob, mesh)["inputs"].numpy(), batch["inputs"])
