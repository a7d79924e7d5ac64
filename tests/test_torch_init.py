"""Port: the sharded-from-birth init and the abstract restore target, in
one process on the CPU (the multi-rank cases are in the gloo world of
``tests/test_torch_distributed.py``).

- Each model built on the meta device and materialised by
  ``Trainer.init()`` is bit for bit the eager build from the same seed:
  every parameter and buffer (BatchNorm statistics and the rotary angles
  included), for Llama, Mixtral, BERT, ResNet (each norm scheme and stem)
  and both MNIST models, and each ``LlamaStage`` of a pipeline, whose
  other stages' draws are replayed and dropped.
- ``Trainer.abstract_state()`` plus ``Checkpointer.restore`` is bit for
  bit the saved state (parameters, buffers, optimizer moments and step),
  and the next step is the uninterrupted run's; its parameters and
  buffers have the names, shapes and dtype of the JAX trainer's
  ``abstract_state`` on the same configuration.
- A parameter with no recorded initialiser raises at materialisation;
  a step from an abstract state that nothing was restored into raises.
- The MNIST payload resumes into ``abstract_state()`` without one draw.
"""

import dataclasses

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
from tf_operator_tpu_torch.models import bert as tbert
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.models import mixtral as tmix
from tf_operator_tpu_torch.models import mnist as tmnist
from tf_operator_tpu_torch.models import resnet as tresnet
from tf_operator_tpu_torch.models.convert import llama_params_from_flax
from tf_operator_tpu_torch.ops import layers
from tf_operator_tpu_torch.parallel.llama_pp import LlamaStage
from tf_operator_tpu_torch.parallel.sharding import materialize
from tf_operator_tpu_torch.train import dist_mnist
from tf_operator_tpu_torch.train import trainer as ttr
from tf_operator_tpu_torch.train.checkpoint import Checkpointer

pytestmark = pytest.mark.compute

LLAMA = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32)


def _resnet(norm, stem="conv7"):
    cfg = dataclasses.replace(tresnet.resnet_tiny(), norm=norm, stem=stem,
                              dtype=torch.float32)
    return lambda device, gen=None: tresnet.ResNet(cfg, device, gen)


# name -> (build(device, generator), loss, optimizer)
MODELS = {
    "llama": (lambda d, g=None: tllama.Llama(LLAMA, d, g), None,
              ttr.adamw(1e-3)),
    "mixtral": (lambda d, g=None: tmix.Mixtral(dataclasses.replace(
        tmix.mixtral_tiny(), dtype=torch.float32), d, g),
        tmix.make_moe_lm_loss(), ttr.adamw(1e-3)),
    "bert": (lambda d, g=None: tbert.Bert(dataclasses.replace(
        tbert.bert_tiny(), dtype=torch.float32), d, g), tbert.mlm_loss,
        ttr.adamw(1e-3)),
    **{f"resnet_{norm}": (_resnet(norm), ttr.classification_loss,
                          ttr.sgd(0.1, momentum=0.9))
       for norm in tresnet.NORMS},
    "resnet_s2d": (_resnet("bn", "s2d"), ttr.classification_loss,
                   ttr.sgd(0.1, momentum=0.9)),
    "mnist_cnn": (lambda d, g=None: tmnist.MnistCNN(device=d, generator=g),
                  ttr.classification_loss, ttr.adam(1e-3)),
    "mnist_mlp": (lambda d, g=None: tmnist.MnistMLP(device=d, generator=g),
                  ttr.classification_loss, ttr.adam(1e-3)),
}


def tensors(model):
    """Every parameter and buffer, persistent or not, by name."""
    out = {n: p.detach() for n, p in model.named_parameters()}
    out.update(dict(model.named_buffers()))
    return out


def assert_bit_equal(got, want):
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name


def batch_for(name):
    rng = np.random.default_rng(1)
    if name in ("llama", "mixtral"):
        return {"inputs": rng.integers(0, 256, (2, 17))}
    if name == "bert":
        tokens = rng.integers(0, 128, (2, 16))
        return {"inputs": tokens, "targets": tokens,
                "mask": (rng.random((2, 16)) < 0.3).astype(np.float32)}
    if name.startswith("resnet"):
        return {"inputs": rng.random((2, 32, 32, 3), dtype=np.float32),
                "labels": rng.integers(0, 10, (2,))}
    return {"inputs": rng.random((2, 28, 28, 1), dtype=np.float32),
            "labels": rng.integers(0, 10, (2,))}


def trainer_for(name, model):
    _, loss, optimizer = MODELS[name]
    return ttr.Trainer(model=model, optimizer=optimizer, device="cpu",
                       **({"loss_fn": loss} if loss else {}))


@pytest.mark.parametrize("name", list(MODELS))
def test_meta_init_is_the_eager_build(name):
    build = MODELS[name][0]
    want = tensors(build("cpu", torch.Generator().manual_seed(7)))
    meta = build("meta", torch.Generator().manual_seed(7))
    assert all(t.is_meta for t in tensors(meta).values())
    state = trainer_for(name, meta).init()
    assert not state.abstract
    assert_bit_equal(tensors(state.model), want)
    # The default generator is the eager build's too: seed 0.
    assert_bit_equal(tensors(trainer_for(name, build("meta")).init().model),
                     tensors(build("cpu")))


@pytest.mark.parametrize("stage", [0, 1])
def test_meta_stage_replays_the_other_stages_draws(stage):
    cfg = dataclasses.replace(LLAMA, n_layers=4)
    meta = LlamaStage(cfg, stage, 2, device="meta")
    assert sorted(meta.layers) == [str(2 * stage), str(2 * stage + 1)]
    assert_bit_equal(tensors(materialize(meta, "cpu")),
                     tensors(LlamaStage(cfg, stage, 2, device="cpu")))
    # ... and the stage's layers are the whole model's.
    whole = tensors(tllama.Llama(cfg, device="cpu"))
    for n, t in tensors(meta).items():
        assert torch.equal(t, whole[n]), n


def saved_and_resumed(name, directory):
    """3 steps from the eager build, saved after the second; then a meta
    build restored into its abstract state. Returns (the state at the
    save, the uninterrupted third step's tensors and loss, the restored
    state, its trainer)."""
    build = MODELS[name][0]
    batch = batch_for(name)
    trainer = trainer_for(name, build("cpu"))
    state = trainer.init()
    step = trainer.make_train_step()
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt = Checkpointer(str(directory))
    ckpt.save(state.step, state)
    ckpt.wait()
    saved = {"step": state.step,
             "tensors": {n: t.clone() for n, t in
                         tensors(state.model).items()},
             "optim": [t.clone() for per in state.opt_state.state.values()
                       for _, t in sorted(per.items())]}
    state, metrics = step(state, batch)
    kept = (tensors(state.model), float(metrics["loss"]))
    again = trainer_for(name, build("meta"))
    restored = again.abstract_state()
    assert restored.abstract
    ckpt.restore(restored)
    ckpt.close()
    return saved, kept, restored, again


@pytest.mark.parametrize("name", ["llama", "resnet_bn", "bert"])
def test_abstract_state_restores_bit_equal(name, tmp_path):
    saved, kept, restored, trainer = saved_and_resumed(name, tmp_path)
    assert not restored.abstract
    assert restored.step == saved["step"]
    assert_bit_equal(tensors(restored.model), saved["tensors"])
    moments = [t for per in restored.opt_state.state.values()
               for _, t in sorted(per.items())]
    assert len(moments) == len(saved["optim"])
    for got, want in zip(moments, saved["optim"]):
        assert torch.equal(got, want)
    _, metrics = trainer.make_train_step()(restored, batch_for(name))
    assert float(metrics["loss"]) == kept[1]
    assert_bit_equal(tensors(restored.model), kept[0])


def test_abstract_state_matches_jax_abstract_state():
    """The port's restore target has the parameters of the JAX trainer's
    (names after ``convert.py``, shapes, f32), and the rotary angles."""
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **{
        f.name: getattr(LLAMA, f.name) for f in dataclasses.fields(LLAMA)
        if f.name not in ("dtype", "remat_policy", "attention_impl",
                          "decode")})
    trainer = jtr.Trainer(
        model=jllama.Llama(jcfg), param_axes_fn=jllama.param_logical_axes,
        rules=LLAMA_RULES, mesh=make_mesh(MeshConfig(),
                                          devices=jax.devices()[:1]),
        optimizer=optax.adamw(1e-3))
    sample = {"inputs": jnp.zeros((2, 17), jnp.int32)}
    abstract = trainer.abstract_state(jax.random.PRNGKey(0), sample)
    want = llama_params_from_flax(jax.tree.map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype), abstract.params),
        LLAMA)
    state = ttr.Trainer(model=tllama.Llama(LLAMA, device="meta"),
                        optimizer=ttr.adamw(1e-3),
                        device="cpu").abstract_state()
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    for n, t in want.items():
        assert got[n].shape == t.shape and got[n].dtype == t.dtype, n
        assert got[n].device.type == "cpu", n
    assert torch.equal(state.model.angles, layers.rope_frequencies(
        LLAMA.head_dim, LLAMA.max_seq_len, LLAMA.rope_theta))


def test_a_step_from_an_unrestored_abstract_state_raises():
    trainer = trainer_for("llama", MODELS["llama"][0]("meta"))
    state = trainer.abstract_state()
    with pytest.raises(RuntimeError, match="restore"):
        trainer.make_train_step()(state, batch_for("llama"))
    assert state.step == 0 and not state.opt_state.state


def test_abstract_state_needs_a_meta_model():
    with pytest.raises(ValueError, match="meta"):
        trainer_for("llama", MODELS["llama"][0]("cpu")).abstract_state()


def test_a_parameter_with_no_initialiser_raises():
    model = MODELS["llama"][0]("meta")
    model.layers[1].extra = nn.Parameter(torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="layers.1.extra"):
        trainer_for("llama", model).init()
    assert model.layers[1].extra.is_meta    # nothing was allocated
    # A layer built on meta outside a model's build records nothing.
    dense = tllama.Dense(4, 8, torch.float32, "meta", None)
    with pytest.raises(ValueError, match="meta device"):
        materialize(dense, "cpu")
    dense.init_record = layers.InitRecord()
    with pytest.raises(ValueError, match="weight"):
        materialize(dense, "cpu")


def test_mnist_payload_resumes_without_drawing(tmp_path, monkeypatch):
    args = ["--steps", "4", "--batch-size", "8", "--checkpoint-dir",
            str(tmp_path), "--device", "cpu"]
    assert dist_mnist.main(args + ["--crash-at-step", "2"]) == 137
    draws = []
    fill = layers.Init.fill_

    def counted(self, tensor, generator):
        draws.append(self.draws)
        return fill(self, tensor, generator)

    monkeypatch.setattr(layers.Init, "fill_", counted)
    assert dist_mnist.main(args) == 0
    assert not any(draws), f"{sum(draws)} draws on resume"
    # A fresh start draws every weight (4 layers), so the count sees them.
    draws.clear()
    assert dist_mnist.main(args[:4] + ["--checkpoint-dir",
                                       str(tmp_path / "fresh"),
                                       "--device", "cpu"]) == 0
    assert sum(draws) == 4
