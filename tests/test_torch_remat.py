"""Port parity: the remat policies and the flash op they save.

A 2-layer model at head_dim 128 (hidden 256, 2 heads, 1 KV head, mlp 512,
vocab 512) in f32, B=2, S=128, on the flash path (the plain versions on
the CPU; the JAX side runs its Pallas kernels in interpret mode). Under
each of ``save_attn``, ``save_qkv`` and ``mlp_only``: loss and every grad
within 1e-6 of the port's ``full`` and within 5e-4 of the JAX model at
the same policy, and one forward flash call a layer and step where
``full`` makes two.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.train.trainer import cross_entropy_loss as j_ce
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.models.convert import llama_params_from_flax
from tf_operator_tpu_torch.ops import flash_attention as tfa
from tf_operator_tpu_torch.train.trainer import lm_loss

pytestmark = pytest.mark.compute

FIELDS = dict(vocab_size=512, hidden=256, n_layers=2, n_heads=2,
              n_kv_heads=1, head_dim=128, mlp_dim=512, max_seq_len=256,
              rope_theta=10000.0, remat=True, attention_impl="flash")
B, S = 2, 128
POLICIES = ["save_attn", "save_qkv", "mlp_only"]


@pytest.fixture(scope="module")
def flax_params():
    jmodel = jllama.Llama(jllama.LlamaConfig(dtype=jnp.float32, **FIELDS))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S + 1))


def port_model(policy, params, **fields):
    cfg = tllama.LlamaConfig(dtype=torch.float32,
                             **dict(FIELDS, remat_policy=policy, **fields))
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(params, cfg))
    return model


def port_loss_and_grads(model, toks, monkeypatch=None):
    """(loss, grads by name, forward flash calls) of one training step."""
    calls = []
    if monkeypatch is not None:
        fwd = tfa._fwd
        monkeypatch.setattr(tfa, "_fwd", lambda *a: calls.append(1) or fwd(*a))
    loss = lm_loss(model, {"inputs": torch.tensor(toks)})
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}, len(calls)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_full_with_one_forward_a_layer(policy, flax_params,
                                                      monkeypatch):
    toks = tokens(1)
    full = port_model("full", flax_params)
    other = port_model(policy, flax_params)
    assert [n for n, _ in other.named_parameters()] == \
        [n for n, _ in full.named_parameters()]
    loss_a, grads_a, calls_a = port_loss_and_grads(full, toks, monkeypatch)
    monkeypatch.undo()
    loss_b, grads_b, calls_b = port_loss_and_grads(other, toks, monkeypatch)
    layers = FIELDS["n_layers"]
    assert (calls_a, calls_b) == (2 * layers, layers)
    assert loss_b == pytest.approx(loss_a, abs=1e-6)
    for name, grad in grads_a.items():
        torch.testing.assert_close(grads_b[name], grad, atol=1e-6, rtol=1e-6,
                                   msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_at_the_same_policy(policy, flax_params):
    toks = tokens(2)
    jcfg = jllama.LlamaConfig(dtype=jnp.float32,
                              **dict(FIELDS, remat_policy=policy))
    jmodel = jllama.Llama(jcfg)

    def loss_of(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(toks[:, :-1]))
        return j_ce(logits, jnp.asarray(toks[:, 1:]))

    j_loss, j_grads = jax.value_and_grad(loss_of)(flax_params)
    model = port_model(policy, flax_params)
    want = llama_params_from_flax(jax.tree.map(np.asarray, j_grads),
                                  model.cfg)
    t_loss, got, _ = port_loss_and_grads(model, toks)
    np.testing.assert_allclose(t_loss, float(j_loss), atol=5e-4, rtol=5e-4)
    assert set(got) == set(want)
    for name, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                   atol=5e-4, rtol=5e-4, err_msg=name)


@pytest.mark.parametrize("policy", ["save_attn", "save_qkv"])
def test_xla_path_saves_no_flash_outputs(policy, flax_params, monkeypatch):
    """Off the flash path the flash op never runs and the policy gives
    full's numbers, as in JAX."""
    toks = tokens(3)
    loss_a, grads_a, _ = port_loss_and_grads(
        port_model("full", flax_params, attention_impl="xla"), toks)
    loss_b, grads_b, calls = port_loss_and_grads(
        port_model(policy, flax_params, attention_impl="xla"), toks,
        monkeypatch)
    assert calls == 0
    assert loss_b == pytest.approx(loss_a, abs=1e-6)
    for name, grad in grads_a.items():
        torch.testing.assert_close(grads_b[name], grad, atol=1e-6, rtol=1e-6,
                                   msg=name)


def test_unknown_policy_raises_naming_it():
    cfg = dataclasses.replace(tllama.llama_tiny(), remat=True,
                              remat_policy="save-attn")
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.Llama(cfg, device="cpu")


def _qkv(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen, requires_grad=True)
            for shape in ((1, 64, 2, 128), (1, 64, 1, 128), (1, 64, 1, 128))]


def test_flash_op_lse_is_not_differentiable():
    """JAX's _guard_lse_nondiff contract: gradients never flow through
    lse; asking for one raises instead of giving zeros."""
    q, k, v = _qkv()
    out, lse = tfa._flash_fwd_op(q, k, v, True, 0)
    assert out.requires_grad and not lse.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(lse.sum(), q)
    dq, = torch.autograd.grad(out.sum(), q)
    want, = torch.autograd.grad(tfa.flash_attention(q, k, v).sum(), q)
    torch.testing.assert_close(dq, want, atol=0, rtol=0)


def test_flash_and_name_ops_pass_opcheck():
    """Schema, autograd registration and fake (meta) implementations of
    the two custom ops agree with their eager results."""
    q, k, v = _qkv(1)
    torch.library.opcheck(tfa._flash_fwd_op, (q, k, v, True, 0))
    torch.library.opcheck(tfa.checkpoint_name, (q, "attn_q"))


def test_checkpoint_name_is_identity():
    q, _, _ = _qkv(2)
    named = tfa.checkpoint_name(q, "attn_q")
    assert torch.equal(named, q) and named.data_ptr() != q.data_ptr()
    grad = torch.randn_like(q)
    got, = torch.autograd.grad(named, q, grad)
    assert torch.equal(got, grad)
