"""Port parity: ring attention
(``tf_operator_tpu_torch/ops/ring_attention.py``) against the JAX
package's ``ops/ring_attention.py``.

The port's ring runs here as n lanes stepped in lock step in one process
(a hop that rotates the list of lanes), the flash ring through the
kernels' plain versions; the JAX ring runs under ``shard_map`` on n of the
virtual CPU devices ``conftest`` forces, its Pallas kernels in interpret
mode. Both are held to the dense reference and to each other with
``tests/test_models_parallel.py``'s ``TestRingFlash`` tolerances: outputs
2e-5, gradients rtol 1e-4 and atol 1e-6. The rings across processes (the
``sp`` group of a mesh) are in ``tests/test_torch_distributed.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import ring_attention as jra
from tf_operator_tpu.ops.layers import attention as jattention
from tf_operator_tpu.ops.layers import repeat_kv as jrepeat_kv
from tf_operator_tpu.parallel.mesh import MeshConfig as JMeshConfig
from tf_operator_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_operator_tpu_torch.ops import ring_attention as ra
from tf_operator_tpu_torch.ops.layers import attention, repeat_kv

pytestmark = pytest.mark.compute

B, S, H, D = 2, 256, 4, 128
OUT_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def rotate(lanes, reverse=False):
    """The lock-step hop: lane i receives lane i-1's payload (i+1's when
    reversed)."""
    return lanes[1:] + lanes[:1] if reverse else lanes[-1:] + lanes[:-1]


def virtual_ring(n):
    return ra.Ring(rotate, tuple(range(n)), n)


def inputs(h_kv, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return mk(B, S, H, D), mk(B, S, h_kv, D), mk(B, S, h_kv, D)


def port_ring(q, k, v, n, causal, impl):
    """Output and (q, k, v) gradients of mean(out²) through the port's
    ring on n lock-step lanes."""
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    blocks = lambda x: list(x.chunk(n, dim=1))
    kk, vv = k, v
    if impl == "einsum":
        kk, vv = (repeat_kv(x, H // k.shape[2]) for x in (k, v))
    fn = ra._ring_flash_lanes if impl == "flash" else ra._ring_attention_lanes
    out = torch.cat(fn(blocks(q), blocks(kk), blocks(vv), virtual_ring(n),
                       causal), dim=1)
    grads = torch.autograd.grad((out ** 2).mean(), (q, k, v))
    return out.detach().numpy(), [g.numpy() for g in grads]


def dense(q, k, v, causal):
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    group = H // k.shape[2]
    out = attention(q, repeat_kv(k, group), repeat_kv(v, group),
                    causal=causal)
    grads = torch.autograd.grad((out ** 2).mean(), (q, k, v))
    return out.detach().numpy(), [g.numpy() for g in grads]


def jax_ring(q, k, v, n, causal, impl):
    mesh = jmake_mesh(JMeshConfig(sp=n), devices=jax.devices()[:n])

    def loss(q, k, v):
        out = jra.ring_attention_sharded(mesh, q, k, v, causal=causal,
                                         head_axis=None, impl=impl)
        return (out ** 2).mean(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def assert_close(got, want, what):
    out, grads = got
    np.testing.assert_allclose(out, want[0], rtol=OUT_TOL, atol=OUT_TOL,
                               err_msg=f"{what} out")
    for name, a, b in zip("qkv", grads, want[1]):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what} d{name}")


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [H, 2], ids=["mha", "gqa"])
def test_lock_step_ring_matches_dense_and_jax(n, causal, h_kv):
    """Both rings of the port against the dense reference; against JAX,
    the flash ring with GQA KV (which it reads directly) and the einsum
    ring with full heads (which it needs)."""
    q, k, v = inputs(h_kv, seed=n * 10 + causal)
    ref = dense(q, k, v, causal)
    got = {impl: port_ring(q, k, v, n, causal, impl)
           for impl in ("flash", "einsum")}
    for impl, result in got.items():
        assert_close(result, ref, f"{impl} vs dense")
    impl = "flash" if h_kv < H else "einsum"
    assert_close(got[impl], jax_ring(q, k, v, n, causal, impl),
                 f"{impl} vs JAX")


@pytest.mark.parametrize("visible", [True, False])
@pytest.mark.parametrize("masked_acc", [False, True])
def test_merge_block_matches_jax(visible, masked_acc):
    """One block folded into a running (out, lse), against JAX's; with the
    running lse at -1e30 and the block masked, both inputs are masked."""
    rng = np.random.default_rng(3)
    acc_o = rng.standard_normal((B, 64, H, D)).astype(np.float32)
    o = rng.standard_normal((B, 64, H, D)).astype(np.float32)
    acc_lse = rng.standard_normal((B, H, 64)).astype(np.float32) * 3
    lse = rng.standard_normal((B, H, 64)).astype(np.float32) * 3
    if masked_acc:
        acc_lse[:] = -1e30
    got_o, got_lse = ra._merge_block(
        torch.tensor(acc_o), torch.tensor(acc_lse), torch.tensor(o),
        torch.tensor(lse), visible)
    # JAX's layout is [B, H, S, D].
    want_o, want_lse = jra._merge_block(
        jnp.asarray(acc_o.transpose(0, 2, 1, 3)), jnp.asarray(acc_lse),
        jnp.asarray(o.transpose(0, 2, 1, 3)), jnp.asarray(lse),
        jnp.bool_(visible))
    np.testing.assert_allclose(got_o.numpy(),
                               np.asarray(want_o).transpose(0, 2, 1, 3),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(got_o.numpy()).all()


def test_unsupported_block_raises_clearly():
    with pytest.raises(ValueError, match="unsupported"):
        ra._ring_flash_lanes([torch.zeros(1, 16, 2, 16)],
                             [torch.zeros(1, 16, 2, 16)],
                             [torch.zeros(1, 16, 2, 16)], virtual_ring(1),
                             causal=True)


def test_auto_routing_picks_the_right_impl(monkeypatch):
    """impl="auto" runs the flash ring on blocks the kernels take and the
    einsum ring (GQA KV repeated) otherwise, as the JAX wrapper does."""
    from tf_operator_tpu_torch.parallel.distributed import (
        process_group_scope,
    )
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    calls = []
    for name in ("ring_flash_attention", "ring_attention"):
        real = getattr(ra, name)
        monkeypatch.setattr(ra, name, lambda *a, _real=real, _name=name,
                            **kw: calls.append(_name) or _real(*a, **kw))
    q, k, v = inputs(2, seed=7)
    with process_group_scope():
        mesh = make_mesh(MeshConfig(sp=1), device="cpu")
        out = ra.ring_attention_sharded(*map(torch.tensor, (q, k, v)), mesh)
        assert calls[-1] == "ring_flash_attention"
        np.testing.assert_allclose(out.full_tensor().numpy(),
                                   dense(q, k, v, True)[0], rtol=OUT_TOL,
                                   atol=OUT_TOL)
        # head_dim 16 is no kernel shape: the einsum ring, KV repeated.
        small = [x[:, :32, :, :16] for x in (q, k, v)]
        out = ra.ring_attention_sharded(*map(torch.tensor, small), mesh)
        assert calls[-1] == "ring_attention"
        want = jattention(*(jnp.asarray(small[0]),) + tuple(
            jrepeat_kv(jnp.asarray(x), 2) for x in small[1:]), causal=True)
        np.testing.assert_allclose(out.full_tensor().numpy(),
                                   np.asarray(want), rtol=OUT_TOL,
                                   atol=OUT_TOL)
    assert ra.resolve_impl("auto", 64, 128, 4, 3) == "einsum"
    with pytest.raises(ValueError, match="unknown ring impl"):
        ra.resolve_impl("ring", 64, 128, 4, 2)
