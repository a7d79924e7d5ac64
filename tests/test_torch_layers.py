"""Port parity: tf_operator_tpu_torch.ops.layers against the JAX layers.

The same numpy inputs (fixed seed) go through both; f32 agrees within
2e-5, bf16 within 2e-2 (the reference's flash-test tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import layers as jl
from tf_operator_tpu_torch.ops import layers as tl

pytestmark = pytest.mark.compute

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 8, 64), _rand(rng, 64)
    want = jl.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale))
    got = tl.rms_norm(torch.tensor(x).to(getattr(torch, dtype)),
                      torch.tensor(scale))
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_rope_frequencies():
    want = jl.rope_frequencies(128, 64, theta=500000.0)
    got = tl.rope_frequencies(128, 64, theta=500000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(positions, dtype):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 16, 4, 32)
    pos = rng.integers(0, 64, (2, 16)) if positions else None
    want = jl.apply_rope(jnp.asarray(x, dtype), jl.rope_frequencies(32, 64),
                         None if pos is None else jnp.asarray(pos))
    got = tl.apply_rope(torch.tensor(x).to(getattr(torch, dtype)),
                        tl.rope_frequencies(32, 64),
                        None if pos is None else torch.tensor(pos))
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_repeat_kv():
    x = _rand(np.random.default_rng(2), 2, 8, 2, 16)
    want = jl.repeat_kv(jnp.asarray(x), 3)
    got = tl.repeat_kv(torch.tensor(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tl.repeat_kv(torch.tensor(x), 1).shape == x.shape


@pytest.mark.parametrize("case", ["causal", "non_causal", "q_offset", "mask",
                                  "bf16"])
def test_attention(case):
    rng = np.random.default_rng(3)
    s, t = (8, 24) if case == "q_offset" else (16, 16)
    q, k, v = (_rand(rng, 2, n, 4, 32, scale=0.5) for n in (s, t, t))
    causal = case != "non_causal"
    q_offset = 16 if case == "q_offset" else 0
    mask = rng.random((2, 1, s, t)) > 0.3 if case == "mask" else None
    dtype = "bfloat16" if case == "bf16" else "float32"
    want = jl.attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal,
        mask=None if mask is None else jnp.asarray(mask), q_offset=q_offset)
    got = tl.attention(
        *(torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=causal, mask=None if mask is None else torch.tensor(mask),
        q_offset=q_offset)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
