"""Port parity: the port's Llama incremental decode against the flax model's.

The cases of ``tests/test_llama_decode.py`` (the tp=2 mesh smoke aside) on
both packages: ``llama_tiny(vocab_size=64, max_seq_len=32)`` in f32 with
the flax parameters carried over by ``llama_params_from_flax``, the same
numpy tokens through each package's ``init_cache``/``prefill``/
``decode_step``/``insert_cache``. Logits agree with the JAX logits within
1e-5 (the JAX suite's own tolerance), the caches leaf for leaf, also past
``max_seq_len``, where JAX clamps the cache row written and the rotary
angle read. bf16 is judged against the logits' scale, as in
``tests/test_torch_llama.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.ops import layers as jlayers
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.models.convert import (
    llama_cache_from_flax,
    llama_cache_to_flax,
    llama_params_from_flax,
)
from tf_operator_tpu_torch.ops import layers as tlayers

pytestmark = pytest.mark.compute

ATOL = 1e-5
VOCAB, MAX_SEQ = 64, 32


class JaxSide:
    """The JAX helper contract, on numpy in and out."""

    def __init__(self, dtype=jnp.float32, params=None):
        cfg = dataclasses.replace(jllama.llama_tiny(VOCAB, MAX_SEQ),
                                  dtype=dtype)
        self.train_model = jllama.Llama(cfg)
        if params is None:
            params = self.train_model.init(
                jax.random.PRNGKey(0), jnp.zeros((2, 12), jnp.int32))["params"]
            params = jax.tree.map(np.asarray, params)
        self.params = params
        self.model = jllama.Llama(dataclasses.replace(cfg, decode=True))
        self._prefill = jax.jit(lambda p, c, t, pos: jllama.prefill(
            self.model, p, c, t, pos))

    def full(self, toks):
        return np.asarray(self.train_model.apply({"params": self.params},
                                                 jnp.asarray(toks)),
                          np.float32)

    def init(self, batch):
        return jllama.init_cache(self.model, self.params, batch)

    def prefill(self, cache, toks, pos):
        logits, cache = self._prefill(self.params, cache,
                                      jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(pos, jnp.int32))
        return np.asarray(logits, np.float32), cache

    def insert(self, cache, one, slot):
        return jllama.insert_cache(cache, one, slot)

    def cache_np(self, cache):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), cache)


class TorchSide:
    """The port's helper contract on the CPU, on numpy in and out."""

    def __init__(self, params, dtype=torch.float32):
        cfg = dataclasses.replace(tllama.llama_tiny(VOCAB, MAX_SEQ),
                                  dtype=dtype)
        state = llama_params_from_flax(params, cfg)
        self.train_model = tllama.Llama(cfg, device="cpu")
        self.train_model.load_state_dict(state)
        self.model = tllama.Llama(dataclasses.replace(cfg, decode=True),
                                  device="cpu")
        self.model.load_state_dict(state)

    def full(self, toks):
        with torch.no_grad():
            return self.train_model(torch.as_tensor(toks)).float().numpy()

    def init(self, batch):
        return tllama.init_cache(self.model, batch)

    def prefill(self, cache, toks, pos):
        logits, cache = tllama.prefill(
            self.model, cache, torch.as_tensor(np.asarray(toks)),
            torch.as_tensor(np.array(pos), dtype=torch.long))
        return logits.float().numpy(), cache

    def insert(self, cache, one, slot):
        return tllama.insert_cache(cache, one, slot)

    def cache_np(self, cache):
        return llama_cache_to_flax(cache)


def arange_rows(b, start, stop):
    return np.broadcast_to(np.arange(start, stop), (b, stop - start))


# Scenarios: each runs on one side and returns (logits as [B, S, V] or
# per-slot [B, V], the final cache).

def prefill_full(side, toks):
    b, s = toks.shape
    return side.prefill(side.init(b), toks, arange_rows(b, 0, s))


def prefill_then_decode(side, toks, split=5, cache=None):
    """Prefill ``split`` tokens (unless a cache holding them is given),
    then one decode step per remaining token."""
    b, s = toks.shape
    outs = []
    if cache is None:
        out, cache = side.prefill(side.init(b), toks[:, :split],
                                  arange_rows(b, 0, split))
        outs.append(out)
    for t in range(split, s):
        out, cache = side.prefill(cache, toks[:, t:t + 1],
                                  np.full((b, 1), t))
        outs.append(out)
    return np.concatenate(outs, axis=1), cache


def staggered_slots(side, toks, lens=(4, 9)):
    """Two sequences prefilled separately on a 1-row cache, inserted into
    their slots, then decoded together at different positions."""
    cache, stage = side.init(2), side.init(1)
    for slot, n in enumerate(lens):
        _, stage = side.prefill(stage, toks[slot:slot + 1, :n],
                                arange_rows(1, 0, n))
        cache = side.insert(cache, stage, slot)
    step = np.stack([toks[0, lens[0]], toks[1, lens[1]]])[:, None]
    out, cache = side.prefill(cache, step, np.asarray(lens)[:, None])
    return out[:, 0], cache


def padded_prefill(side, toks, n=6, pad=10):
    """Prefill padded past the prompt (the runner's buckets), then decode
    through the padded rows."""
    b, s = toks.shape
    padded = np.zeros((b, pad), np.int64)
    padded[:, :n] = toks[:, :n]
    out, cache = side.prefill(side.init(b), padded, arange_rows(b, 0, pad))
    rest, cache = prefill_then_decode(side, toks, split=n, cache=cache)
    return np.concatenate([out[:, :n], rest], axis=1), cache


def past_max_seq_len(side, toks):
    """Decode to position 39 with max_seq_len 32: JAX clamps the written
    row to 31 and the rotary angle to the last one."""
    return prefill_then_decode(side, toks, split=20)


SCENARIOS = {
    "prefill": (prefill_full, 12),
    "prefill_then_decode": (prefill_then_decode, 12),
    "staggered_insert_cache": (staggered_slots, 12),
    "padded_prefill_tail": (padded_prefill, 12),
    "past_max_seq_len": (past_max_seq_len, 40),
}


def tokens(seq, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (2, seq))


@pytest.fixture(scope="module")
def sides():
    jside = JaxSide()
    return jside, TorchSide(jside.params)


def assert_same_cache(got, want):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        np.testing.assert_allclose(flat_got[path], leaf, atol=ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_decode_matches_jax(name, sides):
    """Logits within 1e-5 of JAX's decode path and, inside max_seq_len, of
    the full forward; the caches equal leaf for leaf."""
    jside, tside = sides
    scenario, seq = SCENARIOS[name]
    toks = tokens(seq)
    want, jcache = scenario(jside, toks)
    got, tcache = scenario(tside, toks)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_same_cache(tside.cache_np(tcache), jside.cache_np(jcache))
    if seq <= MAX_SEQ:
        full = jside.full(toks)
        if name == "staggered_insert_cache":
            full = full[[0, 1], [4, 9]]
        np.testing.assert_allclose(got, full, atol=ATOL)


def test_decode_continues_from_a_jax_cache(sides):
    """A cache prefilled by JAX, carried over by llama_cache_from_flax,
    decodes in the port to JAX's logits."""
    jside, tside = sides
    toks = tokens(12, seed=1)
    want, _ = prefill_then_decode(jside, toks)
    _, jcache = jside.prefill(jside.init(2), toks[:, :5], arange_rows(2, 0, 5))
    cache = llama_cache_from_flax(jside.cache_np(jcache), tside.model.cfg)
    got, _ = prefill_then_decode(tside, toks, cache=cache)
    np.testing.assert_allclose(got, want[:, 5:], atol=ATOL)


def test_helpers_update_the_cache_in_place(sides):
    _, tside = sides
    cache, one = tside.init(2), tside.init(1)
    k, v = cache["k"], cache["v"]
    assert k.shape == (2, 2, MAX_SEQ, 2, 16) and k.dtype == torch.float32
    assert not k.any()
    _, back = tside.prefill(one, tokens(3)[:1], arange_rows(1, 0, 3))
    assert back is one and one["k"][:, 0, :3].abs().sum() > 0
    assert not one["k"][:, 0, 3:].any()
    assert tllama.insert_cache(cache, one, 1) is cache
    assert cache["k"] is k and cache["v"] is v
    torch.testing.assert_close(cache["k"][:, 1], one["k"][:, 0], rtol=0,
                               atol=0)
    assert not cache["k"][:, 0].any()


def test_decode_model_shares_param_tree(sides):
    """A training state_dict loads unchanged into the decode model."""
    _, tside = sides
    assert (tside.model.state_dict().keys()
            == tside.train_model.state_dict().keys())
    tside.model.load_state_dict(tside.train_model.state_dict(), strict=True)


def test_decode_requires_positions_and_cache(sides):
    _, tside = sides
    toks = torch.as_tensor(tokens(4))
    with pytest.raises(ValueError, match="positions"):
        tside.model(toks, cache=tside.init(2))
    with pytest.raises(ValueError, match="cache"):
        tside.model(toks, positions=torch.zeros_like(toks))
    with pytest.raises(ValueError, match="decode=True"):
        tllama.prefill(tside.train_model, tside.init(2), toks,
                       torch.zeros_like(toks))


def test_training_forward_unchanged_by_decode_field(sides):
    jside, tside = sides
    toks = tokens(12)
    got = tside.full(toks)
    np.testing.assert_allclose(got, jside.full(toks), atol=ATOL)
    np.testing.assert_array_equal(tside.full(toks), got)


def test_bf16_decode_matches_jax(sides):
    """bf16 cached logits against JAX's bf16 decode path, judged against
    the logits' scale (XLA's CPU bf16 ``logistic`` is not correctly
    rounded, see tests/test_torch_llama.py), and no further from the f32
    model than JAX's bf16 run is (x1.25)."""
    jside, _ = sides
    jbf = JaxSide(jnp.bfloat16, jside.params)
    tbf = TorchSide(jside.params, torch.bfloat16)
    toks = tokens(12, seed=2)
    want, _ = prefill_then_decode(jbf, toks)
    got, _ = prefill_then_decode(tbf, toks)
    truth = jside.full(toks)
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, want) <= 2e-2
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert rel(got, truth) <= 1.25 * rel(want, truth)


@pytest.mark.parametrize("positions", [
    [[0, 5, 31]],                   # in range
    [[30, 31, 32], [12, 40, 99]],   # past the table: clamped to the last
])
def test_apply_rope_indexes_as_jax(positions):
    rng = np.random.default_rng(3)
    pos = np.asarray(positions)
    x = rng.standard_normal((pos.shape[0], pos.shape[1], 2, 16)
                           ).astype(np.float32)
    want = jlayers.apply_rope(jnp.asarray(x),
                              jlayers.rope_frequencies(16, MAX_SEQ),
                              jnp.asarray(pos))
    got = tlayers.apply_rope(torch.as_tensor(x),
                             tlayers.rope_frequencies(16, MAX_SEQ),
                             torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_cache_bridge_raises_on_leftover_and_missing(sides):
    jside, tside = sides
    flax_cache = jside.cache_np(jside.init(1))
    cfg = tside.model.cfg
    extra = {"blocks": dict(flax_cache["blocks"], mlp={"k": np.zeros(1)})}
    with pytest.raises(KeyError, match="left over"):
        llama_cache_from_flax(extra, cfg)
    with pytest.raises(KeyError, match="blocks/attn/v"):
        llama_cache_from_flax(
            {"blocks": {"attn": {"k": flax_cache["blocks"]["attn"]["k"]}}},
            cfg)
    with pytest.raises(KeyError, match="expected"):
        llama_cache_to_flax({"k": torch.zeros(1)})
