"""Port parity: the port's Mixtral incremental decode and MixtralRunner
against the JAX package's.

The cases of ``tests/test_mixtral_decode.py`` (``mixtral_tiny(64, 32)`` in
f32 from flax weights, seed 0, tokens [2, 12]) with the JAX drop-free full
forward (capacity_factor = n_experts) as the reference, within its ATOL
(2e-5): prefill, prefill plus decode steps, batch independence, staggered
``insert_cache``; a missing ``positions`` raises; the training forward is
unchanged by the decode field; a dropping reference differs from decode.
The cache after a prefill equals the JAX one (the Llama cache bridge). The
port's ``MixtralRunner`` on the CPU and the JAX one on the same f32 weights
give identical greedy tokens, and the port's worker with ``--runner
mixtral --device cpu`` answers a spool of requests.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import mixtral as jmix
from tf_operator_tpu.serve import batcher as jbatcher
from tf_operator_tpu.serve import engine as jengine
from tf_operator_tpu.serve import queue as jqueue
from tf_operator_tpu.serve import runner as jrunner
from tf_operator_tpu_torch.models import mixtral as tmix
from tf_operator_tpu_torch.models.convert import (
    llama_cache_from_flax,
    mixtral_params_from_flax,
)
from tf_operator_tpu_torch.serve import batcher as tbatcher
from tf_operator_tpu_torch.serve import engine as tengine
from tf_operator_tpu_torch.serve import queue as tqueue
from tf_operator_tpu_torch.serve import runner as trunner
from tf_operator_tpu_torch.serve import worker as tworker

pytestmark = pytest.mark.compute

ATOL = 2e-5
VOCAB, MAX_SEQ = 64, 32
SPLIT = 5


def tcfg_of(jcfg, **fields):
    """The port's config with the JAX one's fields, f32."""
    names = {f.name for f in dataclasses.fields(tmix.MixtralConfig)}
    return tmix.MixtralConfig(**{**{n: getattr(jcfg, n) for n in names
                                    if n != "dtype"},
                                 "dtype": torch.float32, **fields})


@pytest.fixture(scope="module")
def setup():
    base = dataclasses.replace(jmix.mixtral_tiny(vocab_size=VOCAB,
                                                 max_seq_len=MAX_SEQ),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(base, capacity_factor=float(base.n_experts))
    model = jmix.Mixtral(cfg)
    rng = jax.random.PRNGKey(0)
    tokens = jax.random.randint(rng, (2, 12), 0, cfg.vocab_size)
    params = model.init(rng, tokens)["params"]
    full, _aux = model.apply({"params": params}, tokens)
    tcfg = tcfg_of(cfg, decode=True)
    state = mixtral_params_from_flax(jax.tree.map(np.asarray, params), tcfg)
    decode_model = tmix.Mixtral(tcfg, device="cpu")
    decode_model.load_state_dict(state)
    return (cfg, params, state, decode_model, torch.tensor(
        np.asarray(tokens)), np.asarray(full))


def arange(n, b=1):
    return torch.arange(n).expand(b, n)


def test_decode_model_shares_param_tree(setup):
    cfg, _, state, decode_model, _, _ = setup
    train_model = tmix.Mixtral(tcfg_of(cfg), device="cpu")
    assert ({n: p.shape for n, p in train_model.state_dict().items()}
            == {n: p.shape for n, p in decode_model.state_dict().items()})
    train_model.load_state_dict(state)


def test_prefill_matches_full_forward(setup):
    _, _, _, model, tokens, full = setup
    b, s = tokens.shape
    cache = tmix.init_cache(model, b)
    logits, cache = tmix.prefill(model, cache, tokens, arange(s, b))
    np.testing.assert_allclose(logits.numpy(), full, atol=ATOL)


def test_prefill_cache_matches_jax(setup):
    """The cache a prefill leaves equals the flax cache collection's,
    through the Llama cache bridge (one layout in both families)."""
    cfg, params, _, model, tokens, _ = setup
    b, s = tokens.shape
    jdecode = jmix.Mixtral(dataclasses.replace(cfg, decode=True))
    jcache = jmix.init_cache(jdecode, params, b)
    _, jcache = jmix.prefill(jdecode, params, jcache,
                             jnp.asarray(tokens.numpy()),
                             jnp.broadcast_to(jnp.arange(s), (b, s)))
    want = llama_cache_from_flax(jax.tree.map(np.asarray, jcache),
                                 model.cfg)
    cache = tmix.init_cache(model, b)
    _, cache = tmix.prefill(model, cache, tokens, arange(s, b))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)


def test_prefill_plus_n_decode_steps_match(setup):
    _, _, _, model, tokens, full = setup
    b, s = tokens.shape
    cache = tmix.init_cache(model, b)
    logits, cache = tmix.prefill(model, cache, tokens[:, :SPLIT],
                                 arange(SPLIT, b))
    np.testing.assert_allclose(logits.numpy(), full[:, :SPLIT], atol=ATOL)
    for t in range(SPLIT, s):
        logits, cache = tmix.decode_step(model, cache, tokens[:, t:t + 1],
                                         torch.full((b, 1), t))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t],
                                   atol=ATOL)


def test_decode_batch_independence(setup):
    """One sequence decoded alone gives the logits it gives in a batch:
    drop-free routing makes a token's experts independent of the rest."""
    _, _, _, model, tokens, full = setup
    s = tokens.shape[1]
    cache = tmix.init_cache(model, 1)
    logits, _ = tmix.prefill(model, cache, tokens[:1], arange(s))
    np.testing.assert_allclose(logits[0].numpy(), full[0], atol=ATOL)


def test_insert_cache_staggered_slots(setup):
    """Two sequences prefilled separately, inserted into their slots, then
    one batched decode step at different positions."""
    _, _, _, model, tokens, full = setup
    lens = (4, 9)
    cache = tmix.init_cache(model, 2)
    stage = tmix.init_cache(model, 1)
    for slot, n in enumerate(lens):
        _, stage = tmix.prefill(model, stage, tokens[slot:slot + 1, :n],
                                arange(n))
        cache = tmix.insert_cache(cache, stage, slot)
    step_tokens = torch.stack([tokens[0, lens[0]], tokens[1, lens[1]]])
    logits, _ = tmix.decode_step(model, cache, step_tokens[:, None],
                                 torch.tensor(lens)[:, None])
    for slot, n in enumerate(lens):
        np.testing.assert_allclose(logits[slot, 0].numpy(), full[slot, n],
                                   atol=ATOL)


def test_decode_requires_positions(setup):
    _, _, _, model, tokens, _ = setup
    cache = tmix.init_cache(model, 2)
    with pytest.raises(ValueError, match="positions"):
        model(tokens, cache=cache)
    with pytest.raises(ValueError, match="decode=True"):
        tmix.prefill(tmix.Mixtral(dataclasses.replace(model.cfg,
                                                      decode=False),
                                  device="cpu"), cache, tokens,
                     arange(tokens.shape[1], 2))


def test_training_forward_unchanged_by_decode_field(setup):
    """decode=False is the training path: the same logits as the JAX full
    forward, and the same bits on a second call."""
    cfg, _, state, _, tokens, full = setup
    model = tmix.Mixtral(tcfg_of(cfg), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        first, _ = model(tokens)
        again, _ = model(tokens)
    np.testing.assert_allclose(first.numpy(), full, atol=ATOL)
    assert torch.equal(first, again)


def test_dropping_reference_differs_from_decode():
    """With a tight capacity factor the full forward drops by batch-global
    priority (as the JAX one does, within ATOL), and a drop-free prefill
    of the same tokens diverges: why decode routes drop-free."""
    base = dataclasses.replace(jmix.mixtral_tiny(vocab_size=VOCAB,
                                                 max_seq_len=MAX_SEQ),
                               dtype=jnp.float32, capacity_factor=1.0)
    rng = jax.random.PRNGKey(3)
    tokens = jax.random.randint(rng, (2, 24), 0, base.vocab_size)
    jmodel = jmix.Mixtral(base)
    params = jmodel.init(rng, tokens)["params"]
    want, _ = jmodel.apply({"params": params}, tokens)
    state = mixtral_params_from_flax(jax.tree.map(np.asarray, params),
                                     tcfg_of(base))
    models = {}
    for decode in (False, True):
        models[decode] = tmix.Mixtral(tcfg_of(base, decode=decode),
                                      device="cpu")
        models[decode].load_state_dict(state)
    toks = torch.tensor(np.asarray(tokens))
    with torch.no_grad():
        full, _ = models[False](toks)
    assert sum(int(layer.moe.dropped_assignments)
               for layer in models[False].layers) > 0
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=ATOL)
    cache = tmix.init_cache(models[True], 2)
    logits, _ = tmix.prefill(models[True], cache, toks, arange(24, 2))
    assert not np.allclose(logits.numpy(), full.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# MixtralRunner and the worker
# ---------------------------------------------------------------------------

# (prompt length, max_new_tokens): buckets 8, 16 and 32; the 20-token
# prompt decodes to length 38, past max_seq_len.
TRACE = [(3, 6), (9, 4), (20, 18), (5, 5), (12, 3), (1, 8)]


def serve(runner, q_mod, b_mod, e_mod, prompts):
    queue = q_mod.RequestQueue(max_depth=16)
    engine = e_mod.ServingEngine(queue, b_mod.ContinuousBatcher(runner))
    for i, (prompt, budget) in enumerate(prompts):
        queue.submit(q_mod.Request(id=f"r{i}", prompt=prompt,
                                   max_new_tokens=budget))
    done = engine.run_until_idle()
    return [(r.id, list(r.output)) for r in done]


def test_mixtral_runner_tokens_match_jax():
    cfg = dataclasses.replace(jmix.mixtral_tiny(VOCAB, MAX_SEQ),
                              dtype=jnp.float32)
    params = jmix.Mixtral(cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tcfg = tcfg_of(cfg)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, VOCAB, n).tolist(), budget)
               for n, budget in TRACE]
    assert max(len(p) + b for p, b in prompts) > MAX_SEQ
    want = serve(jrunner.MixtralRunner(config=cfg, params=params,
                                       max_slots=2),
                 jqueue, jbatcher, jengine, prompts)
    port = trunner.MixtralRunner(
        config=tcfg, params=mixtral_params_from_flax(params, tcfg),
        max_slots=2, device="cpu")
    assert port.model.cfg.decode
    got = serve(port, tqueue, tbatcher, tengine, prompts)
    assert got == want
    assert [len(out) for _, out in sorted(got)] == [b for _, b in TRACE]


def test_mixtral_runner_rejects_prompts_outside_the_cache():
    runner = trunner.MixtralRunner(config=tmix.mixtral_tiny(VOCAB, MAX_SEQ),
                                   max_slots=1, device="cpu")
    for length in (MAX_SEQ - 1, MAX_SEQ + 8):
        with pytest.raises(ValueError, match="prompt length"):
            runner.prefill([1] * length, 0)


def test_worker_serves_mixtral_to_close(monkeypatch, tmp_path):
    for name in list(os.environ):
        if name.startswith("TPUJOB_"):
            monkeypatch.delenv(name)
    root = tmp_path / "spool"
    (root / "pending").mkdir(parents=True)
    requests = [("m0", "a", [1, 2, 3], 4), ("m1", "b", [7], 6),
                ("m2", "a", [4, 4, 9, 2], 3)]
    for rid, tenant, prompt, budget in requests:
        (root / "pending" / f"{rid}.json").write_text(json.dumps(
            {"id": rid, "tenant": tenant, "prompt": prompt,
             "maxNewTokens": budget}))
    (root / tworker.CLOSE_SENTINEL).write_text("")
    assert tworker.main(["--runner", "mixtral", "--spool", str(root),
                         "--device", "cpu", "--poll-interval", "0.001"]) == 0
    done = {p.name: json.loads(p.read_text())
            for p in (root / "done").glob("*.json")}
    assert sorted(done) == [f"{rid}.json" for rid, *_ in requests]
    vocab = tmix.mixtral_tiny().vocab_size
    for rid, _, _, budget in requests:
        tokens = done[f"{rid}.json"]["tokens"]
        assert len(tokens) == budget
        assert all(0 <= t < vocab for t in tokens)
