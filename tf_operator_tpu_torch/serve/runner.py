"""Model runners: the continuous batcher's prefill/decode phases on the
port's Llama and Mixtral incremental-decode paths (models/llama.py,
models/mixtral.py).

Port of ``tf_operator_tpu/serve/runner.py``, with the same phase split:

- ``prefill`` runs one request at a time on a single-row staging cache,
  padded to a power-of-two bucket (as the JAX runner pads to bound its
  compiled programs), then copies the row into the request's slot of the
  shared decode cache (``insert_cache``). The staging cache is reused
  without zeroing: rows past a new prompt are never attended before they
  are overwritten.
- ``decode`` is one forward at the fixed [max_slots, 1] shape every step,
  however many slots are occupied: free slots decode token 0 at position
  0, rows that are overwritten before any real sequence attends them.

The cache is updated in place (``models/llama.py``). Greedy tokens are the
argmax of f32 logits, as in the JAX runner.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.serve.batcher import Runner


class _CachedDecodeRunner(Runner):
    """Shared machinery over the incremental-decode helper contract
    (init_cache/prefill/decode_step/insert_cache + a decode=True model).
    Subclasses bind the model family in ``__init__``."""

    def _setup(self, model, helpers, max_slots: int, eos: Optional[int],
               min_prefill_bucket: int) -> None:
        init_cache, self._prefill_fn, self._decode_fn, self._insert_fn = \
            helpers
        self.model = model
        self.config = model.cfg
        self.device = model.angles.device
        self.max_slots = max_slots
        self.eos = eos
        self.min_prefill_bucket = min_prefill_bucket
        self.cache = init_cache(model, max_slots)
        self._stage = init_cache(model, 1)

    def _bucket(self, n: int) -> int:
        size = self.min_prefill_bucket
        while size < n:
            size *= 2
        return min(size, self.config.max_seq_len)

    def prefill(self, prompt: List[int], slot: int) -> int:
        length = len(prompt)
        if not 0 < length + 1 < self.config.max_seq_len:
            raise ValueError(f"prompt length {length} outside "
                             f"(0, {self.config.max_seq_len - 1})")
        size = self._bucket(length)
        tokens = torch.tensor([list(prompt) + [0] * (size - length)],
                              device=self.device)
        positions = torch.arange(size, device=self.device)[None, :]
        logits, self._stage = self._prefill_fn(self.model, self._stage,
                                               tokens, positions)
        self.cache = self._insert_fn(self.cache, self._stage, slot)
        return int(torch.argmax(logits[0, length - 1].float()))

    def decode(self, last_tokens: List[Optional[int]],
               lengths: List[Optional[int]]) -> List[Optional[int]]:
        tokens = [0] * self.max_slots
        positions = [0] * self.max_slots
        active = []
        for slot in range(self.max_slots):
            if slot < len(lengths) and lengths[slot] is not None:
                # The fed token is the newest generated one; its
                # position is length-1 (length counts prompt + output).
                tokens[slot] = int(last_tokens[slot])
                positions[slot] = int(lengths[slot]) - 1
                active.append(slot)
        fed = torch.tensor([tokens, positions], device=self.device)
        logits, self.cache = self._decode_fn(self.model, self.cache,
                                             fed[0][:, None], fed[1][:, None])
        best = torch.argmax(logits[:, 0].float(), dim=-1).tolist()
        out: List[Optional[int]] = [None] * self.max_slots
        for slot in active:
            out[slot] = best[slot]
        return out


class LlamaRunner(_CachedDecodeRunner):
    """Llama serving on one device: the card unless ``device="cpu"``.

    ``params`` is a port ``state_dict`` (e.g. ``llama_params_from_flax`` of
    a flax checkpoint); without one the weights are drawn from a
    ``torch.Generator`` on the device seeded with ``rng_seed`` (not the
    numbers the JAX runner draws from the same seed)."""

    def __init__(self, config=None, params=None, max_slots: int = 4,
                 rng_seed: int = 0, eos: Optional[int] = None,
                 min_prefill_bucket: int = 8, device: DeviceLike = None):
        from tf_operator_tpu_torch.models.llama import (
            Llama,
            decode_step,
            init_cache,
            insert_cache,
            llama_tiny,
            prefill,
        )

        cfg = dataclasses.replace(config or llama_tiny(), decode=True)
        device = resolve_device(device)
        model = Llama(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(rng_seed))
        if params is not None:
            model.load_state_dict(params)
        model.requires_grad_(False)
        self._setup(model, (init_cache, prefill, decode_step, insert_cache),
                    max_slots, eos, min_prefill_bucket)


class MixtralRunner(_CachedDecodeRunner):
    """Mixtral serving on one device: the card unless ``device="cpu"``.
    Decode-mode routing is drop-free (every token reaches its top-k
    experts, ``MixtralConfig.decode``), so generation is reproducible
    against a drop-free full forward (capacity_factor >= n_experts).

    ``params`` is a port ``state_dict`` (e.g. ``mixtral_params_from_flax``);
    without one the weights are drawn from a ``torch.Generator`` on the
    device seeded with ``rng_seed``."""

    def __init__(self, config=None, params=None, max_slots: int = 4,
                 rng_seed: int = 0, eos: Optional[int] = None,
                 min_prefill_bucket: int = 8, device: DeviceLike = None):
        from tf_operator_tpu_torch.models.mixtral import (
            Mixtral,
            decode_step,
            init_cache,
            insert_cache,
            mixtral_tiny,
            prefill,
        )

        cfg = dataclasses.replace(config or mixtral_tiny(), decode=True)
        device = resolve_device(device)
        model = Mixtral(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(rng_seed))
        if params is not None:
            model.load_state_dict(params)
        model.requires_grad_(False)
        self._setup(model, (init_cache, prefill, decode_step, insert_cache),
                    max_slots, eos, min_prefill_bucket)
