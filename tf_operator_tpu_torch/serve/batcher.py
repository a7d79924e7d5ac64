"""Slot-based continuous batching over a prefill/decode runner.

The batcher owns ``max_slots`` decode slots. Each engine step:

1. **Admission** — while a slot is free and the queue has work, pop the
   next request (the queue's DRR decides WHICH tenant's), run its
   prompt through the runner's prefill phase, and seat it in the slot.
   Prefill emits the request's first generated token, so TTFT is
   measured here.
2. **Decode** — one batched decode_step over every occupied slot
   appends one token per live sequence; sequences reaching their token
   budget (or the runner's EOS) complete and free their slot for the
   next admission.

Prefill is per-request (variable prompt lengths compile per padded
bucket), decode is batched at the full slot count every step — the
standard prefill/decode phase split: admission cost is paid once per
sequence, steady-state throughput is the batched decode.

Copy of ``tf_operator_tpu/serve/batcher.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from tf_operator_tpu_torch.serve.queue import Request, RequestQueue


@dataclasses.dataclass
class _Seat:
    request: Request
    length: int          # tokens in the slot's KV cache (prompt + output)


class Runner:
    """Prefill/decode surface the batcher drives (duck-typed; the two
    implementations are LlamaRunner in serve/runner.py and the
    model-free FakeRunner below).

    ``prefill(prompt, slot)`` seats a sequence's KV state in ``slot``
    and returns its first generated token. ``decode(last_tokens,
    lengths)`` takes the per-slot last token and sequence length (None
    for free slots) and returns one new token per occupied slot.
    ``eos`` (None = never) terminates a sequence early.
    """

    max_slots: int = 0
    eos: Optional[int] = None

    def prefill(self, prompt: List[int], slot: int) -> int:
        raise NotImplementedError

    def decode(self, last_tokens: List[Optional[int]],
               lengths: List[Optional[int]]) -> List[Optional[int]]:
        raise NotImplementedError


class FakeRunner(Runner):
    """Deterministic model-free runner: token t+1 = (sum(prompt) + t) %
    vocab for the sequence's t-th generated token. Models per-slot KV
    state with a dict so slot-reuse bugs surface as wrong outputs, and
    keeps the serving worker's end-to-end path runnable without a
    model."""

    def __init__(self, max_slots: int = 8, vocab: int = 251,
                 eos: Optional[int] = None):
        self.max_slots = max_slots
        self.vocab = vocab
        self.eos = eos
        self._state: Dict[int, List[int]] = {}  # slot -> [seed, generated]

    def _token(self, seed: int, index: int) -> int:
        return (seed + index) % self.vocab

    def prefill(self, prompt: List[int], slot: int) -> int:
        seed = sum(prompt) + len(prompt)
        self._state[slot] = [seed, 1]
        return self._token(seed, 0)

    def decode(self, last_tokens, lengths):
        out: List[Optional[int]] = []
        for slot in range(self.max_slots):
            if slot >= len(lengths) or lengths[slot] is None:
                out.append(None)
                continue
            seed, n = self._state[slot]
            self._state[slot][1] = n + 1
            out.append(self._token(seed, n))
        return out


class ContinuousBatcher:
    """Continuous batch assembly over ``runner.max_slots`` KV slots."""

    def __init__(self, runner: Runner, clock=None):
        import time

        self.runner = runner
        self.clock = clock or time.monotonic
        self._seats: List[Optional[_Seat]] = [None] * runner.max_slots

    # -- introspection ---------------------------------------------------

    @property
    def active(self) -> int:
        return sum(1 for s in self._seats if s is not None)

    @property
    def free_slots(self) -> int:
        return len(self._seats) - self.active

    def in_flight(self) -> List[Request]:
        return [s.request for s in self._seats if s is not None]

    # -- one engine step -------------------------------------------------

    def step(self, queue: RequestQueue) -> List[Request]:
        """Admit into free slots, then one batched decode. Returns the
        requests that completed this step; generated-token count for
        the throughput gauge is len(completed outputs delta) — the
        engine tracks it via ``Request.output``."""
        completed: List[Request] = []

        for slot, seat in enumerate(self._seats):
            if seat is not None:
                continue
            request = queue.pop()
            if request is None:
                break
            token = self.runner.prefill(list(request.prompt), slot)
            request.first_token_at = self.clock()
            request.output.append(token)
            if self._finished(request, token):
                completed.append(self._complete(request))
                continue
            self._seats[slot] = _Seat(request=request,
                                      length=len(request.prompt) + 1)

        if self.active:
            last = [s.request.output[-1] if s is not None else None
                    for s in self._seats]
            lengths = [s.length if s is not None else None
                       for s in self._seats]
            tokens = self.runner.decode(last, lengths)
            for slot, seat in enumerate(self._seats):
                if seat is None:
                    continue
                token = tokens[slot]
                seat.request.output.append(token)
                seat.length += 1
                if self._finished(seat.request, token):
                    completed.append(self._complete(seat.request))
                    self._seats[slot] = None
        return completed

    def drain(self) -> List[Request]:
        """Evict every in-flight sequence (drain-mid-traffic): seats
        empty, requests returned with their progress reset so another
        replica re-serves them from the prompt."""
        evicted = [s.request.reset() for s in self._seats if s is not None]
        self._seats = [None] * len(self._seats)
        return evicted

    # -- internals -------------------------------------------------------

    def _finished(self, request: Request, token: int) -> bool:
        if self.runner.eos is not None and token == self.runner.eos:
            return True
        return len(request.output) >= request.max_new_tokens

    def _complete(self, request: Request) -> Request:
        request.done_at = self.clock()
        return request
