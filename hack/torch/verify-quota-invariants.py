#!/usr/bin/env python
"""Randomized property check for the tenant-queue quota subsystem
(controller/quota.py + controller/gang.py).

The port's copy of ``hack/verify-quota-invariants.py``: the same rounds
over the port's ``api.types``, ``controller.gang``, ``controller.quota``
and ``runtime.store``, on ``h100-N`` slices.

Generates random cohort/queue topologies and random gang arrival/
completion schedules, runs real admission passes against an in-memory
Store, and asserts the subsystem's core invariants after every step:

1. **No admission above cohort capacity** — the chips held by admitted
   (Inqueue/Running) groups of a cohort's queues never exceed the
   cohort's aggregate nominal quota, borrowing included.
2. **No queue starves** — every generated group is sized to be
   admissible through its queue (need <= the queue's ceiling), so with
   completions freeing capacity, every group must eventually admit
   within a bounded number of drain rounds.
3. **Nominal floor under reclaim** — a reclaim never displaces a queue
   below its nominal occupancy unless the displaced gang itself
   straddles the boundary (gangs are indivisible; checked as: after
   any pass, a queue's admitted chips below nominal implies it has no
   borrowed peer still admitted in its cohort while it has pending
   nominal demand... folded into invariant 2's convergence).

Usage:
    python hack/torch/verify-quota-invariants.py                # 50 rounds
    python hack/torch/verify-quota-invariants.py --rounds 10 --seed 7

Exit status 0 = all rounds clean; 1 = a violation, with the repro seed
on stderr. Wired into tier-1 as tests/test_torch_quota_invariants.py (small
round count, fixed seed).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from tf_operator_tpu_torch.api.types import (  # noqa: E402
    ClusterQueue,
    ClusterQueueSpec,
    ReclaimPolicy,
    SliceGroup,
    SliceGroupSpec,
    TenantQueue,
    TenantQueueSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.controller.gang import (  # noqa: E402
    PHASE_INQUEUE,
    PHASE_PENDING,
    PHASE_RUNNING,
    SliceGangScheduler,
)
from tf_operator_tpu_torch.controller.quota import (  # noqa: E402
    TenantQueueManager,
)
from tf_operator_tpu_torch.runtime import store as store_mod  # noqa: E402
from tf_operator_tpu_torch.runtime.store import Store  # noqa: E402


class Topology:
    def __init__(self, rng: random.Random):
        self.rng = rng
        self.store = Store()
        self.mgr = TenantQueueManager(self.store)
        # queue name -> (cohort, nominal, ceiling)
        self.queues: Dict[str, tuple] = {}
        self.cohort_nominal: Dict[str, int] = {}
        n_cohorts = rng.randint(1, 2)
        qi = 0
        for ci in range(n_cohorts):
            cohort = f"cohort-{ci}"
            for _ in range(rng.randint(2, 4)):
                name = f"q{qi}"
                qi += 1
                nominal = rng.choice([4, 8, 16, 32])
                bl = rng.choice([None, None, 0, 4, 8])
                policy = rng.choice([ReclaimPolicy.ANY, ReclaimPolicy.ANY,
                                     ReclaimPolicy.LOWER_PRIORITY])
                cq = ClusterQueue(spec=ClusterQueueSpec(
                    nominal_chips=nominal, borrowing_limit=bl,
                    cohort=cohort, reclaim_policy=policy))
                cq.metadata.name = f"cq-{name}"
                cq.metadata.namespace = ""
                self.store.create(store_mod.CLUSTERQUEUES, cq)
                tq = TenantQueue(spec=TenantQueueSpec(
                    cluster_queue=f"cq-{name}"))
                tq.metadata.name = name
                self.store.create(store_mod.TENANTQUEUES, tq)
                self.queues[name] = (cohort, nominal, bl)
                self.cohort_nominal[cohort] = \
                    self.cohort_nominal.get(cohort, 0) + nominal
        # Physical capacity >= every cohort's nominal so quota is the
        # binding constraint the invariants exercise.
        total = sum(self.cohort_nominal.values())
        self.sched = SliceGangScheduler(
            self.store, total_chips=total, quota=self.mgr,
            fairness=rng.choice(["aged", "strict", "backfill"]),
            priority_classes={"hi": 100, "lo": 10})
        self._gi = 0

    def ceiling(self, qname: str) -> int:
        cohort, nominal, bl = self.queues[qname]
        cap = self.cohort_nominal[cohort]
        return min(nominal + bl, cap) if bl is not None else cap

    def add_group(self, qname: str) -> Optional[str]:
        ceiling = self.ceiling(qname)
        sizes = [c for c in (4, 8, 16, 32) if c <= ceiling]
        if not sizes:
            return None  # zero-ceiling queue: nothing admissible
        name = f"g{self._gi}"
        self._gi += 1
        g = SliceGroup(spec=SliceGroupSpec(
            min_member=1, queue=qname,
            priority_class=self.rng.choice(["", "hi", "lo"]),
            slice=TPUSliceSpec(
                accelerator=f"h100-{self.rng.choice(sizes)}")))
        g.metadata.name = name
        self.store.create(store_mod.SLICEGROUPS, g)
        return name

    def chips_of(self, g: SliceGroup) -> int:
        return int(g.spec.slice.accelerator.split("-")[1])

    def groups(self) -> List[SliceGroup]:
        return self.store.list(store_mod.SLICEGROUPS)

    def admitted_by_cohort(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for g in self.groups():
            if g.status.phase not in (PHASE_INQUEUE, PHASE_RUNNING):
                continue
            q = self.queues.get(g.spec.queue)
            if q is None:
                continue
            out[q[0]] = out.get(q[0], 0) + self.chips_of(g)
        return out

    def check_cohort_capacity(self) -> Optional[str]:
        for cohort, used in self.admitted_by_cohort().items():
            cap = self.cohort_nominal[cohort]
            if used > cap:
                return (f"cohort {cohort} over capacity: {used} admitted "
                        f"chips > {cap} aggregate nominal")
        return None

    def complete_random_admitted(self) -> bool:
        admitted = [g for g in self.groups()
                    if g.status.phase in (PHASE_INQUEUE, PHASE_RUNNING)]
        if not admitted:
            return False
        victim = self.rng.choice(admitted)
        self.store.delete(store_mod.SLICEGROUPS,
                          victim.metadata.namespace, victim.metadata.name)
        self.sched.readmit()
        return True


def run_round(seed: int, steps: int = 30, verbose: bool = False) -> List[str]:
    rng = random.Random(seed)
    topo = Topology(rng)
    errors: List[str] = []
    qnames = list(topo.queues)
    for step in range(steps):
        action = rng.random()
        if action < 0.6:
            topo.add_group(rng.choice(qnames))
        elif action < 0.9:
            topo.complete_random_admitted()
        topo.sched.readmit()
        err = topo.check_cohort_capacity()
        if err:
            errors.append(f"step {step}: {err}")
            return errors
    # Starvation check: with completions freeing capacity, every
    # remaining group must admit within a bounded number of drain
    # rounds (every group was generated admissible).
    remaining = sum(1 for g in topo.groups()
                    if g.status.phase == PHASE_PENDING)
    bound = len(topo.groups()) + 5
    for round_i in range(bound):
        topo.sched.readmit()
        err = topo.check_cohort_capacity()
        if err:
            errors.append(f"drain round {round_i}: {err}")
            return errors
        pending = [g for g in topo.groups()
                   if g.status.phase == PHASE_PENDING]
        if not pending:
            break
        if not topo.complete_random_admitted():
            # Nothing admitted to complete, yet groups still pending:
            # the scheduler is stuck — starvation.
            errors.append(
                f"starvation: {len(pending)} group(s) pending with no "
                f"admitted work to wait on: "
                + ", ".join(f"{g.metadata.name}(queue={g.spec.queue}, "
                            f"chips={topo.chips_of(g)})"
                            for g in pending[:5]))
            return errors
    else:
        pending = [g for g in topo.groups()
                   if g.status.phase == PHASE_PENDING]
        if pending:
            errors.append(
                f"starvation: {len(pending)} group(s) never admitted "
                f"after {bound} drain rounds (started with {remaining} "
                "pending)")
    if verbose and not errors:
        print(f"  seed {seed}: {topo._gi} groups, "
              f"{len(topo.queues)} queues, clean", file=sys.stderr)
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=50)
    p.add_argument("--seed", type=int, default=None,
                   help="base seed (default: random; printed for repro)")
    p.add_argument("--steps", type=int, default=30,
                   help="random arrive/complete steps per round")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    base = args.seed if args.seed is not None else \
        random.SystemRandom().randint(0, 2**31)
    print(f"verify-quota-invariants: {args.rounds} rounds, "
          f"base seed {base}", file=sys.stderr)
    for i in range(args.rounds):
        seed = base + i
        errors = run_round(seed, steps=args.steps, verbose=args.verbose)
        if errors:
            print(f"FAIL (repro: --seed {seed} --rounds 1):",
                  file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
    print("OK: admitted chips never exceeded cohort capacity; "
          "no queue starved", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
