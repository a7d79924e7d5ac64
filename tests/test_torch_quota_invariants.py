"""Tier-1 wiring for hack/torch/verify-quota-invariants.py (the port's
copy of hack/verify-quota-invariants.py): a small fixed-seed slice of
the randomized-admission property check (admitted chips never exceed
cohort capacity; no queue starves) runs on every CI pass, so a quota
regression fails fast with a repro seed instead of waiting for the next
manual fuzz round.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "hack", "torch", "verify-quota-invariants.py")


def _load():
    spec = importlib.util.spec_from_file_location("verify_quota", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixed_seed_rounds_hold_invariants():
    vq = _load()
    for seed in (1234, 1237, 1282, 4242):  # incl. past regression seeds
        errors = vq.run_round(seed, steps=30)
        assert not errors, f"seed {seed}: {errors}"


def test_cli_entrypoint_runs_clean():
    """The standalone script contract (exit 0 / exit 1 + repro seed)."""
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--rounds", "5", "--seed", "77"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stderr


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
