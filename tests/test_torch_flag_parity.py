"""Flag/backend parity gate: hack/torch/verify-flag-parity.py under
tier-1, over the port's ``tf_operator_tpu_torch/cli.py``.

Every --enable-* kube gate in cli.py must cite an existing docs page
that explains the gate, and no doc may keep claiming a flag is
rejected on --backend kube after the gate was lifted (the node-agent
round lifted tenant queues, checkpoint coordination, and serving —
only elastic remains gated; see docs/node-agent.md).
"""

from __future__ import annotations

import importlib.util
import os

import pytest

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hack", "torch",
    "verify-flag-parity.py")


def _load():
    spec = importlib.util.spec_from_file_location("verify_flag_parity",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_and_docs_agree():
    mod = _load()
    assert mod.check() == []


def test_checker_sees_the_real_contract():
    """The gate is only as good as its parser: it must see the real
    flag set and the remaining kube gates (an empty parse would make
    test_cli_and_docs_agree pass vacuously)."""
    mod = _load()
    flags = mod.enable_flags()
    gates = mod.kube_gates()
    assert {"--enable-gang-scheduling", "--enable-tenant-queues",
            "--enable-ckpt-coordination", "--enable-serving",
            "--enable-elastic"} <= flags
    # The node-agent relay lifted every kube gate except elastic — the
    # serving autoscaler rides the elastic resize pass, so it inherits
    # the same gate (docs/serving.md) — and shard leases live in the
    # in-process store, so --shards > 1 is rejected on kube until the
    # kube lease client lands (docs/robustness.md).
    assert set(gates) == {"--enable-elastic",
                          "--enable-serving-autoscaler",
                          "--shards"}
    message, cited = gates["--enable-elastic"]
    assert "elastic.md" in "".join(cited)
    # The lifted flags must NOT be gated anymore.
    for lifted in ("--enable-tenant-queues", "--enable-ckpt-coordination",
                   "--enable-serving"):
        assert lifted not in gates


def test_checker_reports_drift(tmp_path):
    """A doctored cli (gate citing a missing doc) and a doctored doc
    (stale rejection claim for an ungated flag) both surface."""
    mod = _load()
    with open(os.path.join(os.path.dirname(_SCRIPT), "..", "..",
                           "tf_operator_tpu_torch", "cli.py"),
              encoding="utf-8") as f:
        src = f.read()
    doctored_cli = tmp_path / "cli.py"
    doctored_cli.write_text(src + '\n\ndef _fake(parser, args):\n'
                            '    parser.error("--enable-serving is not '
                            'supported with --backend kube; see '
                            'docs/ghost.md")\n', encoding="utf-8")
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "stale.md").write_text(
        "The `--enable-tenant-queues` flag is rejected on `--backend "
        "kube` (no CRD mirror yet).\n", encoding="utf-8")
    problems = mod.check(str(doctored_cli), str(docs))
    assert any("docs/ghost.md" in p for p in problems)
    assert any("--enable-tenant-queues" in p and "stale.md" in p
               for p in problems)


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
