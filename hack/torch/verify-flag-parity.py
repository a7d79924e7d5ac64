#!/usr/bin/env python3
"""Flag/backend parity drift check: cli.py kube gates vs the docs.

The port's copy of ``hack/verify-flag-parity.py``: the same checks on
``tf_operator_tpu_torch/cli.py`` and its ``build_parser``.

The CLI's feature flags (``--enable-*``) are either accepted on
``--backend kube`` or rejected by a ``parser.error`` gate in
``main()``. Both sides rot independently: a gate whose cited doc no
longer exists (or no longer explains the gate) strands the operator it
just rejected, and a doc still claiming a flag is rejected after the
gate was lifted sends users away from a working path. This checker
pins the contract — wired into tier-1 as tests/test_torch_flag_parity.py:

- every kube gate message names the flag it rejects, cites at least
  one ``docs/*.md`` file, and that file exists and discusses the flag
  on kube;
- no doc paragraph claims a flag is rejected / not yet supported on
  kube unless the gate actually exists in cli.py;
- every serving front-door flag (``--gateway-*`` / ``--autoscale-*`` /
  ``--enable-serving-*``) is documented in docs/serving.md — the
  gateway and autoscaler are operated from that page, so an
  undocumented knob there is unreachable by its audience;
- every sharding flag (``--shards`` / ``--shard-index``) is documented
  in docs/robustness.md — the ``--shards`` kube gate sends rejected
  operators to that page's 'Sharded control plane' section.

Usage: python hack/torch/verify-flag-parity.py   # exit 0 clean, 1 on drift
"""

from __future__ import annotations

import glob
import os
import re
import sys
from typing import Dict, List, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLI = os.path.join(REPO, "tf_operator_tpu_torch", "cli.py")
DOCS_DIR = os.path.join(REPO, "docs")

# parser.error("..." "..."): adjacent string literals only (the cli.py
# house style), so parentheses inside the message cannot truncate the
# match.
_ERROR_CALL = re.compile(r'parser\.error\(\s*((?:"(?:[^"\\]|\\.)*"\s*)+)\)')
_STR = re.compile(r'"((?:[^"\\]|\\.)*)"')
_FLAG_AT_START = re.compile(r"^(--enable-[a-z-]+|--shards)\b")
_DOC_CITE = re.compile(r"docs/([a-z0-9_-]+\.md)")
# Doc-side claims that a flag is unavailable on kube.
_REJECTION_WORDS = ("not yet supported", "rejects", "rejected")


def _parser_flags(prefixes: Tuple[str, ...]) -> Set[str]:
    sys.path.insert(0, REPO)
    from tf_operator_tpu_torch.cli import build_parser

    flags: Set[str] = set()
    for action in build_parser()._actions:
        for opt in action.option_strings:
            if opt.startswith(prefixes):
                flags.add(opt)
    return flags


def enable_flags() -> Set[str]:
    """Every --enable-* flag the CLI parser accepts."""
    return _parser_flags(("--enable-",))


def serving_flags() -> Set[str]:
    """The serving front-door flag family (gateway + autoscaler): all
    must be documented in docs/serving.md."""
    return _parser_flags(("--gateway-", "--autoscale-",
                          "--enable-serving-"))


def sharding_flags() -> Set[str]:
    """The control-plane sharding flag family (--shards,
    --shard-index): all must be documented in docs/robustness.md."""
    return _parser_flags(("--shard",))


def kube_gates(path: str = CLI) -> Dict[str, Tuple[str, List[str]]]:
    """flag -> (gate message, cited docs files) for every parser.error
    gate that rejects an --enable-* flag on --backend kube."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    gates: Dict[str, Tuple[str, List[str]]] = {}
    for call in _ERROR_CALL.finditer(src):
        message = "".join(_STR.findall(call.group(1)))
        if "kube" not in message:
            continue
        flag = _FLAG_AT_START.match(message)
        if flag is None:
            continue  # backend/api-port plumbing errors, not flag gates
        gates[flag.group(1)] = (message, _DOC_CITE.findall(message))
    return gates


def _doc_paragraphs(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return re.split(r"\n\s*\n", f.read())


def check(cli_path: str = CLI, docs_dir: str = DOCS_DIR) -> List[str]:
    """All drift findings, empty when cli.py and the docs agree."""
    problems: List[str] = []
    flags = enable_flags() | sharding_flags()
    gates = kube_gates(cli_path)

    for flag, (message, cited) in sorted(gates.items()):
        if flag not in flags:
            problems.append(
                f"{flag} is gated off --backend kube in cli.py main() but "
                "is not a flag build_parser() accepts (typo in the gate?)")
            continue
        if not cited:
            problems.append(
                f"{flag}'s kube gate cites no docs/*.md file — a rejected "
                "operator has nowhere to go")
            continue
        for doc in cited:
            doc_path = os.path.join(docs_dir, doc)
            if not os.path.exists(doc_path):
                problems.append(
                    f"{flag}'s kube gate cites docs/{doc}, which does not "
                    "exist")
                continue
            with open(doc_path, encoding="utf-8") as f:
                text = f.read()
            if flag not in text or "kube" not in text:
                problems.append(
                    f"docs/{doc} is cited by {flag}'s kube gate but does "
                    f"not discuss {flag} on the kube backend")

    # Docs claiming a rejection the CLI no longer performs.
    for doc_path in sorted(glob.glob(os.path.join(docs_dir, "*.md"))):
        doc = os.path.basename(doc_path)
        for para in _doc_paragraphs(doc_path):
            if "kube" not in para:
                continue
            lowered = para.lower()
            if not any(w in lowered for w in _REJECTION_WORDS):
                continue
            for flag in sorted(flags - set(gates)):
                # Boundary match: --enable-serving must not fire on a
                # paragraph that only names --enable-serving-autoscaler.
                if re.search(re.escape(flag) + r"(?![a-z-])", para):
                    problems.append(
                        f"docs/{doc} claims {flag} is rejected on the kube "
                        "backend, but cli.py has no such gate (lifted "
                        "without updating the doc?)")

    # Serving front-door flags must be operable from docs/serving.md.
    serving_doc = os.path.join(docs_dir, "serving.md")
    serving_text = ""
    if os.path.exists(serving_doc):
        with open(serving_doc, encoding="utf-8") as f:
            serving_text = f.read()
    for flag in sorted(serving_flags()):
        if flag not in serving_text:
            problems.append(
                f"{flag} is a serving front-door flag but docs/serving.md "
                "never mentions it — the gateway/autoscaler page is its "
                "only discoverable home")

    # Sharding flags must be operable from docs/robustness.md — the
    # --shards kube gate sends rejected operators there.
    robustness_doc = os.path.join(docs_dir, "robustness.md")
    robustness_text = ""
    if os.path.exists(robustness_doc):
        with open(robustness_doc, encoding="utf-8") as f:
            robustness_text = f.read()
    for flag in sorted(sharding_flags()):
        if flag not in robustness_text:
            problems.append(
                f"{flag} is a control-plane sharding flag but "
                "docs/robustness.md never mentions it — the 'Sharded "
                "control plane' section is its only discoverable home")
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(f"DRIFT: {p}")
    if problems:
        print(f"{len(problems)} flag-parity drift problem(s)")
        return 1
    gates = kube_gates()
    print(f"ok: {len(enable_flags())} --enable-* flags, {len(gates)} kube "
          f"gate(s) ({', '.join(sorted(gates)) or 'none'}), cli and docs "
          "agree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
