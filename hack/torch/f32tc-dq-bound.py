#!/usr/bin/env python3
"""What bounds the f32 dQ kernel: time it beside builds with parts of its
work left out.

Builds variants of ``csrc/flash_attention_f32tc.cu`` into ``build/dev/``
(one nvcc each, started together), each with one part of the dQ's work
taken out of ``flash_dq_f32tc_kernel`` (so its results are wrong; only
its time is read):

- ``no_kt_loads``: the K^T panels are never loaded (their ring slots are
  marked full with no bytes);
- ``no_ring_loads``: nothing is loaded into the ring (K, V and K^T at
  head_dim 128; Q, dO, K, V and K^T beyond);
- ``no_exchange``: the P and dS hand-off between the warpgroups keeps its
  shared-memory stores and loads but waits at no barrier;

and times each beside the unchanged build, in turns (base, variants,
variants reversed, base), at B=1, S=2048, H=32, Hkv=8, causal, f32, at
head_dim 128, 256 and 512, the prologue included (``ms``), with the dQ
prologue's own time beside. If a variant is much faster than the base,
what it left out sets the pace. Prints one JSON line per head_dim after
the card's name and power limit.

Usage (on the machine with the card, from the root of the checkout):
    python3 hack/torch/f32tc-dq-bound.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tf_operator_tpu_torch.ops import _build  # noqa: E402
from tf_operator_tpu_torch.ops import flash_attention as fa  # noqa: E402

NAME = fa._LIBRARY["_f32tc"]
OUT = os.path.join(REPO, "build", "dev")

# (text of the dQ's code, what a variant puts in its place); each must
# occur once in the source.
KT_RESIDENT = (
    "            else\n"
    "              tma_load_panel(dst + part * PANEL, ktmap,",
    "            else if (0)\n"
    "              tma_load_panel(dst + part * PANEL, ktmap,")
KV_RESIDENT = (
    "            if (k < NP)\n"
    "              tma_load_panel(dst + part * PANEL, g == 0 ? kmap : vmap,",
    "            if (k < NP) {} else if (0)\n"
    "              tma_load_panel(dst + part * PANEL, g == 0 ? kmap : vmap,")
KT_STREAMED = (
    "            } else {\n"
    "              for (int c = 0; c < 2; ++c)\n"
    "                tma_load_panel(dst + (2 * part + c) * PANEL, ktmap,",
    "            } else if (0) {\n"
    "              for (int c = 0; c < 2; ++c)\n"
    "                tma_load_panel(dst + (2 * part + c) * PANEL, ktmap,")
QKV_STREAMED = ("            if (p < NSU) {\n"
                "              tma_load_panel(dst + part * PANEL, amap,",
                "            if (0) {\n"
                "              tma_load_panel(dst + part * PANEL, amap,")
EXPECT_RESIDENT = "          mbar_expect_tx(&full[s], F::SLOT);"
EXPECT_STREAMED = "          mbar_expect_tx(bar, UNIT);"
VARIANTS = {
    "base": [],
    "no_kt_loads": [
        KT_RESIDENT, KT_STREAMED,
        (EXPECT_RESIDENT, "          if (k < NP) mbar_expect_tx(&full[s], "
                          "F::SLOT); else mbar_arrive(&full[s]);"),
        (EXPECT_STREAMED, "          if (p < NSU) mbar_expect_tx(bar, UNIT);"
                          " else mbar_arrive(bar);")],
    "no_ring_loads": [
        KT_RESIDENT, KV_RESIDENT, KT_STREAMED, QKV_STREAMED,
        (EXPECT_RESIDENT, "          mbar_arrive(&full[s]);"),
        (EXPECT_STREAMED, "          mbar_arrive(bar);")],
    "no_exchange": [
        ("    named_arrive(P_FULL, 256);\n    named_sync(DS_FULL, 256);\n",
         ""),
        ("    named_sync(P_FULL, 256);\n#pragma unroll\n"
         "    for (int e = 0; e < 32; ++e)\n"
         "      x[e] = sP[e * 128 + tid] * (x[e] - stat",
         "#pragma unroll\n    for (int e = 0; e < 32; ++e)\n"
         "      x[e] = sP[e * 128 + tid] * (x[e] - stat"),
        ("    named_arrive(DS_FULL, 256);\n", "")],
}
HEAD_DIMS = (128, 256, 512)


def build(variant: str) -> str:
    src = (_build.CSRC / f"{NAME}.cu").read_text()
    for old, new in VARIANTS[variant]:
        if src.count(old) != 1:
            raise RuntimeError(f"{variant}: the dQ's code changed; "
                               f"{old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    cu = os.path.join(OUT, f"dq_{variant}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"libdq_{variant}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
           "-o", lib, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stderr}")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = [*VARIANTS, *reversed(VARIANTS)]
    for d in HEAD_DIMS:
        q, k, v, do = cs.make_inputs(gen, 2048, 2048, torch.float32, d,
                                     cs.H, cs.HKV)
        out, lse = fa._fwd_reference(q, k, v, True, 0)
        delta = fa._delta(out, do)
        times = {n: [] for n in VARIANTS}
        for n in order:
            _build._loaded[NAME] = ctypes.CDLL(libs[n])
            times[n].append(cs.cuda_ms(lambda: fa._dq_cuda(
                q, k, v, lse, do, delta, True, 0), 10))
        prologue = cs.cuda_ms(lambda: fa.f32tc_prologue(
            "dq", q, k, v, do), 10)
        print(json.dumps({"d": d, "ms": times, "prologue_ms": prologue}),
              flush=True)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
