#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env     torch, CUDA and nvcc versions; the card's name and power limit.
2. build   nvcc builds tf_operator_tpu_torch/csrc/flash_attention.cu for
           sm_90a (seconds, library path, ptxas register/spill report).
3. kernels each flash-attention kernel (forward, dQ, dK/dV) against its
           plain PyTorch version on the card in bf16, at the training
           step's shapes (B=1, S=2048, H=32, Hkv=8, D=128, causal), plus a
           non-causal case and a q_seq != k_seq case with q_offset > 0,
           each output within a limit scaled to its own largest value
           (REL below); the check must also reject perturbed plain outputs
           (zeros, δ dropped, a k or q tile skipped); kernel, plain and library (scaled_dot_product_attention, a
           yardstick the port never calls) times from CUDA events.
4. model   the 4-layer llama_3_8b-width model's logits through the kernels
           against the same weights through the reference attention.
5. train   the main path: Trainer + Llama (llama_3_8b widths, 4 layers,
           bf16 compute, f32 params, full remat), adamw(3e-4), B=1,
           S=2048, 5 steps on one fixed batch. Launch counters are zeroed
           just before and read just after; each kernel must have run its
           per-step count (fwd 8 = 4 layers x forward + remat recompute,
           dQ 4, dK/dV 4).
6. profile one more step under torch.profiler: device time by kernel class
           and the device's idle share.

Then a {"kernels": [...]} summary line, the nvidia-smi name/power line,
and last {"ok": true, "device": {...}}. Any failure exits non-zero before
the last line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from tf_operator_tpu_torch.models.llama import Llama, llama_3_8b
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.train.trainer import Trainer, adamw

# Kernel vs plain version. Attention outputs and gradients are small
# (at these inputs most are ~1e-2), so the repo's fixed bf16 atol of 2e-2
# would pass a kernel writing zeros: each output's atol is scaled to its
# own largest value and capped at 2e-2, rtol stays 2e-2 (one bf16 ulp is
# at most 2**-7 of a value), and the relative L2 error is bounded too. lse
# is a log, so an absolute error on it is a relative one on the softmax
# sum.
REL = 1e-2
ATOL = 2e-2
LSE_ATOL = 1e-3
OUTPUTS = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
           "flash_dkv": ("dk", "dv")}
BLOCK = fa.BLOCK
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
SOURCE = "tf_operator_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "tf_operator_tpu/ops/flash_attention.py:95",
    "flash_dq": "tf_operator_tpu/ops/flash_attention.py:183",
    "flash_dkv": "tf_operator_tpu/ops/flash_attention.py:207",
}
B, S, H, HKV, D = 1, 2048, 32, 8, 128
STEPS = 5
PER_STEP = {"flash_fwd": 8, "flash_dq": 4, "flash_dkv": 4}


def emit(record) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(q, k) pairs the causal mask leaves, per head."""
    if not causal:
        return sq * sk
    return sum(min(sk, q + q_offset + 1) for q in range(sq))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "nvidia_smi": nvidia_smi(),
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def phase_build():
    t0 = time.perf_counter()
    fa._lib()
    seconds, path, log = _build.build_info["flash_attention"]
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(seconds, 3), "library": path,
          "ptxas": ptxas})


def make_inputs(gen, sq, sk):
    def mk(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.5).to(torch.bfloat16)
    return mk(B, sq, H, D), mk(B, sk, HKV, D), mk(B, sk, HKV, D), \
        mk(B, sq, H, D)


def check(name: str, got, want) -> dict:
    """Hold one output against its plain version with limits scaled to
    that output (see REL): every element within atol + ATOL * |want|, where
    atol = min(ATOL, REL * max|want|), and relative L2 within REL; lse
    within LSE_ATOL. ``ratio`` is the error over its limit (the larger of
    the two for a scaled output): the check passes at ratio <= 1."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    if name == "lse":
        return {"max_abs_err": err, "limit": LSE_ATOL,
                "ratio": err / LSE_ATOL, "ok": err <= LSE_ATOL}
    atol = min(ATOL, REL * want.abs().max().item())
    elementwise = (diff / (atol + ATOL * want.abs())).max().item()
    rel_l2 = (diff.norm() / want.norm()).item()
    ratio = max(elementwise, rel_l2 / REL)
    return {"max_abs_err": err, "atol": atol, "rel_l2": rel_l2,
            "ratio": ratio, "ok": ratio <= 1.0}


def perturbed(q, k, v, do, ref, delta, causal, q_offset):
    """Plain-version outputs of kernels gone wrong in typical ways, which
    the check must reject: each a dict of the outputs it changes."""
    lse = ref["lse"]
    k_rest, v_rest, k_off = k[:, BLOCK:], v[:, BLOCK:], q_offset - BLOCK
    out_skip, lse_skip = fa._fwd_reference(q, k_rest, v_rest, causal, k_off)
    dk_skip, dv_skip = fa._dkv_reference(
        q[:, BLOCK:], k, v, lse[..., BLOCK:], do[:, BLOCK:],
        delta[..., BLOCK:], causal, q_offset + BLOCK)
    no_delta = torch.zeros_like(delta)
    return {
        "zeros": {n: torch.zeros_like(t) for n, t in ref.items()},
        # δ = rowsum(dO O) left out of dS = P (dP - δ) scale.
        "delta_dropped": {
            "dq": fa._dq_reference(q, k, v, lse, do, no_delta, causal,
                                   q_offset),
            "dk": fa._dkv_reference(q, k, v, lse, do, no_delta, causal,
                                    q_offset)[0]},
        # The first k tile left out of the forward's and dQ's loops (the
        # one tile every query row sees).
        "first_k_tile_skipped": {
            "out": out_skip, "lse": lse_skip,
            "dq": fa._dq_reference(q, k_rest, v_rest, lse, do, delta,
                                   causal, k_off)},
        # The first q tile left out of dK/dV's loop.
        "first_q_tile_skipped": {"dk": dk_skip, "dv": dv_skip},
    }


def check_case(gen, sq, sk, causal, q_offset, timed: bool):
    """One shape case: each kernel against its plain version, and the
    check itself against perturbed plain outputs that it must reject."""
    q, k, v, do = make_inputs(gen, sq, sk)
    ref_out, ref_lse = fa._fwd_reference(q, k, v, causal, q_offset)
    out, lse = fa._fwd_cuda(q, k, v, causal, q_offset)
    delta = fa._delta(ref_out, do)
    ref_dq = fa._dq_reference(q, k, v, ref_lse, do, delta, causal, q_offset)
    ref_dk, ref_dv = fa._dkv_reference(q, k, v, ref_lse, do, delta, causal,
                                       q_offset)
    dq = fa._dq_cuda(q, k, v, ref_lse, do, delta, causal, q_offset)
    dk, dv = fa._dkv_cuda(q, k, v, ref_lse, do, delta, causal, q_offset)
    torch.cuda.synchronize()
    ref = {"out": ref_out, "lse": ref_lse, "dq": ref_dq, "dk": ref_dk,
           "dv": ref_dv}
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    checks = {n: check(n, got[n], ref[n]) for n in ref}
    errs = {kn: max(checks[n]["max_abs_err"] for n in names)
            for kn, names in OUTPUTS.items()}
    ok = {kn: all(checks[n]["ok"] for n in names)
          for kn, names in OUTPUTS.items()}
    # ratio > 1 means the check rejects that wrong output.
    caught = {p: {n: check(n, t, ref[n])["ratio"] for n, t in outs.items()}
              for p, outs in perturbed(q, k, v, do, ref, delta, causal,
                                       q_offset).items()}
    case = {"sq": sq, "sk": sk, "causal": causal, "q_offset": q_offset,
            "max_abs_err": errs, "ok": ok, "checks": checks,
            "perturbed_ratio": caught}
    if not timed:
        return case, None

    pairs = visible_pairs(sq, sk, causal, q_offset) * H * B
    act_q, act_kv, rows = B * sq * H * D * 2, B * sk * HKV * D * 2, \
        B * H * sq * 4
    work = {  # (matmul FLOPs, bytes read once + written once)
        "flash_fwd": (pairs * 4 * D, act_q + 2 * act_kv + act_q + rows),
        "flash_dq": (pairs * 6 * D, 2 * act_q + 2 * act_kv + 2 * rows
                     + act_q),
        "flash_dkv": (pairs * 8 * D, 2 * act_q + 2 * act_kv + 2 * rows
                      + 2 * act_kv),
    }
    reps = 20
    times = {
        "flash_fwd": cuda_ms(lambda: fa._fwd_cuda(q, k, v, causal,
                                                  q_offset), reps),
        "flash_dq": cuda_ms(lambda: fa._dq_cuda(
            q, k, v, ref_lse, do, delta, causal, q_offset), reps),
        "flash_dkv": cuda_ms(lambda: fa._dkv_cuda(
            q, k, v, ref_lse, do, delta, causal, q_offset), reps),
    }
    plain = {
        "flash_fwd": cuda_ms(lambda: fa._fwd_reference(
            q, k, v, causal, q_offset), 3, 1),
        "flash_dq": cuda_ms(lambda: fa._dq_reference(
            q, k, v, ref_lse, do, delta, causal, q_offset), 3, 1),
        "flash_dkv": cuda_ms(lambda: fa._dkv_reference(
            q, k, v, ref_lse, do, delta, causal, q_offset), 3, 1),
    }
    # Yardstick only: PyTorch's fused attention on the same inputs, in its
    # [B, H, S, D] layout (views). Its backward computes dQ, dK and dV in
    # one call, so it stands beside both backward kernels.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                   enable_gqa=True), reps)
    lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), reps)
    library = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd,
               "flash_dkv": lib_bwd}
    stats = {}
    for name, (flops, nbytes) in work.items():
        bound_ms, bound_by = bound(flops, nbytes)
        stats[name] = {"ms": times[name], "plain_ms": plain[name],
                       "library_ms": library[name], "bound_ms": bound_ms,
                       "bound_by": bound_by, "flops": flops,
                       "bytes": nbytes}
    case["timing"] = stats
    return case, stats


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, stats = [], None
    for sq, sk, causal, q_offset, timed in (
            (S, S, True, 0, True),            # the training step's shape
            (S, S, False, 0, False),
            (S // 2, S, True, S // 2, False)):
        case, st = check_case(gen, sq, sk, causal, q_offset, timed)
        cases.append(case)
        stats = stats or st
    emit({"phase": "kernels",
          "tolerance": {"atol": f"min({ATOL}, {REL} * max|ref|)",
                        "rtol": ATOL, "rel_l2": REL, "lse_atol": LSE_ATOL},
          "cases": cases})
    bad = [(c["sq"], c["sk"], c["causal"], n) for c in cases
           for n, good in c["ok"].items() if not good]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"beyond the scaled limits: {bad}")
    # The check must reject wrong outputs: zeros in every case, and every
    # perturbed output at the training step's shape.
    missed = [(c["sq"], c["causal"], p, n) for i, c in enumerate(cases)
              for p, ratios in c["perturbed_ratio"].items()
              for n, r in ratios.items()
              if r <= 1.0 and (i == 0 or p == "zeros")]
    if missed:
        raise AssertionError(f"the kernel check accepts wrong outputs: "
                             f"{missed}")
    errs = {n: max(c["max_abs_err"][n] for c in cases) for n in PER_STEP}
    return stats, errs


def slice_config():
    return dataclasses.replace(llama_3_8b(), n_layers=4, remat=True,
                               remat_policy="full")


def phase_model(model, tokens):
    """On a short input, the bf16 logits through the kernels and through
    the reference attention, each against the same weights in f32 with the
    reference attention (relative L2). The kernel path passes when it is
    no further from f32 than the bf16 reference path is (x1.25)."""
    def logits_of(**fields):
        other = Llama(dataclasses.replace(model.cfg, **fields),
                      device="cuda")
        other.load_state_dict(model.state_dict())
        with torch.no_grad():
            out = other(tokens).float()
        del other
        torch.cuda.empty_cache()
        return out

    with torch.no_grad():
        got = model(tokens).float()
    plain = logits_of(attention_impl="xla")
    truth = logits_of(attention_impl="xla", dtype=torch.float32)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    kernel_err, plain_err = rel(got, truth), rel(plain, truth)
    emit({"phase": "model", "tokens": list(tokens.shape),
          "logits_shape": list(got.shape),
          "finite": bool(torch.isfinite(got).all()),
          "rel_l2_kernel_vs_f32": kernel_err,
          "rel_l2_plain_vs_f32": plain_err,
          "rel_l2_kernel_vs_plain": rel(got, plain)})
    if not torch.isfinite(got).all() or kernel_err > 1.25 * plain_err:
        raise AssertionError(
            f"bf16 logits through the kernels are further from the f32 "
            f"model ({kernel_err}) than 1.25x the bf16 reference path's "
            f"({plain_err})")


def phase_train(model, batch):
    trainer = Trainer(model=model, optimizer=adamw(3e-4), device="cuda")
    state = trainer.init()
    step = trainer.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, norms, step_s = [], [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(fa.LAUNCHES)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    cfg = model.cfg
    # Model FLOPs of one step (remat recompute not counted): 6 per matmul
    # parameter per token (the embedding lookup is no matmul), plus causal
    # attention's 4 D FLOPs per (q, k) pair and head forward, x3 with the
    # backward.
    matmul_params = sum(p.numel() for n, p in model.named_parameters()
                        if n.endswith(".weight") and "embed" not in n)
    flops = (6 * matmul_params * B * S + 3 * 4 * cfg.head_dim * cfg.n_heads
             * visible_pairs(S, S, True, 0) * cfg.n_layers * B)
    emit({"phase": "train", "layers": cfg.n_layers,
          "params": sum(p.numel() for p in model.parameters()),
          "batch": B, "seq": S, "steps": STEPS, "losses": losses,
          "grad_norms": norms, "step_ms": [t * 1e3 for t in step_s],
          "ms_per_step": steady * 1e3, "tokens_per_s": B * S / steady,
          "model_flops_per_step": flops,
          "mfu_vs_989_tflops": flops / steady / PEAK_BF16,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches})
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = {n: c * STEPS for n, c in PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} "
                             f"({PER_STEP} per step)")
    return launches, step, state


def kernel_class(name: str) -> str:
    if "flash_" in name:
        return "flash attention kernels"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "multi_tensor_apply" in name:
        return "optimizer (foreach)"
    return "other"


def phase_profile(step, state, batch):
    """One more step under torch.profiler: device time by kernel class,
    the busiest kernels, and the device's idle share of the step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        # Device-side ranges of user annotations (e.g. Optimizer.step)
        # span kernels that are counted on their own.
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
            continue
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us() / 1e3)
    by_class, top = {}, {}
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        if len(top.setdefault(cls, [])) < 4:
            top[cls].append([name[:100], ms])
    busy = sum(by_class.values())
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / wall_ms if busy else None,
          "by_class_ms": by_class, "top_kernels_ms": top})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    phase_env()
    phase_build()
    stats, errs = phase_kernels()

    cfg = slice_config()
    model = Llama(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (B, S + 1))
    phase_model(model, torch.as_tensor(tokens[:, :512], device="cuda"))
    launches, step, state = phase_train(model, {"inputs": tokens})
    phase_profile(step, state, {"inputs": tokens})

    summary = []
    for name in PER_STEP:
        st = stats[name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"]})
    emit({"kernels": summary})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
