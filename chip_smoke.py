#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together) and prints, per library,
ptxas's registers and spills and the counts of the SASS instructions
that show its design (``HGMMA``, ``UTMALDG``, ``LDGSTS``, ``HMMA`` from
``cuobjdump -sass``); holds each kernel against its plain PyTorch
version on the card, and drives the port's two paths: the stable sweep
(``repro_torch.core.engine.stable_sweep``) at n = 1,000,000 and
10,000,000, whose rows it checks and whose LDT it pins against a float64
numpy oracle; and the attention and recurrence ops
(``repro_torch.kernels.ops``) at the full widths of qwen3-0.6b,
recurrentgemma-9b and rwkv6-1.6b, each held against its plain version
and timed beside its bound and, for attention, a PyTorch library call
(SDPA; for the sliding window, compiled FlexAttention); then each op
again in float32 at the same shapes. Each phase prints its lines as it
ends; the line before the last is the kernels' JSON record, the last
line ``{"ok": true, "device": {...}}``. ``--json`` also writes every
number of the run to PATH; ``--profile`` also traces one warm
``stable_sweep`` per main-path shape. Any failed phase exits non-zero,
and so does a machine without CUDA. Imports ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN, K, SEEDS, M = 1_000_000, 4, tuple(range(5)), 20
N_BIG, M_BIG = 10_000_000, 2
N_PIN, PIN_SEEDS, PIN_TOL = 50_000, tuple(range(16)), 0.12
# H100 SXM data sheet: HBM rate, and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core rate
FRAME_B = 122.0                    # Snow DATA frame at a 64 B payload

# The ops path at the configs' full widths (src/repro/configs/*.py and
# the registry's SHAPES): (kernel, label, shape).  Cuts of batch only:
# 32 -> 1 for flash attention (a simple kernel does about 4.4e12
# operations per call) and 32 -> 8 for the two scans (the plain
# versions' float32 copies must fit beside the inputs).  Every case runs
# in bfloat16 (the configs' dtype), then again in float32.
ML_CASES = (
    ("flash_attention", "qwen3-0.6b prefill_32k",
     dict(b=1, h=16, hkv=8, s=32768, hd=128, window=None)),
    ("flash_attention", "recurrentgemma-9b local attention prefill_32k",
     dict(b=1, h=16, hkv=1, s=32768, hd=256, window=2048)),
    ("decode_attention", "qwen3-0.6b decode_32k",
     dict(b=128, h=16, hkv=8, s=32768, hd=128, length=32000, window=None)),
    ("decode_attention", "recurrentgemma-9b ring cache decode_32k",
     dict(b=128, h=16, hkv=1, s=2048, hd=256, length=2048, window=None)),
    ("rglru_scan", "recurrentgemma-9b prefill_32k",
     dict(b=8, t=32768, w=4096)),
    ("wkv6", "rwkv6-1.6b prefill_32k", dict(b=8, t=32768, h=32, hd=64)),
)
# (rtol, atol) of kernel against plain version, element by element:
# |d| <= atol + rtol |plain|.  In bfloat16 the absolute part is 2e-2 of
# the plain output's RMS, since an attention output that averages 32k
# values is about 0.01 and a fixed 2e-2 would pass anything; only one
# bf16 rounding step at the output's own magnitude separates the two.
# In float32 only the order of the float32 sums differs: 1e-4 absolute
# and relative.
ML_TOL = {torch.bfloat16: (2e-2, "rms"), torch.float32: (1e-4, 1e-4)}


def _flash_inputs(p: dict, rn, dev) -> dict:
    return {"q": rn(p["b"], p["h"], p["s"], p["hd"]),
            "k": rn(p["b"], p["hkv"], p["s"], p["hd"]),
            "v": rn(p["b"], p["hkv"], p["s"], p["hd"])}


def _flash_library(x: dict, p: dict):
    """SDPA with GQA; for a window, FlexAttention compiled with a causal
    sliding-window block mask, which skips the masked blocks as the
    kernel does.  Returns (call, name of the call)."""
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    if p["window"] is None:
        return (lambda: F.scaled_dot_product_attention(
            x["q"], x["k"], x["v"], is_causal=True, enable_gqa=True),
            "scaled_dot_product_attention(is_causal, enable_gqa)")
    w, s = p["window"], p["s"]
    mask = create_block_mask(lambda b, h, qi, ki: (ki <= qi) & (ki > qi - w),
                             None, None, s, s, device=x["q"].device)
    flex = torch.compile(flex_attention, dynamic=False)
    return (lambda: flex(x["q"], x["k"], x["v"], block_mask=mask,
                         enable_gqa=True),
            "flex_attention (compiled, causal + window block mask)")


def _flash_bound(p: dict, elem: int) -> tuple:
    """Only the (query, key) pairs the mask keeps; bf16 tensor-core rate."""
    w = p["window"] or p["s"]
    pairs = sum(min(i + 1, w) for i in range(p["s"]))
    nbytes = elem * p["b"] * p["s"] * p["hd"] * (2 * p["h"] + 2 * p["hkv"])
    return nbytes, 4 * p["b"] * p["h"] * p["hd"] * pairs, BF16_OPS_PER_S


def _decode_rows(p: dict) -> tuple:
    """The valid cache rows [lo, hi) of this length and window."""
    hi = min(p["length"], p["s"])
    lo = 0 if p["window"] is None else max(0, p["length"] - p["window"])
    return lo, hi


def _decode_inputs(p: dict, rn, dev) -> dict:
    return {"q": rn(p["b"], p["h"], p["hd"]),
            "k": rn(p["b"], p["s"], p["hkv"], p["hd"]),
            "v": rn(p["b"], p["s"], p["hkv"], p["hd"]),
            "length": torch.tensor(p["length"], device=dev)}


def _decode_library(x: dict, p: dict):
    """SDPA with GQA on the valid slice of the transposed cache."""
    import torch.nn.functional as F

    lo, hi = _decode_rows(p)
    k = x["k"][:, lo:hi].transpose(1, 2)
    v = x["v"][:, lo:hi].transpose(1, 2)
    return (lambda: F.scaled_dot_product_attention(
        x["q"][:, :, None], k, v, enable_gqa=True)[:, :, 0],
        "scaled_dot_product_attention(enable_gqa) on the valid slice")


def _decode_bound(p: dict, elem: int) -> tuple:
    """Only the valid cache rows; bf16 tensor-core rate."""
    lo, hi = _decode_rows(p)
    rows = max(0, hi - lo)
    nbytes = elem * p["b"] * p["hd"] * (2 * p["h"] + 2 * p["hkv"] * rows)
    return nbytes, 4 * p["b"] * p["h"] * p["hd"] * rows, BF16_OPS_PER_S


def _rglru_inputs(p: dict, rn, dev) -> dict:
    """Gates in (0.01, 0.99), as the tests draw them."""
    a = rn(p["b"], p["t"], p["w"]).sigmoid_().mul_(0.98).add_(0.01)
    return {"a": a, "b": rn(p["b"], p["t"], p["w"], scale=0.5),
            "h0": rn(p["b"], p["w"], dt=torch.float32)}


def _rglru_bound(p: dict, elem: int) -> tuple:
    """float32 arithmetic on a float32 carry: the float32 rate."""
    n = p["b"] * p["t"] * p["w"]
    return 3 * elem * n + 2 * 4 * p["b"] * p["w"], 2 * n, F32_OPS_PER_S


def _wkv6_inputs(p: dict, rn, dev) -> dict:
    """Log-decays in (-inf, 0], as the tests draw them."""
    shape = (p["b"], p["t"], p["h"], p["hd"])
    return {"r": rn(*shape), "k": rn(*shape), "v": rn(*shape),
            "logw": rn(*shape).abs_().mul_(-0.5),
            "u": rn(p["h"], p["hd"], scale=0.1),
            "s0": rn(p["b"], p["h"], p["hd"], p["hd"], scale=0.2,
                     dt=torch.float32)}


def _wkv6_bound(p: dict, elem: int) -> tuple:
    """float32 arithmetic on a float32 hd x hd state: the float32 rate."""
    n = p["b"] * p["t"] * p["h"]
    nbytes = (5 * elem * n * p["hd"] + elem * p["h"] * p["hd"]
              + 2 * 4 * p["b"] * p["h"] * p["hd"] ** 2)
    return nbytes, n * (5 * p["hd"] ** 2 + 5 * p["hd"]), F32_OPS_PER_S


@dataclass(frozen=True)
class MlOp:
    """Everything the smoke knows of one op.  ``inputs(p, rn, dev)`` makes
    its arguments in call order (``rn`` draws seeded normals on ``dev``);
    ``kwargs(p)`` its keywords; ``plain`` names its plain version in
    ``repro_torch.kernels.ref``; ``library(x, p)`` gives one PyTorch call
    of the same function as a yardstick (the port never calls it) and
    its name, or None where there is none; ``bound(p, elem)`` gives
    (bytes, operations, rate) of the least work; ``reps`` is how many
    kernel calls one timing averages."""
    source: str
    replaces: str
    plain: str
    inputs: Callable
    kwargs: Callable
    bound: Callable
    library: Callable = lambda x, p: None
    reps: int = 10


ML_OPS = {
    "flash_attention": MlOp(
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:82", "mha_reference",
        _flash_inputs, lambda p: {"causal": True, "window": p["window"]},
        _flash_bound, _flash_library, reps=3),
    "decode_attention": MlOp(
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:76",
        "decode_attention_reference", _decode_inputs,
        lambda p: {"window": p["window"]}, _decode_bound, _decode_library),
    "rglru_scan": MlOp(
        "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan.py:62", "rglru_scan_reference",
        _rglru_inputs, lambda p: {}, _rglru_bound),
    "wkv6": MlOp(
        "src/repro_torch/kernels/csrc/wkv6.cu",
        "src/repro/kernels/wkv6.py:77", "wkv6_reference",
        _wkv6_inputs, lambda p: {}, _wkv6_bound, reps=5),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the card, from CUDA events, after
    one warm-up call unless ``warm`` is false (the caller warmed it)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a - b).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def sweep_bound(fp: torch.Tensor, plan) -> dict:
    """The least time the card could take for one sweep.  Bytes: fp and
    link read once, t0 read once, the (rows, n) times written once, and
    the plan's level schedule (int32 node and parent of every reached
    node) read once.  Operations: two f32 adds per (row, reached node)."""
    rows, n = fp.shape
    reached = int(plan.level_csr.nodes.numel())
    nbytes = 4 * (3 * rows * n + rows) + 8 * reached
    ops = 2 * rows * reached
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / F32_OPS_PER_S
    return {"rows": rows, "n": n, "bytes": nbytes, "ops": ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


#: SASS instructions that show each design reached the card: wgmma
#: (HGMMA), TMA tile loads (UTMALDG), cp.async (LDGSTS), mma.sync (HMMA)
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA")


def cuobjdump_path() -> str:
    """The toolkit's cuobjdump, else the one Triton's package carries."""
    import importlib.util
    import os
    import shutil

    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
             / "cuobjdump"]
    found = shutil.which("cuobjdump")
    if found:
        cands.append(Path(found))
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(Path(spec.origin).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    for c in cands:
        if c.exists():
            return str(c)
    fail("no cuobjdump (CUDA toolkit or triton/backends/nvidia/bin)")


def sass_counts(lib: Path, cuobjdump: str) -> dict:
    import re

    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def phase_card_and_build() -> tuple:
    """The card's name and power limit; every library built; per library
    the most registers, the spilled bytes and the entries whose wgmma
    ptxas serialized (None for a library that was built before this
    run) and its SASS counts."""
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t
    cuobjdump = cuobjdump_path()
    facts = {}
    for kernel, log in logs.items():
        regs = [int(ln.split("Used ")[1].split()[0])
                for ln in log.splitlines() if "registers" in ln]
        spills = sum(int(ln.split("bytes spill stores")[0].split()[-1])
                     for ln in log.splitlines() if "spill stores" in ln)
        facts[kernel] = {
            "registers": max(regs, default=0) if log else None,
            "spill_bytes": spills if log else None,
            # ptxas C7512: wgmma waited at once, short of registers
            "wgmma_serialized": log.count("C7512") if log else None,
            "sass": sass_counts(_build.library_path(kernel), cuobjdump)}
    print(f"build: {secs:.3f} s for {len(logs)} kernels in parallel",
          flush=True)
    for kernel, f in facts.items():
        ptxas = (f"at most {f['registers']} registers, {f['spill_bytes']} B "
                 f"spilled, {f['wgmma_serialized']} entries with serialized "
                 "wgmma" if f["registers"] is not None else
                 "built before this run")
        print(f"library {kernel}: ptxas {ptxas}; SASS "
              + ", ".join(f"{k} {v}" for k, v in f["sass"].items()),
              flush=True)
    return smi, facts


def check_pair(plan, fp, link, t0, what: str, timing: dict = None) -> float:
    """Kernel against plain version on one plan's planes (bit-equal,
    NaN-aware); with ``timing``, also their milliseconds and the bound.
    These launches are comparisons, not the main path."""
    from repro_torch.kernels.tree_sweep import level_sweep, tree_sweep_cuda

    def kernel():
        return tree_sweep_cuda(plan.parent, plan.depth, fp, link, t0,
                               root=plan.root, height=plan.height,
                               levels=plan.level_csr)

    def plain():
        return level_sweep(plan.parent, plan.depth, fp, link, t0,
                           root=plan.root, height=plan.height)

    a, b = kernel(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(a, b)
    if not nan_equal(a, b):
        fail(f"tree_sweep kernel differs from level_sweep on {what}: "
             f"max abs err {err}")
    if timing is not None:
        timing["ms"] = cuda_ms(kernel, 10)
        timing["plain_ms"] = cuda_ms(plain, 3)
        timing.update(sweep_bound(fp, plan))
        timing["height"] = plan.height
    return err


def phase_kernel_vs_plain(dev) -> tuple:
    from repro_torch.core.device_sweep import (_plan_slot, message_starts,
                                               rng_planes)
    from repro_torch.core.engine import stable_plans
    from repro_torch.kernels.tree_sweep import fwd_at_parent

    errs, timings, cases = [], {}, 0
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    # the main path's shapes: 1M for both protocols, and snow at 10M
    for proto, n, seeds, m in (("snow", N_MAIN, SEEDS, M),
                               ("coloring", N_MAIN, SEEDS, M),
                               ("snow", N_BIG, (0,), M_BIG)):
        plans = stable_plans(proto, torch.arange(n, device=dev), 0, K,
                             device=dev)
        planes = rng_planes(plans, seeds, m)
        t0 = message_starts(m, 1.0, len(seeds), dev)
        for plan in plans:
            fwd, link = planes(_plan_slot(plan))
            fp = fwd_at_parent(plan.parent, fwd, plan.root)
            name = f"{proto}/tree={plan.tree}/n={n}"
            timings[name] = {}
            errs.append(check_pair(plan, fp, link, t0, name, timings[name]))
            dead = torch.rand(link.shape, generator=g, device=dev) < 0.05
            errs.append(check_pair(plan, fp,
                                   torch.where(dead, float("nan"), link), t0,
                                   f"{name} NaN links"))
            cases += 2
            del fp, fwd, link, dead
        del planes, plans, t0
    # edge cases: tiny views, k = 2, a permuted ring, NaN links
    ring = torch.randperm(1001, generator=g, device=dev)
    small = [(n, 2, None) for n in (1, 2, 3, 5)] + [(1001, 4, ring)]
    for n, k, rg in small:
        for proto in ("snow", "coloring"):
            root = int(rg[500]) if rg is not None else 0
            plans = stable_plans(proto, torch.arange(n, device=dev), root, k,
                                 ring=rg, device=dev)
            for plan in plans:
                fwd = torch.rand((6, n), generator=g, device=dev) * 0.19 + 0.01
                link = torch.rand((6, n), generator=g, device=dev) * 1e-3
                t6 = torch.arange(6, device=dev, dtype=torch.float32)
                fp = fwd_at_parent(plan.parent, fwd, plan.root)
                what = f"{proto} n={n} k={k} ring={rg is not None}"
                errs.append(check_pair(plan, fp, link, t6, what))
                dead = torch.rand((6, n), generator=g, device=dev) < 0.05
                errs.append(check_pair(
                    plan, fp, torch.where(dead, float("nan"), link), t6,
                    f"{what} NaN links"))
                cases += 2
    err = max(errs)
    print(f"kernel vs plain: {cases} cases bit-equal (max abs err {err}); "
          + "; ".join(f"{k} rows={v['rows']} "
                      f"height={v['height']}: kernel {v['ms']} ms, "
                      f"plain {v['plain_ms']} ms, bound {v['bound_ms']} ms "
                      f"({v['bytes']} B / 3.35 TB/s)"
                      for k, v in timings.items()), flush=True)
    return err, timings


def ml_inputs(kernel: str, p: dict, dtype, dev, seed: int) -> dict:
    """Seeded inputs of one op, made on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rn(*shape, scale=1.0, dt=dtype):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dt).mul_(scale)

    return ML_OPS[kernel].inputs(p, rn, dev)


def ml_call(kernel: str, x: dict, p: dict, plain: bool = False) -> tuple:
    """One call of the op through ``repro_torch.kernels.ops`` (which
    launches the kernel on CUDA tensors), or of its plain version."""
    from repro_torch.kernels import ops, ref

    op = ML_OPS[kernel]
    fn = getattr(ref, op.plain) if plain else getattr(ops, kernel)
    out = fn(*x.values(), **op.kwargs(p))
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def ml_bound(kernel: str, p: dict, elem: int) -> dict:
    """The least time the card could take for the op on these inputs:
    each input read once and each output written once over 3.35 TB/s,
    against the operations over the rate of their type (attention's
    products can run on the bf16 tensor cores; the scans' float32
    carry or state holds no tensor-core type)."""
    nbytes, ops, rate = ML_OPS[kernel].bound(p, elem)
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / rate
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def compare(got: tuple, want: tuple, dtype) -> tuple:
    """(max abs error, the absolute tolerance of the first output,
    whether every element is within ``ML_TOL[dtype]``), in slices along
    dim 0 to bound the float32 temporaries."""
    rtol, atol = ML_TOL[dtype]
    err, ok, atols = 0.0, True, []
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"output {tuple(a.shape)} {a.dtype} is not the plain "
                 f"version's {tuple(b.shape)} {b.dtype}")
        if atol == "rms":
            sq = sum(float(b[i].float().square().sum())
                     for i in range(b.shape[0]))
            atols.append(rtol * math.sqrt(sq / b.numel()))
        else:
            atols.append(atol)
        for i in range(a.shape[0]):
            want_i = b[i].float()
            d = (a[i].float() - want_i).abs()
            err = max(err, float(d.max()))
            ok = ok and bool((d <= atols[-1] + rtol * want_i.abs()).all())
    return err, atols[0], ok


def phase_ml_path(dev) -> tuple:
    """The ops path: every case's inputs made first, the four launch
    counters set to 0, one call of each op through ``ops`` on CUDA
    tensors, the counters read.  Outputs must be finite, of the input
    dtype and the oracle's shapes."""
    wrappers = {k: getattr(importlib.import_module(
        f"repro_torch.kernels.{k}"), f"{k}_cuda") for k in ML_OPS}
    inputs = [ml_inputs(kernel, p, torch.bfloat16, dev, 13 + i)
              for i, (kernel, _, p) in enumerate(ML_CASES)]
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    outs, walls = [], []
    for (kernel, _, p), x in zip(ML_CASES, inputs):
        t = time.perf_counter()
        outs.append(ml_call(kernel, x, p))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    launches = {k: w.launches for k, w in wrappers.items()}
    expected = {k: sum(c[0] == k for c in ML_CASES) for k in wrappers}
    if launches != expected:
        fail(f"ops path launched {launches}, expected {expected}")
    for (kernel, label, _), x, out in zip(ML_CASES, inputs, outs):
        lead = next(iter(x.values()))     # q, q, a, r: the output's shape
        if out[0].shape != lead.shape or out[0].dtype != torch.bfloat16:
            fail(f"{kernel} {label}: output {tuple(out[0].shape)} "
                 f"{out[0].dtype}, expected {tuple(lead.shape)} bf16")
        if not all(bool(torch.isfinite(o).all()) for o in out):
            fail(f"{kernel} {label}: non-finite output")
    print("ops path: launches " + ", ".join(f"{k} {v}" for k, v in
                                            launches.items())
          + "; first-call wall " + ", ".join(
              f"{c[1]} {w} s" for c, w in zip(ML_CASES, walls)), flush=True)
    return launches, inputs, outs


def phase_ml_kernels(dev, inputs: list, outs: list) -> dict:
    """Each op's path output against its plain version on the same bf16
    inputs, then kernel, plain and library times and the bound; then
    each shape again in float32.  Frees each case's tensors when done."""
    results = {}
    for i, (kernel, label, p) in enumerate(ML_CASES):
        op, x, got = ML_OPS[kernel], inputs[i], outs[i]
        want = ml_call(kernel, x, p, plain=True)
        err, atol, ok = compare(got, want, torch.bfloat16)
        if not ok:
            fail(f"{kernel} {label}: kernel differs from its plain version "
                 f"(max abs err {err}, tolerance {atol} + "
                 f"{ML_TOL[torch.bfloat16][0]} relative)")
        del want
        ms = cuda_ms(lambda: ml_call(kernel, x, p), op.reps)
        plain_ms = cuda_ms(lambda: ml_call(kernel, x, p, plain=True), 1,
                           warm=False)
        lib = op.library(x, p)
        lib, library_call = lib if lib is not None else (None, None)
        library_ms = cuda_ms(lib, 10) if lib is not None else None
        lib_err = (compare((lib(),), got, torch.bfloat16)[0]
                   if lib is not None else None)
        results[label] = {"kernel": kernel, "shape": {"config": label, **p},
                          "max_abs_err": err, "atol": atol, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "library_max_abs_err": lib_err,
                          "library_call": library_call,
                          **ml_bound(kernel, p, 2)}
        r = results[label]
        print(f"{kernel} {label}: max abs err {err} vs plain (atol {atol}); "
              f"kernel {ms} ms, plain {plain_ms} ms, library {library_ms} "
              f"ms ({library_call}), bound {r['bound_ms']} ms by "
              f"{r['bound_by']} ({r['bytes']} B, {r['ops']} ops)", flush=True)
        inputs[i] = outs[i] = None
        del x, got
        torch.cuda.empty_cache()
    for j, (kernel, label, p) in enumerate(ML_CASES):
        x = ml_inputs(kernel, p, torch.float32, dev, 101 + j)
        err, atol, ok = compare(ml_call(kernel, x, p),
                                ml_call(kernel, x, p, plain=True),
                                torch.float32)
        if not ok:
            fail(f"{kernel} {label} float32: kernel differs from its plain "
                 f"version (max abs err {err}, tolerance {atol} + "
                 f"{ML_TOL[torch.float32][0]} relative)")
        results[f"{label} float32"] = {"kernel": kernel, "shape": p,
                                       "max_abs_err": err}
        print(f"{kernel} {label} float32: max abs err {err} vs plain",
              flush=True)
        del x
        torch.cuda.empty_cache()
    return results


def ml_record(launches: dict, results: dict) -> list:
    """One entry per kernel: the numbers of its first path shape, every
    other shape under ``more_shapes``, the float32 checks' errors."""
    keys = ("shape", "max_abs_err", "atol", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_call", "bytes", "ops")
    out = []
    for kernel, op in ML_OPS.items():
        rows = [r for r in results.values()
                if r["kernel"] == kernel and "ms" in r]
        f32 = [r["max_abs_err"] for r in results.values()
               if r["kernel"] == kernel and "ms" not in r]
        out.append({"name": kernel, "route": "cuda", "source": op.source,
                    "replaces": op.replaces, "launches": launches[kernel],
                    **{k: rows[0][k] for k in keys},
                    "more_shapes": [{k: r[k] for k in keys}
                                    for r in rows[1:]],
                    "f32_max_abs_err": max(f32)})
    return out


def phase_main_path(dev) -> tuple:
    from repro_torch.core.engine import stable_sweep
    from repro_torch.core.faults import LossModel
    from repro_torch.kernels.tree_sweep import tree_sweep_cuda

    # (protocol, n, seeds, messages, loss, calls): the first call of a
    # shape warms the allocator, the last one is timed
    runs = [("snow", N_MAIN, SEEDS, M, None, 2),
            ("coloring", N_MAIN, SEEDS, M, None, 2),
            ("snow", N_MAIN, SEEDS, M, LossModel(rate=0.05), 2),
            ("snow", N_BIG, (0,), M_BIG, None, 1)]
    tree_sweep_cuda.launches = 0
    out = []
    for proto, n, seeds, m, loss, calls in runs:
        for _ in range(calls):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = stable_sweep(proto, n, K, seeds, m, loss=loss, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        out.append((proto, n, m, loss, rows, wall, calls > 1))
    launches = tree_sweep_cuda.launches
    expected = sum(calls * (2 if proto == "coloring" else 1)
                   for proto, _, _, _, _, calls in runs)
    if launches != expected:
        fail(f"main path launched tree_sweep {launches} times, "
             f"expected {expected}")
    parts, record = [], []
    for proto, n, m, loss, rows, wall, warm in out:
        ldt = np.array([r["ldt"] for r in rows])
        rel = np.array([r["reliability"] for r in rows])
        rmr = np.array([r["rmr"] for r in rows])
        if not np.all(np.isfinite(ldt)) or np.any(ldt <= 0):
            fail(f"{proto} n={n}: non-finite or non-positive LDT {ldt}")
        if loss is None:
            want = FRAME_B * (2 if proto == "coloring" else 1)
            if not (np.all(rel == 1.0) and np.all(rmr == want)):
                fail(f"{proto} n={n}: reliability {rel}, rmr {rmr} "
                     f"(want 1.0, {want})")
        elif not np.all((rel > 0.99) & (rel <= 1.0)):
            fail(f"{proto} n={n} under loss: reliability {rel}")
        label = f"{proto}{' loss=0.05' if loss else ''} n={n}"
        sweep_s = sum(r["wall_s"] for r in rows)
        record.append({"run": label, "seeds": len(rows), "messages": m,
                       "wall_s": wall, "warm": warm, "plan_s": rows[0]["plan_s"],
                       "sweep_s": sweep_s, "ldt_mean_s": float(ldt.mean()),
                       "reliability_mean": float(rel.mean()),
                       "rmr_mean": float(rmr.mean())})
        parts.append(f"{label} seeds={len(rows)} M={m}: "
                     f"{'warm wall' if warm else 'first-call wall'} {wall} s "
                     f"(plan {rows[0]['plan_s']} s, sweep {sweep_s} s), "
                     f"mean LDT {ldt.mean()} s, reliability {rel.mean()}, "
                     f"rmr {rmr.mean()}")
    print(f"main path: tree_sweep launches {launches}; " + "; ".join(parts),
          flush=True)
    return launches, record


def phase_statistical_pin(dev) -> dict:
    """Mean LDT of the port's device rows against a float64 sweep on
    numpy-drawn planes (DelayBank distributions, exact-count
    stragglers), run with the plain version on the CPU."""
    from repro_torch.core.device_sweep import stable_stats_device
    from repro_torch.core.engine import stable_plans
    from repro_torch.kernels.tree_sweep import fwd_at_parent, level_sweep

    n = N_PIN
    dplans = stable_plans("snow", torch.arange(n, device=dev), 0, K,
                          device=dev)
    dev_ldt, _ = stable_stats_device(dplans, PIN_SEEDS, M)
    plan = stable_plans("snow", torch.arange(n), 0, K, device="cpu")[0]
    t0 = torch.arange(M, dtype=torch.float64)
    host = []
    for s in PIN_SEEDS:
        g = np.random.default_rng([s, 0xDE1A])
        fwd = g.uniform(0.010, 0.200, (M, n))
        link = 0.0004 * np.exp(g.normal(0.0, 0.35, (M, n)))
        fwd[:, g.choice(n, size=round(0.05 * n), replace=False)] = 1.0
        fwd_t, link_t = torch.from_numpy(fwd), torch.from_numpy(link)
        t = level_sweep(plan.parent, plan.depth,
                        fwd_at_parent(plan.parent, fwd_t, plan.root), link_t,
                        t0, root=plan.root, height=plan.height)
        host.append(float((t[:, 1:] - t0[:, None]).amax(dim=1).mean()))
    h, d = float(np.mean(host)), float(np.mean(dev_ldt))
    drift = abs(d - h) / h
    print(f"statistical pin n={n} seeds={len(PIN_SEEDS)} M={M}: device mean "
          f"LDT {d} s, f64 oracle {h} s, drift {drift} (band {PIN_TOL})",
          flush=True)
    if not drift < PIN_TOL:
        fail(f"device LDT drift {drift} outside the {PIN_TOL} band")
    return {"n": n, "seeds": len(PIN_SEEDS), "device_ldt_s": d,
            "oracle_ldt_s": h, "drift": drift}


def phase_profile(dev) -> dict:
    """Where the time of one warm ``stable_sweep`` (each main-path shape)
    goes: device time by kernel from ``torch.profiler``, and the
    device's busy share of the call's wall time (one stream, so the
    device events do not overlap and their sum is the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import stable_sweep
    from repro_torch.core.faults import LossModel

    out = {}
    for proto, loss in (("snow", None), ("coloring", None),
                        ("snow", LossModel(rate=0.05))):
        label = f"{proto}{' loss=0.05' if loss else ''} n={N_MAIN}"
        stable_sweep(proto, N_MAIN, K, SEEDS, M, loss=loss, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            stable_sweep(proto, N_MAIN, K, SEEDS, M, loss=loss, device=dev)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
        by_name = {}       # device-side events only: kernels, copies
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = e.name.replace("void ", "").replace(
                    "(anonymous namespace)::", "").replace(
                    "at::native::", "")[:90]
                by_name[key] = (by_name.get(key, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
        busy = sum(by_name.values())
        sweep = sum(v for k, v in by_name.items()
                    if k.startswith(("sweep_init", "sweep_level")))
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        out[label] = {"wall_ms": wall_ms, "device_ms": busy,
                      "busy_share": busy / wall_ms, "tree_sweep_ms": sweep,
                      "top_ms": top}
        print(f"profile {label}: wall {wall_ms} ms, device busy {busy} ms "
              f"({busy / wall_ms} of wall), tree_sweep kernels {sweep} ms; "
              "top: " + "; ".join(f"{k[:50]} {v}" for k, v in top.items()),
              flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every number of the run here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm stable_sweep per main-path "
                         "shape with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi, libs = phase_card_and_build()
    err, timings = phase_kernel_vs_plain(dev)
    ml_launches, inputs, outs = phase_ml_path(dev)
    ml = phase_ml_kernels(dev, inputs, outs)
    del inputs, outs
    torch.cuda.empty_cache()
    launches, runs = phase_main_path(dev)
    pin = phase_statistical_pin(dev)
    prof = phase_profile(dev) if args.profile else None
    main_t = timings[f"snow/tree=None/n={N_MAIN}"]
    record = {"card": smi, "kernels": [{
        "name": "tree_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_sweep.cu",
        "replaces": "src/repro/kernels/tree_sweep.py:90",
        "launches": launches, "max_abs_err": err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None, "bit_equal": err == 0.0,
        "shape": {"rows": len(SEEDS) * M, "n": N_MAIN},
        "bytes": main_t["bytes"]}] + ml_record(ml_launches, ml)}
    for entry in record["kernels"]:
        entry.update(libs[entry["name"]])
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {**record, "device": name, "sweeps": timings, "main_path": runs,
             "ops_path": ml,
             "statistical_pin": pin, "profile": prof}, indent=1))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
