#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the
port's main path (``repro_torch.core.engine.stable_sweep``) at
n = 1,000,000 and 10,000,000, checks its rows, and pins its LDT against
a float64 numpy oracle.  Each phase prints one line; the line before the
last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  ``--json`` also writes every number
of the run to PATH; ``--profile`` also traces one warm ``stable_sweep``
per main-path shape.  Any failed phase exits non-zero, and so does a
machine without CUDA.  Imports ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

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
FRAME_B = 122.0                    # Snow DATA frame at a 64 B payload


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, from CUDA events."""
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


def phase_card_and_build() -> str:
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    log = _build.build("tree_sweep")
    secs = time.perf_counter() - t
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {secs:.3f} s for tree_sweep "
          f"(ptxas: {' | '.join(regs) or 'cached'})", flush=True)
    return smi


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
    smi = phase_card_and_build()
    err, timings = phase_kernel_vs_plain(dev)
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
        "bytes": main_t["bytes"]}]}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {**record, "device": name, "sweeps": timings, "main_path": runs,
             "statistical_pin": pin, "profile": prof}, indent=1))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
