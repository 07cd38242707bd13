#!/usr/bin/env python3
"""What the lo term of P costs the bf16 attention kernels, on one NVIDIA GPU.

    python3 p_lo_cost.py [--json PATH]

The bf16 flash and decode kernels carry P into P . V as two bf16 terms,
hi = bf16(p) and lo = bf16(p - hi).  This script builds each of the two
libraries twice from ``src/repro_torch/kernels/csrc``: as it stands, and
with the lo product cut out of the source (P rounded once to bf16, as
most tensor-core attention kernels do; the copy goes under ``build/``).
It prints each build's ptxas registers and spills, then, at the
bf16 flash and decode shapes of ``chip_smoke.py`` (the same inputs and
seeds), each build's time from CUDA events in the order as-is, hi only,
hi only, as-is, and each build's max abs error against the plain
version with whether it is inside ``chip_smoke.py``'s bf16 tolerance.
Both builds are called through the same wrapper, so the host's share of
each call is the same.  Imports ``repro_torch`` and ``chip_smoke``
only; exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as smoke

#: per library, the source lines that add the lo term's product
LO_LINES = {
    "flash_attention": ("  repro::fence_regs(lo);\n",
                        "    repro::wgmma_rs<HD>(o, b, dv);\n"),
    "decode_attention": (
        "        repro::mma_bf16_16816(o[2 * nn + h], p_lo, bv[2 * h], "
        "bv[2 * h + 1]);\n",),
}


def hi_only_sources(out_dir: Path) -> dict:
    """Copies of the kernel sources with the lo product cut out of the
    two attention kernels; returns each library's source path."""
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    for src in _build.SRC_DIR.glob("*.cu*"):
        text = src.read_text()
        for line in LO_LINES.get(src.stem, ()):
            if text.count(line) != 1:
                smoke.fail(f"{src.name}: the lo term's line {line.strip()!r}"
                           " is not there once")
            text = text.replace(line, "")
        (out_dir / src.name).write_text(text)
    return {name: out_dir / f"{name}.cu" for name in LO_LINES}


def ptxas_facts(log: str) -> dict:
    regs = [int(ln.split("Used ")[1].split()[0])
            for ln in log.splitlines() if "registers" in ln]
    spills = sum(int(ln.split("bytes spill stores")[0].split()[-1])
                 for ln in log.splitlines() if "spill stores" in ln)
    return {"registers": max(regs, default=None), "spill_bytes": spills,
            "wgmma_serialized": log.count("C7512")}


def build(out_dir: Path) -> tuple:
    """Both builds of both libraries, all nvcc started together: the
    loaded libraries {"as_is": {...}, "hi_only": {...}} and their ptxas
    facts (None for a library built before this run)."""
    from repro_torch.kernels import _build

    names = list(LO_LINES)
    sources = hi_only_sources(out_dir)
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src),
             *_build.LINK_FLAGS], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = _build.build_all(names)
    libs = {"as_is": {n: _build.load(n) for n in names}, "hi_only": {}}
    facts = {"as_is": {n: ptxas_facts(logs[n]) if logs[n] else None
                       for n in names}, "hi_only": {}}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            smoke.fail(f"nvcc failed for the hi-only {name}:\n{log}")
        libs["hi_only"][name] = ctypes.CDLL(str(lib))
        facts["hi_only"][name] = ptxas_facts(log)
    return libs, facts


@contextlib.contextmanager
def loaded(name: str, lib: ctypes.CDLL):
    """The wrappers launch from ``lib`` while inside."""
    from repro_torch.kernels import _build

    saved = _build._LOADED[name]
    _build._LOADED[name] = lib
    try:
        yield
    finally:
        _build._LOADED[name] = saved


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels import _build

    libs, facts = build(_build.BUILD_DIR / "p_hi_only")
    for variant, per_lib in facts.items():
        for name, f in per_lib.items():
            print(f"{variant} {name}: ptxas {f}", flush=True)
    record = {"card": smi, "ptxas": facts, "cases": []}
    for i, (kernel, label, p) in enumerate(smoke.ML_CASES):
        if kernel not in LO_LINES:
            continue
        x = smoke.ml_inputs(kernel, p, torch.bfloat16, dev, 13 + i)
        want = smoke.ml_call(kernel, x, p, plain=True)
        row = {"kernel": kernel, "label": label, "shape": p,
               "ms": {"as_is": [], "hi_only": []}}
        for variant in ("as_is", "hi_only"):
            with loaded(kernel, libs[variant][kernel]):
                err, atol, ok = smoke.compare(smoke.ml_call(kernel, x, p),
                                              want, torch.bfloat16)
            row[variant] = {"max_abs_err": err, "atol": atol,
                            "within_tolerance": ok}
        del want
        for variant in ("as_is", "hi_only", "hi_only", "as_is"):
            with loaded(kernel, libs[variant][kernel]):
                row["ms"][variant].append(smoke.cuda_ms(
                    lambda: smoke.ml_call(kernel, x, p),
                    smoke.ML_OPS[kernel].reps))
        print(f"{kernel} {label}: as-is {row['ms']['as_is']} ms, max abs "
              f"err {row['as_is']['max_abs_err']}; hi only "
              f"{row['ms']['hi_only']} ms, max abs err "
              f"{row['hi_only']['max_abs_err']} (atol {atol}, within "
              f"tolerance {row['hi_only']['within_tolerance']})", flush=True)
        record["cases"].append(row)
        del x
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))


if __name__ == "__main__":
    sys.exit(main())
