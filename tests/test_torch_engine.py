"""Port ``stable_sweep`` rows against the JAX package's numpy host rows on
the CPU, its input checks, and the port's import rule."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.engine import stable_sweep as ref_stable_sweep
from repro.core.specs import RunSpec
from repro_torch.core import engine as port_engine
from repro_torch.core.faults import LossModel

ROOT = Path(__file__).resolve().parents[1]
EXACT_KEYS = ("seed", "n", "k", "rmr", "rmr_redundant", "n_messages")


@pytest.mark.parametrize("protocol,n_seeds", [
    # a coloring seed's LDT is bimodal (about 1.7 s, or 2.4 s when
    # stragglers chain on both trees), so the mean over 8 seeds moves by
    # about ±9 % with the seed set alone; 64 seeds hold it inside the band
    ("snow", 8), ("coloring", 64),
])
def test_rows_match_numpy_host_rows(protocol, n_seeds):
    n, m = 5000, 10
    seeds = range(n_seeds)
    ref = ref_stable_sweep(protocol, n, 4, seeds, m,
                           run=RunSpec(engine="host", backend="numpy"))
    rows = port_engine.stable_sweep(protocol, n, 4, seeds, m, device="cpu")
    assert len(rows) == len(ref)
    for a, b in zip(ref, rows):
        assert set(b) >= set(a)
        for key in EXACT_KEYS:
            assert b[key] == a[key], key
        assert b["reliability"] == a["reliability"] == 1.0
        assert b["engine"] == "device" and b["device_name"] == "cpu"
    assert rows[0]["rmr"] == (244.0 if protocol == "coloring" else 122.0)
    h = np.mean([r["ldt"] for r in ref])
    d = np.mean([r["ldt"] for r in rows])
    assert abs(d - h) / h < 0.10


def test_loss_rows_keep_the_schema():
    rows = port_engine.stable_sweep("coloring", 800, 4, [1, 2], 3,
                                    loss=LossModel(rate=0.2), device="cpu")
    for r in rows:
        assert r["n_repaired"] == 0
        assert 0.9 < r["reliability"] <= 1.0
        # two trees: at least one frame per delivered node, at most two
        assert 122.0 * r["reliability"] <= r["rmr"] <= 244.0
        assert r["rmr_redundant"] == pytest.approx(
            r["rmr"] - 122.0 * r["reliability"], rel=1e-9)
    # an inactive loss model is the lossless sweep
    a = port_engine.stable_sweep("snow", 300, 4, [5], 2, device="cpu",
                                 loss=LossModel(rate=0.0))
    b = port_engine.stable_sweep("snow", 300, 4, [5], 2, device="cpu")
    assert a[0]["ldt"] == b[0]["ldt"] and "n_repaired" not in a[0]


def test_stable_plans_match_the_host_plan_set():
    assert len(port_engine.stable_plans("coloring", np.arange(2), 0, 4,
                                        device="cpu")) == 1
    plans = port_engine.stable_plans("coloring", np.arange(9), 0, 4,
                                     device="cpu")
    assert [p.tree for p in plans] == [0, 1]
    assert port_engine.plan_bytes(plans, 64) == 2 * 8 * 122


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.stable_sweep("snow", 100, 4, [0])


@pytest.mark.parametrize("option", ["hier", "repair", "control", "locality"])
def test_later_slices_raise(option):
    with pytest.raises(NotImplementedError, match="later slice"):
        port_engine.stable_sweep("snow", 100, 4, [0], device="cpu",
                                 **{option: "zone"})
    with pytest.raises(ValueError, match="snow/coloring"):
        port_engine.stable_sweep("gossip", 100, 4, [0], device="cpu")


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, chip_smoke.py and p_lo_cost.py import with
    JAX made unimportable, and leave no ``repro`` module loaded."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, p_lo_cost
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
assert not bad, bad
assert "repro_torch.core.device_sweep" in names
assert "repro_torch.kernels.ops" in names
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12
