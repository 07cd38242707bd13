"""PyTorch planner port against the numpy planner: every plan array
equal, exactly, on the CPU."""
import numpy as np
import pytest
import torch

from repro.core import planner as ref
from repro_torch.core import planner as port
from repro_torch.core.convert import plan_from_arrays

FIELDS = ("parent", "depth", "region_start", "region_len", "slot")
TREES = {"snow": None, "primary": port.PRIMARY, "secondary": port.SECONDARY}


def assert_plans_equal(a, b):
    assert b.root == a.root and b.k == a.k and b.tree == a.tree
    assert np.array_equal(b.members.numpy(), np.asarray(a.members))
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert y.dtype == x.dtype == np.int64, f
        assert np.array_equal(x, y), f


@pytest.mark.parametrize("tree", list(TREES), ids=list(TREES))
@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 17, 1001, 4096])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("root", ["zero", "mid"])
def test_plan_arrays_equal_numpy(tree, n, k, root):
    r = 0 if root == "zero" else n // 2
    members = np.arange(n)
    a = ref._plan(members, r, k, "numpy", TREES[tree])
    b = port._plan(torch.arange(n), r, k, TREES[tree])
    assert_plans_equal(a, b)


@pytest.mark.parametrize("tree", list(TREES), ids=list(TREES))
def test_ring_permutation_equal_numpy(tree):
    rng = np.random.default_rng(5)
    ids = np.sort(rng.choice(10 ** 6, size=1001, replace=False))
    ring = rng.permutation(ids)
    root = int(ring[333])
    if TREES[tree] is None:
        a = ref.plan_broadcast(ids, root, 4, ring=ring)
        b = port.plan_broadcast(ids, root, 4, ring=ring, device="cpu")
    else:
        a = ref.plan_colored(ids, root, 4, TREES[tree], ring=ring)
        b = port.plan_colored(ids, root, 4, TREES[tree], ring=ring,
                              device="cpu")
    assert b.root == 333
    assert_plans_equal(a, b)


def test_public_planners_resolve_views_like_numpy():
    view = [9, 3, 3, 40, 17, 25, 11, 2]        # unsorted, duplicated
    assert_plans_equal(ref.plan_broadcast(view, 17, 2),
                       port.plan_broadcast(view, 17, 2, device="cpu"))
    for a, b in zip(ref.plan_two_trees(np.arange(300), 120, 4),
                    port.plan_two_trees(np.arange(300), 120, 4,
                                        device="cpu")):
        assert_plans_equal(a, b)
    with pytest.raises(KeyError):
        port.plan_broadcast(np.arange(10), 99, 4, device="cpu")
    with pytest.raises(ValueError):
        port.plan_broadcast(np.arange(10), 0, 3, device="cpu")


def test_levels_and_level_csr_match_numpy_levels():
    a = ref.plan_colored(np.arange(777), 0, 4, ref.SECONDARY)
    b = port.plan_colored(np.arange(777), 0, 4, port.SECONDARY,
                          device="cpu")
    assert b.levels is b.levels and b.level_csr is b.level_csr
    assert b.height == a.height == len(b.levels)
    for x, y, z in zip(a.levels, b.levels, port.depth_levels(b.depth)):
        assert y.dtype == z.dtype == torch.int64
        assert np.array_equal(x, y.numpy()) and torch.equal(y, z)
    csr = b.level_csr
    assert csr.nodes.dtype == csr.parents.dtype == torch.int32
    for h, lv in enumerate(a.levels):
        sl = slice(int(csr.ptr[h]), int(csr.ptr[h + 1]))
        assert np.array_equal(csr.nodes[sl].numpy(), lv)
        assert np.array_equal(csr.parents[sl].numpy(),
                              np.asarray(a.parent)[lv])
    # the root and unreached nodes are outside the schedule
    depth = torch.tensor([2, -1, 0, 1, 1, 2])
    parent = torch.tensor([3, -1, -1, 2, 2, 4])
    csr = port.level_csr(parent, depth)
    assert csr.nodes.tolist() == [3, 4, 0, 5]
    assert csr.parents.tolist() == [2, 2, 3, 4]
    assert csr.ptr.tolist() == [0, 2, 4]


def test_plan_from_arrays_round_trips():
    a = ref.plan_colored(np.arange(500), 7, 4, ref.PRIMARY)
    b = plan_from_arrays(a.members, a.root, a.parent, a.depth,
                         a.region_start, a.region_len, a.slot, a.k, a.tree,
                         device="cpu")
    assert_plans_equal(a, b)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.plan_broadcast(np.arange(10), 0, 4)
