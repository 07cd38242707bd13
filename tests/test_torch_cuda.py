"""The hand-written CUDA kernels against their plain PyTorch versions, on
a card, at small and edge shapes.  This file imports no JAX, so it runs
on a machine with a GPU:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without CUDA every test skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as port_engine
from repro_torch.core.planner import level_csr
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (SPLIT_ALIGN,
                                                  decode_attention_cuda,
                                                  split_count)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.kernels.tree_sweep import (fwd_at_parent, level_sweep,
                                            tree_sweep_cuda)
from repro_torch.kernels.wkv6 import wkv6_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def planes(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    fwd = rng.uniform(0.01, 0.2, (m, n)).astype(np.float32)
    link = rng.lognormal(np.log(4e-4), 0.35, (m, n)).astype(np.float32)
    return torch.from_numpy(fwd).to(dev), torch.from_numpy(link).to(dev)


def assert_nan_equal(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


@pytest.mark.parametrize("protocol", ["snow", "coloring"])
@pytest.mark.parametrize("n", [1, 2, 5, 4097, 100_003])
def test_cuda_kernel_bit_equal_plain(dev, protocol, n):
    for p in port_engine.stable_plans(protocol, np.arange(n), 0, 4,
                                      device=dev):
        fwd, link = planes(n, 6, n, dev)
        link[0, n // 2] = float("nan")
        fp = fwd_at_parent(p.parent, fwd, p.root)
        t0 = torch.arange(6, dtype=torch.float32, device=dev)
        kw = dict(root=p.root, height=p.height)
        before = tree_sweep_cuda.launches
        got = ops.tree_sweep(p.parent, p.depth, fp, link, t0,
                             levels=level_csr(p.parent, p.depth), **kw)
        torch.cuda.synchronize()
        assert tree_sweep_cuda.launches == before + 1
        assert_nan_equal(got, level_sweep(p.parent, p.depth, fp, link, t0,
                                          **kw))


def test_cuda_kernel_batch_dims_and_ring(dev):
    n = 3001
    ring = torch.randperm(n, generator=torch.Generator().manual_seed(3))
    p = port_engine.stable_plans("coloring", np.arange(n), int(ring[7]), 2,
                                 ring=ring, device=dev)[1]
    fwd, link = planes(n, 12, 1, dev)
    fp = fwd_at_parent(p.parent, fwd, p.root).view(3, 4, n)
    t0 = torch.arange(12, dtype=torch.float32, device=dev).view(3, 4)
    kw = dict(root=p.root, height=p.height)
    got = tree_sweep_cuda(p.parent, p.depth, fp, link.view(3, 4, n), t0,
                          levels=level_csr(p.parent, p.depth), **kw)
    assert_nan_equal(got, level_sweep(p.parent, p.depth, fp,
                                      link.view(3, 4, n), t0, **kw))


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(dev):
    p = port_engine.stable_plans("snow", np.arange(64), 0, 4, device=dev)[0]
    fwd, link = planes(64, 2, 0, dev)
    fp = fwd_at_parent(p.parent, fwd, p.root)
    t0 = torch.zeros(2, device=dev)
    kw = dict(root=p.root, height=p.height, levels=p.level_csr)
    with pytest.raises(TypeError):
        tree_sweep_cuda(p.parent, p.depth, fp.double(), link.double(),
                        t0.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tree_sweep_cuda(p.parent, p.depth, fp.t().contiguous().t(), link,
                        t0, **kw)
    with pytest.raises(ValueError, match="t0"):
        tree_sweep_cuda(p.parent, p.depth, fp, link, t0.cpu(), **kw)
    with pytest.raises(ValueError, match="t0"):
        tree_sweep_cuda(p.parent, p.depth, fp, link, t0[:1], **kw)


def test_stable_sweep_on_the_card_runs_through_the_kernel(dev):
    before = tree_sweep_cuda.launches
    rows = port_engine.stable_sweep("coloring", 20_000, 4, [0, 1], 4)
    assert tree_sweep_cuda.launches == before + 2
    assert all(r["reliability"] == 1.0 and r["rmr"] == 244.0 for r in rows)
    assert rows[0]["device_name"] == torch.cuda.get_device_name(dev)


# --- attention and recurrence kernels against their plain versions ------

DTYPES = [torch.float32, torch.bfloat16]


def tol(dtype, loose=False):
    """bf16 2e-2 (5e-2 for wkv6): the outputs are rounded to bf16 after
    float32 sums taken in another order; f32 1e-4 (2e-4 for wkv6): only
    the order of the sums differs."""
    if dtype == torch.bfloat16:
        t = 5e-2 if loose else 2e-2
    else:
        t = 2e-4 if loose else 1e-4
    return dict(rtol=t, atol=t)


def assert_close_smoke(got, want):
    """chip_smoke.py's bf16 limit: rtol 2e-2 and an atol of 2e-2 x the
    plain output's RMS.  A fixed atol of 2e-2 is about the size of an
    attention output that averages many rows, so it cannot see a row
    dropped or a zero row given weight."""
    want = want.float()
    atol = 2e-2 * float(want.square().mean().sqrt())
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=atol)


def randn(dev, dtype, *shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("b,h,hkv,s,hd", [
    (1, 4, 4, 128, 64),      # MHA
    (2, 8, 2, 200, 64),      # GQA 4:1, S not a multiple of any tile
    (1, 8, 1, 100, 128),     # MQA
    (1, 4, 1, 130, 256),     # recurrentgemma's head dim
    (2, 4, 2, 192, 32),
])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_kernel_matches_plain(dev, b, h, hkv, s, hd, dtype,
                                              window):
    q = randn(dev, dtype, b, h, s, hd, seed=1)
    k = randn(dev, dtype, b, hkv, s, hd, seed=2)
    v = randn(dev, dtype, b, hkv, s, hd, seed=3)
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype))


@pytest.mark.parametrize("window", [None, 50])
def test_flash_attention_kernel_not_causal(dev, window):
    q = randn(dev, torch.float32, 1, 4, 150, 64, seed=4)
    k = randn(dev, torch.float32, 1, 2, 150, 64, seed=5)
    v = randn(dev, torch.float32, 1, 2, 150, 64, seed=6)
    got = flash_attention_cuda(q, k, v, causal=False, window=window)
    want = ref.mha_reference(q, k, v, causal=False, window=window)
    torch.testing.assert_close(got, want, **tol(torch.float32))


@pytest.mark.parametrize("window", [None, 50])
def test_flash_attention_bf16_not_causal(dev, window):
    q = randn(dev, torch.bfloat16, 1, 4, 300, 64, seed=50)
    k = randn(dev, torch.bfloat16, 1, 2, 300, 64, seed=51)
    v = randn(dev, torch.bfloat16, 1, 2, 300, 64, seed=52)
    got = flash_attention_cuda(q, k, v, causal=False, window=window)
    want = ref.mha_reference(q, k, v, causal=False, window=window)
    assert_close_smoke(got, want)


@pytest.mark.parametrize("s", [1000, 1500, 2100])
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("window", [None, 100, 1])
def test_flash_attention_bf16_many_tiles(dev, s, hd, window):
    """Many KV tiles (64 keys, 32 at hd 256) and query tiles (128 rows)
    with ragged last tiles; a window of 100 starts mid-tile, a window of
    1 keeps only the diagonal."""
    q = randn(dev, torch.bfloat16, 1, 4, s, hd, seed=53)
    k = randn(dev, torch.bfloat16, 1, 2, s, hd, seed=54)
    v = randn(dev, torch.bfloat16, 1, 2, s, hd, seed=55)
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert_close_smoke(got, want)


def test_flash_attention_bf16_rows_with_few_keys(dev):
    """The smoke's bf16 tolerance (rtol 2e-2, atol 2e-2 x the plain
    output's RMS) over a long sequence, whose first rows see only a few
    keys: there a P rounded once to bf16 errs by up to 2^-9 |v|, far
    past the atol, so the kernel carries P as bf16 hi + lo."""
    q = randn(dev, torch.bfloat16, 1, 4, 4096, 128, seed=62)
    k = randn(dev, torch.bfloat16, 1, 2, 4096, 128, seed=63)
    v = randn(dev, torch.bfloat16, 1, 2, 4096, 128, seed=64)
    assert_close_smoke(flash_attention_cuda(q, k, v),
                       ref.mha_reference(q, k, v))


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_attention_bf16_groups(dev, g, hd):
    b, hkv, s = 2, 2, 300
    q = randn(dev, torch.bfloat16, b, hkv * g, hd, seed=56)
    kc = randn(dev, torch.bfloat16, b, s, hkv, hd, seed=57)
    vc = randn(dev, torch.bfloat16, b, s, hkv, hd, seed=58)
    n = torch.tensor(257, device=dev)
    got = decode_attention_cuda(q, kc, vc, n)
    assert_close_smoke(got, ref.decode_attention_reference(q, kc, vc, 257))


@pytest.mark.parametrize("length,window", [
    (1024, None),    # every split exactly 64 rows: lengths on boundaries
    (128, None),     # two splits of 64, the rest empty
    (1025, None),    # one row past a boundary
    (3000, None),    # past the cache's end: every row valid
    (2048, 50),      # the window inside one split
    (1000, 100),     # a window across a split boundary
    (0, None),       # no valid row: the output is 0
])
@pytest.mark.parametrize("on_device", [False, True])
def test_decode_attention_bf16_split_edges(dev, length, window, on_device):
    b, h, hkv, s, hd = 1, 16, 1, 2048, 256
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert split_count(b, hkv, h // hkv, s, sms) > 1
    q = randn(dev, torch.bfloat16, b, h, hd, seed=59)
    kc = randn(dev, torch.bfloat16, b, s, hkv, hd, seed=60)
    vc = randn(dev, torch.bfloat16, b, s, hkv, hd, seed=61)
    n = torch.tensor(length, device=dev) if on_device else length
    got = decode_attention_cuda(q, kc, vc, n, window=window)
    torch.cuda.synchronize()
    if length == 0:
        assert torch.equal(got, torch.zeros_like(got))
        return
    assert_close_smoke(got, ref.decode_attention_reference(
        q, kc, vc, length, window=window))
    assert_close_smoke(got, ref.decode_attention_split(
        q, kc, vc, length, window=window,
        nsplit=split_count(b, hkv, h // hkv, s, sms)))


@pytest.mark.parametrize("length,window", [
    (32001, None),   # one row in the last split
    (32255, None),   # the last split one row short of full
    (32001, 1000),   # a window whose last split is ragged
])
def test_decode_attention_bf16_ragged_last_split(dev, length, window):
    """qwen3-0.6b's decode widths (G = 2, hd 128, S = 32,768) at one
    batch row, with lengths that leave the last split of the valid range
    part-filled, where the smoke's length of 32,000 splits evenly."""
    b, h, hkv, s, hd = 1, 16, 8, 32768, 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = split_count(b, hkv, h // hkv, s, sms)
    n = length if window is None else window
    per_split = -(-n // nsplit)
    chunk = -(-per_split // SPLIT_ALIGN) * SPLIT_ALIGN
    assert n % chunk and n > chunk
    q = randn(dev, torch.bfloat16, b, h, hd, seed=65)
    kc = randn(dev, torch.bfloat16, b, s, hkv, hd, seed=66)
    vc = randn(dev, torch.bfloat16, b, s, hkv, hd, seed=67)
    got = decode_attention_cuda(q, kc, vc, torch.tensor(length, device=dev),
                                window=window)
    assert_close_smoke(got, ref.decode_attention_reference(
        q, kc, vc, length, window=window))


@pytest.mark.parametrize("b,h,hkv,s,hd,length", [
    (2, 8, 2, 512, 64, 300),
    (1, 4, 4, 256, 128, 256),
    (2, 8, 1, 384, 64, 77),
    (2, 16, 1, 200, 256, 200),   # recurrentgemma's MQA group of 16
    (1, 16, 8, 1000, 128, 999),  # qwen3's group of 2, ragged tiles
    (1, 4, 2, 100, 32, 1),
])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("on_device", [False, True])
def test_decode_attention_kernel_matches_plain(dev, b, h, hkv, s, hd, length,
                                               dtype, window, on_device):
    q = randn(dev, dtype, b, h, hd, seed=7)
    kc = randn(dev, dtype, b, s, hkv, hd, seed=8)
    vc = randn(dev, dtype, b, s, hkv, hd, seed=9)
    n = torch.tensor(length, device=dev) if on_device else length
    got = decode_attention_cuda(q, kc, vc, n, window=window)
    want = ref.decode_attention_reference(q, kc, vc, length, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype))


@pytest.mark.parametrize("b,t,w", [(2, 128, 128), (1, 100, 300),
                                   (3, 37, 4096), (1, 1, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_scan_kernel_matches_plain(dev, b, t, w, dtype):
    rng = np.random.default_rng(t)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, t, w)))) * 0.98 + 0.01
    a = torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
    bb = randn(dev, dtype, b, t, w, seed=10, scale=0.5)
    h0 = randn(dev, torch.float32, b, w, seed=11)
    h, hl = rglru_scan_cuda(a, bb, h0)
    gh, ghl = ref.rglru_scan_reference(a, bb, h0)
    torch.cuda.synchronize()
    assert h.dtype == dtype and hl.dtype == torch.float32
    torch.testing.assert_close(h.float(), gh.float(), **tol(dtype))
    torch.testing.assert_close(hl, ghl, **tol(dtype))


@pytest.mark.parametrize("b,t,h,hd", [(2, 128, 4, 16), (1, 64, 2, 64),
                                      (2, 97, 3, 32), (1, 40, 2, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_kernel_matches_plain(dev, b, t, h, hd, dtype):
    r, k, v = (randn(dev, dtype, b, t, h, hd, seed=12 + i) for i in range(3))
    logw = (-randn(dev, torch.float32, b, t, h, hd, seed=15).abs()
            * 0.5).to(dtype)
    u = randn(dev, dtype, h, hd, seed=16, scale=0.1)
    s0 = randn(dev, torch.float32, b, h, hd, hd, seed=17, scale=0.2)
    y, s = wkv6_cuda(r, k, v, logw, u, s0)
    gy, gs = ref.wkv6_reference(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), gy.float(), **tol(dtype, True))
    torch.testing.assert_close(s, gs, **tol(dtype, True))


def test_wkv6_kernel_long_decay_stays_finite(dev):
    r, k, v = (randn(dev, torch.float32, 1, 256, 1, 16, seed=20 + i)
               for i in range(3))
    logw = torch.full((1, 256, 1, 16), -3.0, device=dev)
    u = torch.zeros((1, 16), device=dev)
    s0 = torch.zeros((1, 1, 16, 16), device=dev)
    y, s = wkv6_cuda(r, k, v, logw, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    gy, gs = ref.wkv6_reference(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, gy, **tol(torch.float32, True))


def test_ops_on_cuda_tensors_launch_the_kernels(dev):
    q = randn(dev, torch.bfloat16, 1, 4, 64, 64, seed=30)
    kv = randn(dev, torch.bfloat16, 1, 2, 64, 64, seed=31)
    qd = randn(dev, torch.bfloat16, 1, 4, 64, seed=32)
    cache = randn(dev, torch.bfloat16, 1, 64, 2, 64, seed=33)
    a = torch.full((1, 8, 32), 0.5, device=dev)
    x = randn(dev, torch.float32, 1, 8, 2, 16, seed=34)
    calls = [
        (flash_attention_cuda, lambda: ops.flash_attention(q, kv, kv)),
        (decode_attention_cuda,
         lambda: ops.decode_attention(qd, cache, cache,
                                      torch.tensor(40, device=dev))),
        (rglru_scan_cuda,
         lambda: ops.rglru_scan(a, a, torch.zeros(1, 32, device=dev))),
        (wkv6_cuda,
         lambda: ops.wkv6(x, x, x, -x.abs(), x[0, 0],
                          torch.zeros(1, 2, 16, 16, device=dev))),
    ]
    for wrapper, call in calls:
        before = wrapper.launches
        call()
        assert wrapper.launches == before + 1, wrapper.__name__
        call()
        assert wrapper.launches == before + 2, wrapper.__name__
    torch.cuda.synchronize()


def test_attention_and_scan_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = randn(dev, torch.float32, 1, 4, 64, 48, seed=40)    # hd 48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q[:, :2].contiguous(), q[:, :2].contiguous())
    q = randn(dev, torch.float32, 1, 4, 64, 64, seed=41)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q, q[:, :3].contiguous(), q[:, :3].contiguous())
    qd = randn(dev, torch.float32, 2, 4, 64, seed=42)
    cache = randn(dev, torch.float32, 2, 32, 2, 64, seed=43)
    with pytest.raises(ValueError, match="length"):
        decode_attention_cuda(qd, cache, cache, torch.tensor([3], device=dev))
    with pytest.raises(ValueError, match="window"):
        decode_attention_cuda(qd, cache, cache, 3, window=0)
    a = torch.ones(2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="h0"):
        rglru_scan_cuda(a, a, torch.zeros(2, 15, device=dev))
    x = torch.ones(1, 8, 2, 16, device=dev)
    with pytest.raises(ValueError, match="s0"):
        wkv6_cuda(x, x, x, x, x[0, 0], torch.zeros(1, 2, 16, 15, device=dev))
