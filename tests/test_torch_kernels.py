"""The port's attention and recurrence ops on CPU tensors (their plain
versions) against the JAX package's Pallas kernels in interpret mode and
its ``kernels/ref.py`` oracles, on the shapes, dtypes, windows and
tolerances of ``tests/test_kernels.py``.  Inputs are made with numpy and
handed to both packages; bf16 inputs are rounded once, in float32, the
same way by both.

Interpret mode is slow, so each case runs it where it adds coverage the
oracle does not: every bf16 case and the first shape of each op in
float32; every case is held against the oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype, wkv=False):
    if dtype == "bfloat16":
        t = 5e-2 if wkv else 2e-2
    else:
        t = 2e-4 if wkv else 1e-4
    return dict(rtol=t, atol=t)


def both(x, dtype):
    """numpy float32 → (jax array, torch tensor) of one dtype."""
    jd, td = DTYPES[dtype]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def check(port, golds, **kw):
    for gold in golds:
        np.testing.assert_allclose(f32(port), f32(gold), **kw)


FLASH = [(1, 4, 4, 128, 64),      # MHA
         (2, 8, 2, 256, 64),      # GQA 4:1
         (1, 8, 1, 256, 128),     # MQA
         (2, 4, 2, 192, 32)]      # s not a multiple of the block


@pytest.mark.parametrize("shape", FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_matches_jax(shape, dtype, window):
    b, h, hkv, s, hd = shape
    rng = np.random.default_rng(7)
    (jq, q), (jk, k), (jv, v) = (
        both(rng.standard_normal(sh), dtype)
        for sh in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == q.shape
    golds = [jref.mha_reference(jq, jk, jv, causal=True, window=window)]
    if dtype == "bfloat16" or shape == FLASH[0]:
        golds.append(jops.flash_attention(jq, jk, jv, causal=True,
                                          window=window,
                                          impl="pallas_interpret"))
    check(out, golds, **tol(dtype))


DECODE = [(2, 8, 2, 512, 64, 300),
          (1, 4, 4, 256, 128, 256),
          (2, 8, 1, 384, 64, 77)]


@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 128])
def test_decode_attention_matches_jax(shape, dtype, window):
    b, h, hkv, s, hd, length = shape
    rng = np.random.default_rng(8)
    (jq, q), (jk, kc), (jv, vc) = (
        both(rng.standard_normal(sh), dtype)
        for sh in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    out = ops.decode_attention(q, kc, vc, torch.tensor(length),
                               window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == q.shape
    # a Python int and a 0-d tensor are the same length
    assert torch.equal(out, ops.decode_attention(q, kc, vc, length,
                                                 window=window))
    golds = [jref.decode_attention_reference(jq, jk, jv, jnp.int32(length),
                                             window=window)]
    if dtype == "bfloat16" or shape == DECODE[0]:
        golds.append(jops.decode_attention(jq, jk, jv, jnp.int32(length),
                                           window=window,
                                           impl="pallas_interpret"))
    check(out, golds, **tol(dtype))


def wkv_inputs(b, t, h, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd)) for _ in range(3))
    logw = -np.abs(rng.standard_normal((b, t, h, hd))) * 0.5
    u = rng.standard_normal((h, hd)) * 0.1
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.2
    pairs = [both(x, dtype) for x in (r, k, v, logw, u)]
    pairs.append(both(s0, "float32"))
    return [p[0] for p in pairs], [p[1] for p in pairs]


WKV = [(2, 128, 4, 16, 32), (1, 64, 2, 64, 64), (2, 96, 3, 32, 32)]


@pytest.mark.parametrize("shape", WKV)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_matches_jax(shape, dtype):
    b, t, h, hd, chunk = shape
    jx, tx = wkv_inputs(b, t, h, hd, dtype, 9)
    y, s = ops.wkv6(*tx, chunk=chunk)
    assert y.dtype == DTYPES[dtype][1] and s.dtype == torch.float32
    golds = [jref.wkv6_reference(*jx)]
    if dtype == "bfloat16" or shape == WKV[0]:
        golds.append(jops.wkv6(*jx, chunk=chunk, impl="pallas_interpret"))
    for gy, gs in golds:
        np.testing.assert_allclose(f32(y), f32(gy), **tol(dtype, wkv=True))
        np.testing.assert_allclose(f32(s), f32(gs), **tol(dtype, wkv=True))


RGLRU = [(2, 128, 128, 32), (1, 256, 512, 64), (3, 64, 256, 64)]


@pytest.mark.parametrize("shape", RGLRU)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_matches_jax(shape, dtype):
    b, t, w, chunk = shape
    rng = np.random.default_rng(10)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, t, w)))) * 0.98 + 0.01
    (ja, ta), (jb, tb) = both(a, dtype), both(
        rng.standard_normal((b, t, w)) * 0.5, dtype)
    jh0, th0 = both(rng.standard_normal((b, w)), "float32")
    h, hl = ops.rglru_scan(ta, tb, th0, chunk=chunk)
    assert h.dtype == DTYPES[dtype][1] and hl.dtype == torch.float32
    golds = [jref.rglru_scan_reference(ja, jb, jh0)]
    if dtype == "bfloat16" or shape == RGLRU[0]:
        golds.append(jops.rglru_scan(ja, jb, jh0, chunk=chunk,
                                     impl="pallas_interpret"))
    for gh, ghl in golds:
        np.testing.assert_allclose(f32(h), f32(gh), **tol(dtype))
        np.testing.assert_allclose(f32(hl), f32(ghl), **tol(dtype))


def test_wkv6_long_decay_stability():
    """The twin of the reference's test: strong decay over a long run
    stays finite, and agrees with the Pallas kernel."""
    b, t, h, hd = 1, 256, 1, 16
    rng = np.random.default_rng(11)
    r, k, v = (rng.standard_normal((b, t, h, hd)) for _ in range(3))
    args = [r, k, v, np.full((b, t, h, hd), -3.0), np.zeros((h, hd)),
            np.zeros((b, h, hd, hd))]
    jx = [jnp.asarray(x, jnp.float32) for x in args]
    tx = [torch.from_numpy(np.asarray(x, np.float32)) for x in args]
    y, s = ops.wkv6(*tx, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    gy, gs = jops.wkv6(*jx, chunk=64, impl="pallas_interpret")
    np.testing.assert_allclose(f32(y), f32(gy), **tol("float32", wkv=True))
    np.testing.assert_allclose(f32(s), f32(gs), **tol("float32", wkv=True))


def test_plain_attention_goes_through_pieces():
    """Full-width shapes run the attention twins in pieces of at most
    ``PIECE_ELEMS`` scores; the pieces change no result."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((1, 4, 96, 32)).astype("f4"))
    kv = torch.from_numpy(rng.standard_normal((1, 2, 96, 32)).astype("f4"))
    qd = torch.from_numpy(rng.standard_normal((5, 4, 32)).astype("f4"))
    cache = torch.from_numpy(rng.standard_normal((5, 96, 2, 32)).astype("f4"))
    whole_f = ref.mha_reference(q, kv, kv, window=40)
    whole_d = ref.decode_attention_reference(qd, cache, cache, 90, window=50)
    old = ref.PIECE_ELEMS
    try:
        ref.PIECE_ELEMS = 4 * 96 * 10      # 10 query rows, 1 batch row
        torch.testing.assert_close(ref.mha_reference(q, kv, kv, window=40),
                                   whole_f, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            ref.decode_attention_reference(qd, cache, cache, 90, window=50),
            whole_d, rtol=1e-6, atol=1e-6)
    finally:
        ref.PIECE_ELEMS = old


def test_impl_cuda_raises_on_cpu_tensors():
    x = torch.zeros(1, 2, 8, 32)
    cache = torch.zeros(1, 8, 2, 32)
    a = torch.zeros(1, 8, 16)
    r = torch.zeros(1, 8, 2, 16)
    calls = [
        lambda impl: ops.flash_attention(x, x, x, impl=impl),
        lambda impl: ops.decode_attention(x[:, :, 0], cache, cache, 4,
                                          impl=impl),
        lambda impl: ops.rglru_scan(a, a, a[:, 0], impl=impl),
        lambda impl: ops.wkv6(r, r, r, r, r[0, 0],
                              torch.zeros(1, 2, 16, 16), impl=impl),
    ]
    for call in calls:
        call("auto")
        with pytest.raises(ValueError, match="CUDA tensors"):
            call("cuda")
        with pytest.raises(ValueError, match="impl"):
            call("pallas_interpret")


def test_every_kernel_library_has_its_source():
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    assert sorted(_build.KERNELS) == sources
    for name in _build.KERNELS:
        assert _build.library_path(name).name.startswith(f"lib{name}-")


SPLITS = [(2, 8, 2, 512, 64, 300, None),
          (1, 16, 1, 384, 128, 384, 100),     # a window inside one split
          (2, 4, 4, 256, 32, 200, None),
          (1, 4, 2, 128, 32, 64, None),       # a length on a split's edge
          (1, 4, 2, 128, 32, 200, None)]      # a length past the cache


@pytest.mark.parametrize("shape", SPLITS)
@pytest.mark.parametrize("nsplit", [1, 2, 3, 8])
def test_decode_split_combine_matches_oracles(shape, nsplit):
    """The bf16 decode kernel's arithmetic (partials per split of the
    valid range, merged by log-sum-exp) equals the one-pass oracles in
    float32; 8 splits of these lengths leave some splits empty, and a
    length past the cache's end makes every row valid."""
    b, h, hkv, s, hd, length, window = shape
    rng = np.random.default_rng(13)
    (jq, q), (jk, kc), (jv, vc) = (
        both(rng.standard_normal(sh), "float32")
        for sh in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    out = ref.decode_attention_split(q, kc, vc, length, nsplit=nsplit,
                                     window=window)
    assert out.dtype == torch.float32 and out.shape == q.shape
    golds = [ref.decode_attention_reference(q, kc, vc, length,
                                            window=window),
             jref.decode_attention_reference(jq, jk, jv, jnp.int32(length),
                                             window=window)]
    check(out, golds, **tol("float32"))


def test_decode_split_with_no_valid_row_gives_zero_like_pallas():
    """length = 0: every split is empty and the output is 0, as the
    Pallas kernel's clamped l gives (the oracle's softmax over NEG_INF
    logits would average the cache instead)."""
    rng = np.random.default_rng(15)
    shapes = ((1, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))
    (jq, q), (jk, kc), (jv, vc) = (both(rng.standard_normal(sh), "float32")
                                   for sh in shapes)
    out = ref.decode_attention_split(q, kc, vc, 0, nsplit=3)
    assert torch.equal(out, torch.zeros_like(q))
    gold = jops.decode_attention(jq, jk, jv, jnp.int32(0),
                                 impl="pallas_interpret")
    check(out, [gold], **tol("float32"))


@pytest.mark.parametrize("b,hkv,g,s,want", [
    (128, 8, 2, 32768, 2),      # qwen3-0.6b decode_32k: 2,048 blocks
    (128, 1, 16, 2048, 8),      # recurrentgemma-9b ring cache: 1,024
    (1, 1, 2, 100, 1),          # shorter than two tiles: no split
    (1, 1, 16, 2048, 16),       # one row: as many splits as 128-row parts
    (2, 2, 64, 300, 3),         # 64 heads: 4 blocks of 16 per KV head
])
def test_decode_split_count(b, hkv, g, s, want):
    """The bf16 decode wrapper's split count: enough blocks to cover the
    132 SMs eight times, splits of at least two 64-row parts, trimmed to
    the aligned splits of S that hold rows: at length S the kernel's
    splits (ceil(S / n) rounded up to SPLIT_ALIGN rows) are all
    non-empty."""
    from repro_torch.kernels.decode_attention import SPLIT_ALIGN, split_count

    n = split_count(b, hkv, g, s, 132)
    assert n == want
    per_split = -(-s // n)
    chunk = -(-per_split // SPLIT_ALIGN) * SPLIT_ALIGN
    assert (n - 1) * chunk < s <= n * chunk
