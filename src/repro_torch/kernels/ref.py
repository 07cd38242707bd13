"""Plain PyTorch twins of the JAX package's kernel oracles
(``repro.kernels.ref``): the plain versions of the four attention and
recurrence kernels, which the CPU tests hold against the JAX package and
``chip_smoke.py`` holds the CUDA kernels against on the card.

Signatures, layouts and ``NEG_INF`` are the oracles'.  Each twin upcasts
to float32 inside and casts its outputs as the oracle does: ``h`` and
``y`` in the input dtype, ``h_last`` and ``s_final`` in float32.  Two
departures, neither of which changes a result:

* the attention twins go through the query rows (``mha_reference``) or
  the batch (``decode_attention_reference``) in pieces of at most
  ``PIECE_ELEMS`` float32 scores, so that full-width shapes fit on one
  card (S = 32,768 would otherwise build 68 GB of scores);
* torch has no ``associative_scan``, so ``rglru_scan_reference`` runs the
  recurrence as a loop over T, like ``wkv6_reference``.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from .decode_attention import SPLIT_ALIGN

NEG_INF = -1e30
#: most float32 attention scores one piece of a twin materialises (1 GiB)
PIECE_ELEMS = 1 << 28


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, hd); k/v: (B, Hkv, S, hd) → (B, H, S, hd).  Query head
    ``h`` reads KV head ``h // (H // Hkv)``."""
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, hkv, group, s, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, group, s, hd), dtype=torch.float32,
                      device=q.device)
    ki = torch.arange(s, device=q.device)[None, :]
    rows = max(1, min(s, PIECE_ELEMS // max(1, b * h * s)))
    for q0 in range(0, s, rows):
        q1 = min(s, q0 + rows)
        logits = torch.einsum("bgrqd,bgkd->bgrqk", qf[:, :, :, q0:q1],
                              kf) * scale
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        mask = ki <= qi if causal else torch.ones_like(ki <= qi)
        if window is not None:
            mask = mask & (ki > qi - window)
        logits = torch.where(mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out[:, :, :, q0:q1] = torch.einsum("bgrqk,bgkd->bgrqd", p, vf)
        del logits, p
    return out.reshape(b, h, s, hd).to(q.dtype)


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               length: Union[int, torch.Tensor],
                               window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, S, Hkv, hd) → (B, H, hd).  Position
    ``pos`` is valid where ``pos < length`` (and ``pos >= length -
    window`` with a window); ``length`` is an int or a 0-d tensor."""
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    valid = pos < length
    if window is not None:
        valid = valid & (pos >= length - window)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    # the float32 copies of the caches dominate a piece's memory
    piece = max(1, min(b, PIECE_ELEMS // max(1, s * hkv * hd)))
    for b0 in range(0, b, piece):
        b1 = min(b, b0 + piece)
        qg = q[b0:b1].float().reshape(b1 - b0, hkv, group, hd)
        logits = torch.einsum("bgrd,bsgd->bgrs", qg,
                              k_cache[b0:b1].float()) * scale
        logits = torch.where(valid, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bgrs,bsgd->bgrd", p, v_cache[b0:b1].float())
        out[b0:b1] = o.reshape(b1 - b0, h, hd)
        del logits, p, o
    return out.to(q.dtype)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           length: Union[int, torch.Tensor], *,
                           nsplit: int, window: Optional[int] = None,
                           align: int = SPLIT_ALIGN) -> torch.Tensor:
    """The split-and-combine arithmetic of the bf16 decode kernel
    (flash-decoding), in plain float32: the valid range [lo, hi) is cut
    into ``nsplit`` parts, each a multiple of ``align`` rows (the
    kernel's cut, from its wrapper's constant), each part gives a partial
    (m, l, acc) over its rows, and the partials are merged by the
    log-sum-exp rule.  An empty part gives m = NEG_INF, l = 0, acc = 0;
    with no valid row at all the output is 0 (l is clamped at 1e-30, as
    the Pallas kernel clamps it), where the oracle's softmax over
    NEG_INF logits would average every row."""
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(hd)
    length = int(length)
    hi = min(length, s)
    lo = 0 if window is None else max(0, length - window)
    n = max(0, hi - lo)
    per_split = -(-n // nsplit)
    chunk = -(-per_split // align) * align
    qg = q.float().reshape(b, hkv, group, hd)
    ms, ls, accs = [], [], []
    for j in range(nsplit):
        start = lo + j * chunk
        end = min(hi, start + chunk)
        if end <= start:
            ms.append(torch.full((b, hkv, group), NEG_INF, device=q.device))
            ls.append(torch.zeros((b, hkv, group), device=q.device))
            accs.append(torch.zeros((b, hkv, group, hd), device=q.device))
            continue
        logits = torch.einsum("bgrd,bsgd->bgrs", qg,
                              k_cache[:, start:end].float()) * scale
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bgrs,bsgd->bgrd", p,
                                 v_cache[:, start:end].float()))
    m_all = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - m_all) for m in ms]
    l_all = sum(l * wj for l, wj in zip(ls, w))
    acc = sum(a * wj[..., None] for a, wj in zip(accs, w))
    out = acc / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def wkv6_reference(r, k, v, logw, u, s0):
    """Step-by-step WKV-6 recurrence (the gold oracle).
    r/k/v/logw: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) fp32,
    indexed ``[key, value]``.  Returns ``(y (B, T, H, hd) in r's dtype,
    s_final (B, H, hd, hd) float32)``."""
    rf, kf, vf = (x.float() for x in (r, k, v))
    w = torch.exp(logw.float())
    uf = u.float()[None]
    s = s0.float().clone()
    y = torch.empty(rf.shape, dtype=torch.float32, device=r.device)
    for t in range(r.shape[1]):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]             # (B, H, hd)
        y[:, t] = (torch.einsum("bhk,bhkv->bhv", rt, s)
                   + torch.sum(rt * uf * kt, -1)[..., None] * vt)
        s = w[:, t][..., None] * s + kt[..., None] * vt[:, :, None, :]
    return y.to(r.dtype), s


def rglru_scan_reference(a, b, h0):
    """h_t = a_t h_{t-1} + b_t, a loop over T with a float32 carry.
    a/b: (B, T, W); h0: (B, W) → (h (B, T, W) in a's dtype, h_last
    (B, W) float32)."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype), h
