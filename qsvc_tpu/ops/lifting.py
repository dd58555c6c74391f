"""Integer lifting filter banks (Haar, 5/3, 13/7, S+P) — vectorized JAX.

These re-create, bit-exactly, the semantics of the reference's C++ header-only
filter banks (``trunk/src/Haar.cpp:39-89``, ``trunk/src/5_3.cpp:39-115``,
``trunk/src/13_7.cpp``, ``trunk/src/SP.cpp``): integer lifting on int16/short
values with **C truncating division** (round toward zero), separate even- and
odd-length boundary rules, and perfect reconstruction.

Instead of the reference's scalar per-sample loops, each lifting step is a
whole-axis vector operation: the signal is split into
even/odd phases, the predict/update steps are shifted adds, and truncating
division is ``lax.div`` (XLA signed integer division truncates toward zero,
matching C).  All functions operate on the **last axis** and broadcast over
any leading batch axes, so frames/rows/fields vectorize for free.

Lifting steps compute in the input's integer dtype; the reference's
``short`` arithmetic never overflows 16 bits for 8-bit texture / small MV
inputs, so values are identical in int16 or int32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def tdiv(x: jnp.ndarray, d: int) -> jnp.ndarray:
    """C-style truncating integer division (round toward zero)."""
    return lax.div(x, jnp.asarray(d, dtype=x.dtype))


def _ops(axis: int):
    """Axis-aware slice/concat helpers: the 5/3 and 9/7 banks run
    natively along the last OR the second-to-last axis, so the 2D transform
    needs no ``moveaxis`` relayout for column passes (axis=-2 simply
    appends a ``:`` to every index)."""
    if axis == -1:
        return (lambda x, s: x[..., s],
                lambda parts: jnp.concatenate(parts, axis=-1))
    assert axis == -2
    return (lambda x, s: x[..., s, :],
            lambda parts: jnp.concatenate(parts, axis=-2))


def _split_phases(s: jnp.ndarray, axis: int = -1
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    sl, _ = _ops(axis)
    return sl(s, slice(0, None, 2)), sl(s, slice(1, None, 2))


def _interleave(even: jnp.ndarray, odd: jnp.ndarray, n: int,
                axis: int = -1) -> jnp.ndarray:
    """Inverse of _split_phases for a length-n signal."""
    if axis == -1:
        batch = even.shape[:-1]
        out = jnp.zeros(batch + (n,), dtype=even.dtype)
        out = out.at[..., 0::2].set(even)
        out = out.at[..., 1::2].set(odd)
        return out
    assert axis == -2
    shape = even.shape[:-2] + (n,) + even.shape[-1:]
    out = jnp.zeros(shape, dtype=even.dtype)
    out = out.at[..., 0::2, :].set(even)
    out = out.at[..., 1::2, :].set(odd)
    return out


# ---------------------------------------------------------------------------
# 5/3 filter bank (reference 5_3.cpp:39-115 semantics)
# ---------------------------------------------------------------------------

def fwd53(s: jnp.ndarray, axis: int = -1
          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward 5/3 lifting along ``axis`` (last or second-to-last).

    Returns ``(low, high)`` with ``len(low) == ceil(n/2)`` and
    ``len(high) == floor(n/2)``.  Matches ``5_3.cpp`` even_analyze /
    odd_analyze including the boundary rules:

    * even n: ``h[m-1] = s[n-1] - s[n-2]`` (fold: right neighbour replicated)
    * odd  n: extra low sample ``l[m] = s[n-1] + h[m-1]/2``
    * ``l[0] = s[0] + h[0]/2`` (left fold)
    """
    sl, cat = _ops(axis)
    n = s.shape[axis]
    if n == 1:
        return s, sl(s, slice(0, 0))
    se, so = _split_phases(s, axis)      # even phase: ceil(n/2), odd: floor
    if n % 2 == 0:
        # right neighbour of the last odd sample folds onto s[n-2]:
        # tdiv(2*x, 2) == x exactly, so a replicated edge gives h=s[n-1]-s[n-2].
        se_next = cat([sl(se, slice(1, None)), sl(se, slice(-1, None))])
        h = so - tdiv(se + se_next, 2)
        h_left = cat([sl(h, slice(0, 1)), sl(h, slice(None, -1))])
        l = se + tdiv(h + h_left, 4)     # l[0]: tdiv(2*h0,4) == tdiv(h0,2)
    else:
        h = so - tdiv(sl(se, slice(None, -1)) + sl(se, slice(1, None)), 2)
        h_left = cat([sl(h, slice(0, 1)), h])
        h_right = cat([h, sl(h, slice(-1, None))])
        l = se + tdiv(h_right + h_left, 4)
    return l, h


def inv53(l: jnp.ndarray, h: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Inverse 5/3 lifting; exact inverse of :func:`fwd53`."""
    sl, cat = _ops(axis)
    m = h.shape[axis]
    n = l.shape[axis] + m
    if m == 0:
        return l
    if n % 2 == 0:
        h_left = cat([sl(h, slice(0, 1)), sl(h, slice(None, -1))])
        se = l - tdiv(h + h_left, 4)
        se_next = cat([sl(se, slice(1, None)), sl(se, slice(-1, None))])
        so = h + tdiv(se + se_next, 2)
    else:
        h_left = cat([sl(h, slice(0, 1)), h])
        h_right = cat([h, sl(h, slice(-1, None))])
        se = l - tdiv(h_right + h_left, 4)
        so = h + tdiv(sl(se, slice(None, -1)) + sl(se, slice(1, None)), 2)
    return _interleave(se, so, n, axis)


# ---------------------------------------------------------------------------
# Haar (2/1) filter bank (reference Haar.cpp:39-89 semantics)
# ---------------------------------------------------------------------------

def fwd_haar(s: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward Haar lifting: ``h = s_odd - s_even; l = s_even + h/2``.

    Odd n: trailing sample passes through to the low band.
    """
    n = s.shape[-1]
    if n == 1:
        return s, s[..., :0]
    se, so = _split_phases(s)
    if n % 2 == 0:
        h = so - se
        l = se + tdiv(h, 2)
    else:
        h = so - se[..., :-1]
        l = jnp.concatenate([se[..., :-1] + tdiv(h, 2), se[..., -1:]], axis=-1)
    return l, h


def inv_haar(l: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    m = h.shape[-1]
    n = l.shape[-1] + m
    if m == 0:
        return l
    if n % 2 == 0:
        se = l - tdiv(h, 2)
        so = se + h
    else:
        se_head = l[..., :-1] - tdiv(h, 2)
        so = se_head + h
        se = jnp.concatenate([se_head, l[..., -1:]], axis=-1)
    return _interleave(se, so, n)


# ---------------------------------------------------------------------------
# 13/7 filter bank (reference 13_7.cpp:39-183 — cubic integer lifting with
# arithmetic-shift (floor) division and short-filter boundary fallbacks)
# ---------------------------------------------------------------------------
#
# The reference's boundary unrolling reads out of bounds for n == 3 and the
# filter is compiled-in but disabled upstream (commented include,
# split.cpp:15); we keep the reference formulas for all in-bounds cases and
# clamp the out-of-range high-band neighbour indices at n == 3.

def _edge(x: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    """Replicate-pad the last axis by (left, right)."""
    parts = []
    if left:
        parts.append(jnp.repeat(x[..., :1], left, axis=-1))
    parts.append(x)
    if right:
        parts.append(jnp.repeat(x[..., -1:], right, axis=-1))
    return jnp.concatenate(parts, axis=-1)


def _iota_last(m: int, batch: Tuple[int, ...], dtype=jnp.int32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.arange(m, dtype=dtype), batch + (m,))


def _h137(se: jnp.ndarray, so: jnp.ndarray, even: bool) -> jnp.ndarray:
    """13/7 high-band predict step; ``se`` has one extra sample when odd."""
    m = so.shape[-1]
    batch = so.shape[:-1]
    e = _edge(se, 1, 2 if even else 1)
    ei_1, ei, ei1, ei2 = (e[..., k:k + m] for k in range(4))
    hA = so - ((9 * (ei + ei1) - (ei_1 + ei2) + 8) >> 4)   # interior cubic
    hB = so - ((ei + ei1 + 1) >> 1)                        # rounded average
    hC = so - ei                                           # Haar-like edge
    i = _iota_last(m, batch)
    if even:
        # last writer wins: h[m-1]=hC, h[m-2]=hB, h[0]=hC, interior hA
        return jnp.where(i == m - 1, hC,
               jnp.where(i == m - 2, hB,
               jnp.where(i == 0, hC, hA)))
    else:
        return jnp.where((i == 0) | (i == m - 1), hB, hA)


def _l137(se: jnp.ndarray, h: jnp.ndarray, even: bool) -> jnp.ndarray:
    nl = se.shape[-1]
    m = h.shape[-1]
    batch = se.shape[:-1]
    hh = _edge(h, 2, max(0, nl + 2 - m))
    hi_2, hi_1, hi, hi1 = (hh[..., k:k + nl] for k in range(4))
    lA = se + ((-hi_2 + 9 * (hi_1 + hi) - hi1 + 16) >> 5)  # interior cubic
    lB = se + ((hi_1 + hi + 1) >> 2)                       # 5/3-like edge
    lC = se + (hi >> 1)                                    # first sample
    lD = se + (hi_1 >> 1)                                  # trailing odd sample
    i = _iota_last(nl, batch)
    if even:
        return jnp.where(i == nl - 1, lB,
               jnp.where(i == 1, lB,
               jnp.where(i == 0, lC, lA)))
    else:
        # low band has m+1 samples; reference write order: l[0],l[1],
        # l[2..m-2], l[m-1], l[m] — last writer wins.
        return jnp.where(i == nl - 1, lD,
               jnp.where(i == nl - 2, lB,
               jnp.where(i == 1, lB,
               jnp.where(i == 0, lC, lA))))


def fwd137(s: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward 13/7 cubic lifting along the last axis (13_7.cpp:39-103)."""
    n = s.shape[-1]
    if n == 1:
        return s, s[..., :0]
    se, so = _split_phases(s)
    if n == 2:
        h = so - se
        l = se + (h >> 1)
        return l, h
    even = n % 2 == 0
    h = _h137(se, so, even)
    l = _l137(se, h, even)
    return l, h


def inv137(l: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    m = h.shape[-1]
    n = l.shape[-1] + m
    if m == 0:
        return l
    if n == 2:
        se = l - (h >> 1)
        return _interleave(se, se + h, n)
    even = n % 2 == 0
    # invert the update step: se = l - (same update computed from h)
    zeros = jnp.zeros_like(l)
    upd = _l137(zeros, h, even)
    se = l - upd
    # invert the predict step: so = h + (same predict computed from se)
    zh = jnp.zeros_like(h)
    pred = -( _h137(se, zh, even) )  # _h137 with so=0 returns -prediction
    so = h + pred
    return _interleave(se, so, n)


# ---------------------------------------------------------------------------
# S+P filter bank (reference SP.cpp:39-133).  The reference's even_analyze
# never initializes the high band before updating it (disabled code upstream);
# we use the odd path's ``h = s_even - s_odd`` initialization for both
# parities, which is the standard S+P transform and perfectly reconstructing.
# ---------------------------------------------------------------------------

def fwd_sp(s: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    n = s.shape[-1]
    if n == 1:
        return s, s[..., :0]
    se, so = _split_phases(s)
    if n % 2 == 0:
        l = (se + so) >> 1
        h = se - so
        ltrail = l
    else:
        l_pairs = (se[..., :-1] + so) >> 1
        h = se[..., :-1] - so
        l = jnp.concatenate([l_pairs, se[..., -1:]], axis=-1)
        ltrail = l
    m = h.shape[-1]
    if m >= 2:
        batch = h.shape[:-1]
        # d[i] = l[i] - l[i+1] for i in [0, m-1]; edge-clamped beyond.
        d = ltrail[..., :m] - ltrail[..., 1:m + 1] if ltrail.shape[-1] > m \
            else jnp.concatenate(
                [ltrail[..., :m - 1] - ltrail[..., 1:m], ltrail[..., :0]], axis=-1)
        # build d1 (=d[i-1]) and d2 (=d[i]) with the boundary rules of SP.cpp:
        #   h[0]   -= d[0] >> 2
        #   h[i]   -= ((d[i-1] + d[i] - h_raw[i+1]) * 2 + d[i] + 3) >> 3
        #   h[m-1] -= d[m-2] >> 2
        nd = d.shape[-1]
        dpad = _edge(d, 1, max(0, m - nd))        # dpad[..., i] == d[i-1]
        d1 = dpad[..., :m]
        d2 = dpad[..., 1:m + 1] if dpad.shape[-1] >= m + 1 else _edge(d, 0, 1)[..., :m]
        h_next = jnp.concatenate([h[..., 1:], h[..., -1:]], axis=-1)
        interior = (((d1 + d2 - h_next) << 1) + d2 + 3) >> 3
        first = d2 >> 2          # uses d[0] at i=0
        last = d1 >> 2           # uses d[m-2] at i=m-1
        i = _iota_last(m, h.shape[:-1])
        upd = jnp.where(i == 0, first, jnp.where(i == m - 1, last, interior))
        h = h - upd
    return l, h


def inv_sp(l: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    m = h.shape[-1]
    n = l.shape[-1] + m
    if m == 0:
        return l
    if m >= 2:
        # Restore raw h by a backward scan: h_raw[i] depends on h_raw[i+1].
        d = l[..., :m] - l[..., 1:m + 1] if l.shape[-1] > m else \
            jnp.concatenate([l[..., :m - 1] - l[..., 1:m]], axis=-1)
        dpad = _edge(d, 1, max(0, m - d.shape[-1]))
        d1 = dpad[..., :m]
        d2 = dpad[..., 1:m + 1] if dpad.shape[-1] >= m + 1 else _edge(d, 0, 1)[..., :m]

        def step(h_next_raw, xs):
            hv, d1v, d2v, iv = xs
            interior = (((d1v + d2v - h_next_raw) << 1) + d2v + 3) >> 3
            first = d2v >> 2
            last = d1v >> 2
            upd = jnp.where(iv == 0, first, jnp.where(iv == m - 1, last, interior))
            h_raw = hv + upd
            return h_raw, h_raw

        idx = jnp.arange(m, dtype=jnp.int32)
        xs = (jnp.moveaxis(h, -1, 0)[::-1],
              jnp.moveaxis(d1, -1, 0)[::-1],
              jnp.moveaxis(d2, -1, 0)[::-1],
              idx[::-1])
        init = jnp.zeros(h.shape[:-1], dtype=h.dtype)
        _, hs = lax.scan(step, init, xs)
        h = jnp.moveaxis(hs[::-1], 0, -1)
    # undo the pair transform: se = l + ((h+1)>>1); so = se - h
    if n % 2 == 0:
        se = l + ((h + 1) >> 1)
        so = se - h
        return _interleave(se, so, n)
    else:
        se_head = l[..., :-1] + ((h + 1) >> 1)
        so = se_head - h
        se = jnp.concatenate([se_head, l[..., -1:]], axis=-1)
        return _interleave(se, so, n)


# ---------------------------------------------------------------------------
# 9/7 irreversible (float) filter bank — CDF 9/7 lifting with symmetric
# (whole-sample) extension.  This is the texture-coding lossy transform the
# reference gets from Kakadu's ``Creversible=no`` path
# (texture_compress_fb_j2k.py:186); constants are the public CDF 9/7 lifting
# coefficients.
# ---------------------------------------------------------------------------

A97 = -1.586134342059924
B97 = -0.052980118572961
G97 = 0.882911075530934
D97 = 0.443506852043971
K97 = 1.230174104914001


def _lift_odd(se, so, coef, n_even_extra, axis=-1):
    """so += coef * (se_i + se_{i+1}) with symmetric edge clamping."""
    sl, cat = _ops(axis)
    if n_even_extra:                      # odd n: se has one extra sample
        left = sl(se, slice(None, -1))
        right = sl(se, slice(1, None))
    else:                                 # even n: clamp right edge
        left = se
        right = cat([sl(se, slice(1, None)), sl(se, slice(-1, None))])
    return so + coef * (left + right)


def _lift_even(se, so, coef, axis=-1):
    """se += coef * (so_{i-1} + so_i) with symmetric edge clamping (works
    for both parities: trailing even sample clamps to so[-1])."""
    sl, cat = _ops(axis)
    nl = se.shape[axis]
    so_left = sl(cat([sl(so, slice(0, 1)), so]), slice(None, nl))
    so_right = sl(cat([so, sl(so, slice(-1, None))]), slice(None, nl))
    return se + coef * (so_left + so_right)


def fwd97(s: jnp.ndarray, axis: int = -1
          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward CDF 9/7 lifting (float32/float64) along ``axis``."""
    sl, _ = _ops(axis)
    n = s.shape[axis]
    if n == 1:
        return s, sl(s, slice(0, 0))
    se, so = _split_phases(s, axis)
    odd_n = n % 2 == 1
    so = _lift_odd(se, so, A97, odd_n, axis)
    se = _lift_even(se, so, B97, axis)
    so = _lift_odd(se, so, G97, odd_n, axis)
    se = _lift_even(se, so, D97, axis)
    return se * (1.0 / K97), so * K97


def inv97(l: jnp.ndarray, h: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    m = h.shape[axis]
    n = l.shape[axis] + m
    if m == 0:
        return l
    se = l * K97
    so = h * (1.0 / K97)
    odd_n = n % 2 == 1
    se = _lift_even(se, so, -D97, axis)
    so = _lift_odd(se, so, -G97, odd_n, axis)
    se = _lift_even(se, so, -B97, axis)
    so = _lift_odd(se, so, -A97, odd_n, axis)
    return _interleave(se, so, n, axis)


FILTERS = {
    "5/3": (fwd53, inv53),
    "haar": (fwd_haar, inv_haar),
    "13/7": (fwd137, inv137),
    "sp": (fwd_sp, inv_sp),
    "9/7": (fwd97, inv97),
}


AXIS_AWARE = {"5/3", "9/7"}     # run natively along axis -1 or -2


def fwd(name: str, s: jnp.ndarray, axis: int = -1):
    if axis == -1:
        return FILTERS[name][0](s)
    return FILTERS[name][0](s, axis=axis)


def inv(name: str, l: jnp.ndarray, h: jnp.ndarray, axis: int = -1):
    if axis == -1:
        return FILTERS[name][1](l, h)
    return FILTERS[name][1](l, h, axis=axis)
