"""Multi-level separable 2D DWT with the reference's in-place "packed" layout.

Re-creates ``trunk/src/dwt2d.cpp:76-175`` semantics: at each level the active
top-left sub-array of the image is transformed rows-then-columns, the low
half of each 1D transform landing in the first ``ceil(n/2)`` samples and the
high half in the remaining ``floor(n/2)``.  After L levels the top-left
``ceil(H/2^L) x ceil(W/2^L)`` corner holds the LL band, with LH/HL/HH bands
packed around it — exactly the layout the reference's hierarchical motion
estimation and interpolation code indexes into.

Every lifting step is a whole-axis vectorized op (see
``lifting.py``); batch axes broadcast, so a (frames, H, W) stack transforms
in one fused XLA computation — no per-line loops, no host round trips.

Size bookkeeping matches the C driver: per level ``n -> (n >> 1 or 1)`` for
the next level's active size, rows use the odd/even variant by parity of the
*current* active size.  Note the C driver pairs ``x >>= 1`` (floor) with a
low band of ``ceil(n/2)`` samples for odd n; the extra low sample simply
stays in place and is re-consumed on synthesis, so pack/unpack here uses the
same floor rule for the active region.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from . import lifting


def _level_sizes(n: int, levels: int) -> List[int]:
    """Active sizes per level: [n, n>>1 or 1, ...] (dwt2d.cpp:78-81)."""
    out = [n]
    for _ in range(levels):
        n = max(n >> 1, 1)
        out.append(n)
    return out


def _fwd_axis(x: jnp.ndarray, filt: str, axis: int) -> jnp.ndarray:
    """One packed forward 1D transform along ``axis`` (low | high layout).

    The 5/3 and 9/7 banks run natively along either of the last two axes
    (strided slicing of the row axis), so the column pass needs no
    ``moveaxis`` relayout of the frame stack."""
    if axis in (-1, -2) and filt in lifting.AXIS_AWARE:
        l, h = lifting.fwd(filt, x, axis=axis)
        return jnp.concatenate([l, h], axis=axis)
    xm = jnp.moveaxis(x, axis, -1)
    l, h = lifting.fwd(filt, xm)
    return jnp.moveaxis(jnp.concatenate([l, h], axis=-1), -1, axis)


def _inv_axis(x: jnp.ndarray, filt: str, axis: int, n_low: int) -> jnp.ndarray:
    if axis in (-1, -2) and filt in lifting.AXIS_AWARE:
        if axis == -1:
            return lifting.inv(filt, x[..., :n_low], x[..., n_low:],
                               axis=axis)
        return lifting.inv(filt, x[..., :n_low, :], x[..., n_low:, :],
                           axis=axis)
    xm = jnp.moveaxis(x, axis, -1)
    s = lifting.inv(filt, xm[..., :n_low], xm[..., n_low:])
    return jnp.moveaxis(s, -1, axis)


def analyze(x: jnp.ndarray, levels: int, filt: str = "5/3") -> jnp.ndarray:
    """Packed multi-level forward 2D DWT over the last two axes.

    Matches ``dwt2d<TYPE,FILTER>::analyze`` (dwt2d.cpp:76-119): per level,
    rows first then columns, operating in place on the active top-left
    region.
    """
    if filt == "9/7" and not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    H, W = x.shape[-2], x.shape[-1]
    ys = _level_sizes(H, levels)
    xs = _level_sizes(W, levels)
    for lv in range(levels):
        ny, nx = ys[lv], xs[lv]
        sub = x[..., :ny, :nx]
        sub = _fwd_axis(sub, filt, -1)   # rows
        sub = _fwd_axis(sub, filt, -2)   # columns
        x = x.at[..., :ny, :nx].set(sub)
    return x


def synthesize(x: jnp.ndarray, levels: int, filt: str = "5/3") -> jnp.ndarray:
    """Packed multi-level inverse 2D DWT (dwt2d.cpp:128-175): per level,
    columns first then rows."""
    if filt == "9/7" and not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    H, W = x.shape[-2], x.shape[-1]
    ys = _level_sizes(H, levels)
    xs = _level_sizes(W, levels)
    for lv in range(levels - 1, -1, -1):
        ny, nx = ys[lv], xs[lv]
        # previous (coarser) active sizes = number of low samples
        my, mx = ys[lv + 1], xs[lv + 1]
        # C semantics: my = ny>>1 except clamped to 1; for odd ny the low
        # band actually holds ceil(ny/2) samples.
        nly = ny - (ny // 2)
        nlx = nx - (nx // 2)
        sub = x[..., :ny, :nx]
        sub = _inv_axis(sub, filt, -2, nly)  # columns
        sub = _inv_axis(sub, filt, -1, nlx)  # rows
        x = x.at[..., :ny, :nx].set(sub)
    return x


# ---------------------------------------------------------------------------
# Interpolation helpers built on the packed transform (the reference's idiom
# for 2x up/down-sampling: zero the high bands and synthesize — e.g. chroma
# upsampling decorrelate.cpp:591-648, subpixel interpolation
# motion_estimate.cpp:361-407)
# ---------------------------------------------------------------------------

def _interp_axis(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Zero-high 5/3 synthesis along one axis, closed form.

    With all high samples zero, ``inv53`` collapses to even = low and odd =
    ``tdiv(l[i] + l[i+1], 2)`` (right edge replicated) — plain linear
    interpolation with the reference's truncating division.  Avoids the
    packed transform's canvas writes and axis moves entirely (this runs in
    the MCTF hot path: chroma 4:2:0 -> 4:4:4 per frame per level)."""
    if axis == -1:
        nxt = jnp.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
        odd = lifting.tdiv(x + nxt, 2)
        out = jnp.stack([x, odd], axis=-1)
        return out.reshape(out.shape[:-2] + (2 * x.shape[-1],))
    assert axis == -2
    nxt = jnp.concatenate([x[..., 1:, :], x[..., -1:, :]], axis=-2)
    odd = lifting.tdiv(x + nxt, 2)
    out = jnp.stack([x, odd], axis=-2)
    return out.reshape(out.shape[:-3] + (2 * x.shape[-2],) + x.shape[-1:])


def _low_axis(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Forward 5/3 low band along one even-length axis, closed form
    (``fwd53`` even branch without materializing the packed high half)."""
    if axis == -1:
        se, so = x[..., 0::2], x[..., 1::2]
        se_next = jnp.concatenate([se[..., 1:], se[..., -1:]], axis=-1)
        h = so - lifting.tdiv(se + se_next, 2)
        h_left = jnp.concatenate([h[..., :1], h[..., :-1]], axis=-1)
        return se + lifting.tdiv(h + h_left, 4)
    assert axis == -2
    se, so = x[..., 0::2, :], x[..., 1::2, :]
    se_next = jnp.concatenate([se[..., 1:, :], se[..., -1:, :]], axis=-2)
    h = so - lifting.tdiv(se + se_next, 2)
    h_left = jnp.concatenate([h[..., :1, :], h[..., :-1, :]], axis=-2)
    return se + lifting.tdiv(h + h_left, 4)


def upsample2(x: jnp.ndarray, filt: str = "5/3") -> jnp.ndarray:
    """Interpolate x2 in both dimensions: place ``x`` as the LL band of a
    double-size canvas with zero high bands and run one synthesis level.

    For the 5/3 bank this uses the closed form (columns then rows, matching
    ``synthesize``'s pass order exactly — truncating division makes the
    order observable); other filters take the generic packed path."""
    if filt == "5/3":
        return _interp_axis(_interp_axis(x, -2), -1)
    H, W = x.shape[-2], x.shape[-1]
    canvas = jnp.zeros(x.shape[:-2] + (2 * H, 2 * W), dtype=x.dtype)
    canvas = canvas.at[..., :H, :W].set(x)
    return synthesize(canvas, 1, filt)


def downsample2(x: jnp.ndarray, filt: str = "5/3") -> jnp.ndarray:
    """One analysis level, returning the LL band (chroma 444->420 path,
    decorrelate.cpp:860-861).

    5/3 with even dims uses the closed form (rows then columns, matching
    ``analyze``'s pass order; the column pass touches only the low rows);
    odd dims / other filters take the generic packed path."""
    H, W = x.shape[-2], x.shape[-1]
    if filt == "5/3" and H % 2 == 0 and W % 2 == 0:
        return _low_axis(_low_axis(x, -1), -2)
    packed = analyze(x, 1, filt)
    return packed[..., :H - H // 2, :W - W // 2]


def ll_view(x: jnp.ndarray, levels: int) -> jnp.ndarray:
    """The LL band of a packed ``levels``-deep pyramid (top-left corner)."""
    H, W = x.shape[-2], x.shape[-1]
    ys = _level_sizes(H, levels)
    xs = _level_sizes(W, levels)
    return x[..., :ys[-1], :xs[-1]]
