"""Device-side simulation of the bp (bit-parallel) Tier-1 coder's
rate/distortion accounting.

The native bp coder (``native/ebcot.cpp`` ``bp::encode_block``) codes each
code-block in 3 passes per bit-plane (significance propagation, magnitude
refinement, cleanup with stripe group testing) and records per-pass byte
ends and SSE.  Both are *deterministic functions of the coefficients*, so
they can be computed on the device with vectorized bit-plane arithmetic —
before any coefficient crosses the host link.

This module reproduces that accounting exactly (same membership masks,
same per-pass alignment, same SSE update formulas) for a whole stack of
code-blocks at once, and reduces it to the one number the encoder's block
selection needs: ``smax`` — the maximum prefix distortion-length slope
``(d0 - sse_k) / ends_k`` over all passes.  The first segment of a block's
R-D convex hull has exactly this slope, so a block survives truncation at
threshold ``t`` iff ``smax * band_gain >= t``.  Blocks that fail are never
gathered, never transferred, never entropy-coded: at production operating
points this eliminates ~97% of the host-link traffic.

Performance note (the round-2 rewrite): because the bp format freezes pass
membership at plane start and updates significance only at plane end, the
significance state entering plane ``p`` is a *pure function of the
magnitudes*: ``sig_p = (mag >> (p+1)) != 0``.  There is therefore no
sequential dependency between planes at all — each plane's three passes
reduce independently to tiny ``(K,)`` statistics, and only the final
prefix-slope accumulation (48 scalars per block) is ordered.  This removes
the big carried (K, cb, cb) significance state of the first version
(a lax.scan whose carries defeated XLA fusion) and lets every plane fuse
into a handful of device-memory passes over the uint16 magnitudes.

No equivalent exists in the reference — it ships every coefficient to
Kakadu and lets EBCOT discard them (texture_compress_fb_j2k.py:183-196).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

#: bit-planes simulated: |int16| magnitudes need up to 16 (-32768).
PMAX = 16


def _nbr(sig: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """8-neighbour significance (frozen at plane start), clipped to the
    block interior like the native coder's row-mask shifts."""
    up = jnp.pad(sig[:, :-1, :], ((0, 0), (1, 0), (0, 0)))
    dn = jnp.pad(sig[:, 1:, :], ((0, 0), (0, 1), (0, 0)))
    t = up | sig | dn
    le = jnp.pad(t[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
    ri = jnp.pad(t[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
    return (le | ri | up | dn) & valid


def _sum2(x: jnp.ndarray) -> jnp.ndarray:
    """Sum over the trailing (h, w) axes -> (K,)."""
    return jnp.sum(x, axis=(1, 2))


@partial(jax.jit, static_argnames=("stripe",))
def bp_max_slope(tiles: jnp.ndarray, th: jnp.ndarray, tw: jnp.ndarray,
                 stripe: int = 4) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact bp-coder R-D accounting for a stack of code-blocks.

    ``tiles``: (K, cb, cb) integer coefficients (edge tiles zero-padded);
    ``th``/``tw``: (K,) true tile dims (the padded area is outside the
    native coder's ``validr`` masks and must not join any pass).

    Returns ``(smax, d0)``: per block the maximum prefix slope
    (unweighted SSE per byte, the first hull segment's slope) and the
    total SSE at zero rate.
    """
    K, cb, _ = tiles.shape
    v = tiles.astype(jnp.int32)
    rows = jnp.arange(cb, dtype=jnp.int32)
    valid = ((rows[None, :, None] < th[:, None, None]) &
             (rows[None, None, :] < tw[:, None, None]))
    # |int16| fits uint16 (32768); uint16 halves the HBM traffic of the
    # per-plane passes, which re-read the magnitudes rather than carrying
    # any big state between planes.
    mag = jnp.where(valid, jnp.abs(v), 0).astype(jnp.uint16)
    magf = mag.astype(jnp.float32)
    d0 = _sum2(magf * magf)

    maxm = jnp.max(mag, axis=(1, 2)).astype(jnp.int32)
    msbs = jnp.ceil(jnp.log2(jnp.maximum(maxm, 1).astype(jnp.float32) + 0.5)
                    ).astype(jnp.int32)
    msbs = jnp.where(maxm > 0, jnp.maximum(msbs, 1), 0)

    nstripes = (cb + stripe - 1) // stripe

    nbytes_list = []          # per pass: (K,) f32 byte counts (plane-gated)
    dsse_list = []            # per pass: (K,) f32 SSE deltas (plane-gated)

    for p in range(PMAX - 1, -1, -1):
        active = (p < msbs).astype(jnp.float32)          # (K,)
        bits = ((mag >> p) & 1).astype(bool)
        # significance entering plane p: some bit above p is set
        if p + 1 < 16:
            sig = (mag >> (p + 1)) != 0
        else:
            sig = jnp.zeros_like(bits)
        nb = _nbr(sig, valid)

        # reconstruction gain of a coefficient becoming significant at
        # plane p: rec = ((m>>p)<<p) + (p>0 ? 1<<(p-1) : 0);
        # dsse contribution = (m-rec)^2 - m^2
        rec = ((mag >> p) << p) + jnp.uint16(1 << (p - 1) if p > 0 else 0)
        err = magf - rec.astype(jnp.float32)
        new_sq = err * err - magf * magf                  # <= 0

        ones_new = bits & ~sig                            # newly significant

        # ---- significance propagation: members = ~sig & nbr & valid
        mem = nb & ~sig                                   # nb already &valid
        ones_spp = ones_new & nb
        nbits = (_sum2(mem) + _sum2(ones_spp)).astype(jnp.float32)
        dsse = _sum2(jnp.where(ones_spp, new_sq, 0.0))
        nbytes_list.append(jnp.ceil(nbits / 8.0) * active)
        dsse_list.append(dsse * active)

        # ---- magnitude refinement: members = sig & valid (sig <= valid)
        nbits = _sum2(sig).astype(jnp.float32)
        if p > 0:
            r = (mag & jnp.uint16((1 << p) - 1)).astype(jnp.float32)
            b1 = bits & sig
            b0 = sig & ~bits
            h = jnp.float32(1 << (p - 1))
            dsse = _sum2(jnp.where(b1, h * h - 2.0 * h * r,
                                   jnp.where(b0, 2.0 * h * r - 3.0 * h * h,
                                             0.0)))
        else:
            dsse = -_sum2((sig & ~bits).astype(jnp.float32))
        nbytes_list.append(jnp.ceil(nbits / 8.0) * active)
        dsse_list.append(dsse * active)

        # ---- cleanup: members = ~sig & ~nbr & valid, stripe group testing
        memc = (~sig) & (~nb) & valid
        ones_cp = ones_new & ~nb
        member_bits = jnp.sum(
            memc.reshape(K, nstripes, stripe, cb), axis=(2, 3))
        one_bits = jnp.sum(
            ones_cp.reshape(K, nstripes, stripe, cb), axis=(2, 3))
        nbits = jnp.sum(
            jnp.where(member_bits > 0,
                      1 + jnp.where(one_bits > 0, member_bits + one_bits, 0),
                      0),
            axis=1).astype(jnp.float32)
        dsse = _sum2(jnp.where(ones_cp, new_sq, 0.0))
        nbytes_list.append(jnp.ceil(nbits / 8.0) * active)
        dsse_list.append(dsse * active)

    # ordered prefix accumulation over the 3*PMAX tiny per-pass stats
    nbytes = jnp.stack(nbytes_list)                       # (48, K)
    dsse = jnp.stack(dsse_list)
    ends = jnp.cumsum(nbytes, axis=0)
    sse = d0[None, :] + jnp.cumsum(dsse, axis=0)
    slope = jnp.where(ends > 0, (d0[None, :] - sse) / jnp.maximum(ends, 1.0),
                      0.0)
    smax = jnp.max(slope, axis=0)
    return smax, d0
