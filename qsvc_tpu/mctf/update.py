"""MCTF update lifting step (forward = update, inverse = un_update).

Re-creates ``trunk/src/update.cpp``: each B-frame residue is scattered back
into both motion-compensated reference (even) frames scaled by
``update_factor``, destination coordinates clipped to the frame and values
clamped to [0,255] (update.cpp:71-148, gated to B frames :601-618).  All
components are processed at luma resolution with chroma (reference and
residue) interpolated up and the result brought back to 4:2:0 around the
step (update.cpp:482-501,632-643; the residue interpolation is the intended
``UPDATE_STEP`` path — without it the reference indexes stale memory beyond
the chroma quadrant, a latent bug we do not replicate).

Deviation (documented): the reference applies block updates
sequentially with a clamp after every accumulation, so colliding
destinations (possible once vectors differ between blocks, or at clipped
frame borders) depend on block order.  Here all contributions are
accumulated with one deterministic ``scatter-add`` and the truncation/clamp
is applied once — parallel, order-independent, and identical whenever a
pixel receives a single contribution (the overwhelmingly common case).
The inverse applies the same accumulated update with opposite sign, so
encode/decode stay mirrored.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops import blocks
from .predict import upsample_chroma


def _update_field(residue_444: jnp.ndarray, mv_dir_y: jnp.ndarray,
                  mv_dir_x: jnp.ndarray, block_size: int,
                  update_factor: float, search_range: int = 128
                  ) -> jnp.ndarray:
    """Accumulated integer update for one reference from one residue.

    ``residue_444``: (C, H, W) unbiased residue at luma resolution.
    Returns the (C, H, W) int32 sum of ``floor(residue * update_factor)``
    at motion-compensated destinations (update.cpp:88-146).

    Formulation: the scatter is inverted into a **gather**, which is
    deterministic and needs no atomics: a destination pixel ``p``
    receives block ``b``'s contribution iff ``p - mv_b`` lands inside
    ``b``.  Since vectors are block-constant and bounded by the search
    range, only block offsets within ``K = ceil(max|mv| / block_size)``
    of ``p``'s own block can contribute, so the update is a sum of
    ``(2K+1)^2`` masked shifted gathers.

    Semantics deviations (documented): contributions whose destination
    falls outside the frame are dropped rather than clipped onto the border
    (update.cpp piles them on edge pixels); colliding contributions
    accumulate and clamp once.  Encoder and decoder share this exact
    function, so the lifting stays mirrored.

    Integer-lifting deviation from update.cpp: the contribution is
    quantized to floor(residue * factor) BEFORE applying, so encoder and
    decoder add/subtract the *same* integer and the step is exactly
    invertible wherever the [0,255] clamp doesn't engage.  The reference
    truncates after the float add (update.cpp:99-115), which makes its
    encode +floor(u) but its decode -ceil(u) — a systematic ±1 that we do
    not reproduce.  For a single in-frame contribution the encoder-side
    values are bitwise identical to the reference's.
    """
    C, H, W = residue_444.shape
    By, Bx = mv_dir_y.shape
    bs = block_size
    # per-pixel contribution fits int16 (|residue| <= 255, factor <= 1);
    # the (2K+1)^2 accumulation below widens to int32 (colliding blocks
    # can sum past 2^15 at large search ranges)
    contrib = jnp.floor(residue_444.astype(jnp.float32)
                        * jnp.float32(update_factor)).astype(jnp.int16)
    # vectors are clamped to +-search_range at ME time
    # (motion_estimate.cpp:321-348), bounding the contributing
    # block-offset neighbourhood
    K = -(-int(search_range) // bs)
    P = int(search_range)            # zero pad: out-of-frame sources drop
    padded = jnp.pad(contrib, ((0, 0), (P, P), (P, P)))
    base_y = (jnp.arange(By, dtype=jnp.int32) * bs)[:, None]
    base_x = (jnp.arange(Bx, dtype=jnp.int32) * bs)[None, :]
    iota = jnp.arange(bs, dtype=jnp.int32)
    out_blocks = jnp.zeros((By, Bx, C, bs, bs), dtype=jnp.int32)
    for dy in range(-K, K + 1):
        for dx in range(-K, K + 1):
            byc = jnp.clip(jnp.arange(By, dtype=jnp.int32) + dy, 0, By - 1)
            bxc = jnp.clip(jnp.arange(Bx, dtype=jnp.int32) + dx, 0, Bx - 1)
            in_grid = ((jnp.arange(By) + dy >= 0) & (jnp.arange(By) + dy < By)
                       )[:, None] & \
                      ((jnp.arange(Bx) + dx >= 0) & (jnp.arange(Bx) + dx < Bx)
                       )[None, :]
            mvy = mv_dir_y[byc[:, None], bxc[None, :]]   # (By, Bx)
            mvx = mv_dir_x[byc[:, None], bxc[None, :]]
            # dest pixel p in block (i,j) receives contrib[p - mv_b] iff
            # p - mv_b lies inside source block b=(i+dy, j+dx): with patch
            # coords r, that is r in [mv + d*bs, mv + d*bs + bs)
            patches = blocks.gather_block_patches(
                padded, base_y - mvy + P, base_x - mvx + P, bs, bs)
            lo_y = mvy + dy * bs
            lo_x = mvx + dx * bs
            rmask = ((iota[None, None, :] >= lo_y[:, :, None]) &
                     (iota[None, None, :] < (lo_y + bs)[:, :, None]))
            cmask = ((iota[None, None, :] >= lo_x[:, :, None]) &
                     (iota[None, None, :] < (lo_x + bs)[:, :, None]))
            m = (in_grid[:, :, None, None] & rmask[:, :, :, None] &
                 cmask[:, :, None, :])
            out_blocks = out_blocks + jnp.where(m[:, :, None], patches, 0)
    return blocks.blocks_to_image(out_blocks)


def update_fields_batch(res444: jnp.ndarray, mv_y: jnp.ndarray,
                        mv_x: jnp.ndarray, block_size: int,
                        update_factor: float, search_range: int
                        ) -> jnp.ndarray:
    """Batched accumulated update for one direction over a level's pairs.

    ``res444``: (P, C, H, W) unbiased residues; ``mv_*``: (P, By, Bx).
    """
    return jax.vmap(partial(_update_field, block_size=block_size,
                            update_factor=update_factor,
                            search_range=search_range))(res444, mv_y, mv_x)


def update_fields_batch2(res444: jnp.ndarray, mv: jnp.ndarray,
                         block_size: int, update_factor: float,
                         search_range: int
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulated update for BOTH directions of a level's pairs.

    ``res444``: (P, C, H, W) unbiased residues; ``mv``: (P, 2, 2, By, Bx).
    Returns ``(upd_prev, upd_next)``."""
    return (update_fields_batch(res444, mv[:, 0, 0], mv[:, 0, 1], block_size,
                                update_factor, search_range),
            update_fields_batch(res444, mv[:, 1, 0], mv[:, 1, 1], block_size,
                                update_factor, search_range))


def apply_update(even_444: jnp.ndarray, upd: jnp.ndarray, sign: int
                 ) -> jnp.ndarray:
    """clip(frame ± upd, 0, 255) with the integer update (update.cpp:99-115
    modulo the integer-lifting deviation documented above)."""
    return jnp.clip(even_444 + sign * upd, 0, 255).astype(even_444.dtype)


def residue_to_444(high: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                   is_B: jnp.ndarray) -> jnp.ndarray:
    """Biased high-band planes -> unbiased (3, H, W) residue at luma res;
    zero for I frames (update gated to B, update.cpp:601-618)."""
    hy, hu, hv = high
    res = jnp.stack([hy - 128,
                     upsample_chroma(hu - 128),
                     upsample_chroma(hv - 128)])
    return jnp.where(is_B, res, jnp.zeros_like(res))
