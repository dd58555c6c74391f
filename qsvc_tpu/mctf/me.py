"""Hierarchical bidirectional block-matching motion estimation.

Re-creates ``trunk/src/motion_estimate.cpp`` (FAST_SEARCH path) as
batched array code:

* a 5/3 packed DWT pyramid of depth ``round(log2(search_range)) - 1`` over
  predicted and both reference lumas (``motion_estimate.cpp:277-285``);
* at each level, every block refines its two vectors (PREV, NEXT) over the
  9-point spiral; probes are applied **anti-symmetrically** (PREV gets +d,
  NEXT gets -d, ``motion_estimate.cpp:89-91``) and ties keep the *later*
  probe in spiral order, so (0,0) wins ties (``<=`` update,
  ``motion_estimate.cpp:111-122``);
* between levels the motion field is duplicated 2x2 to the finer block grid
  (the reference does this as a packed Haar synthesis with implicit zero
  high bands, ``motion_estimate.cpp:314-317`` — exactly nearest-neighbour
  duplication), scaled by 2 and clamped to ``±search_range``
  (``motion_estimate.cpp:321-348``);
* optional sub-pixel refinement on 5/3-interpolated frames
  (``motion_estimate.cpp:361-407``).

Vectorization: instead of per-block scalar loops, each level performs ONE
gather per direction of per-block ``(win+2) x (win+2)`` reference patches at
the current vectors; the 9 spiral probes are then static slices of the
patches and the SADs are batched reductions, with no data-dependent
control flow.  Out-of-range reads clamp to the edge of the
active LL band (the reference reads stale border/high-band texels there —
deliberately not replicated; motion fields need no bit parity, they are
transmitted).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import blocks, dwt2d

# spiral order: later probes win ties; (0,0) last (motion_estimate.cpp:124-174)
SPIRAL = ((-1, -1), (-1, 1), (1, -1), (1, 1),
          (-1, 0), (1, 0), (0, 1), (0, -1), (0, 0))


def _ceil_half(x: int, times: int) -> int:
    for _ in range(times):
        x = (x + 1) // 2
    return x


def _padded_active(img: jnp.ndarray, ny: int, nx: int, lo: int,
                   By: int, Bx: int, block_size: int, win: int
                   ) -> jnp.ndarray:
    """Edge-replicate the active (ny, nx) region so that every block
    window/patch read (with the ±lo offset slack) stays in bounds — the
    functional equivalent of the reference's per-index clamping
    (patches read with clamped indices == reads from an edge-padded
    image while offsets stay within the pad)."""
    act = img[:ny, :nx]
    hi_y = lo + win + max(0, (By - 1) * block_size + win - ny)
    hi_x = lo + win + max(0, (Bx - 1) * block_size + win - nx)
    return jnp.pad(act, ((lo, hi_y), (lo, hi_x)), mode="edge")


def _gather_patches(img: jnp.ndarray, mv_y: jnp.ndarray, mv_x: jnp.ndarray,
                    block_size: int, border: int, ny: int, nx: int,
                    max_mv: int) -> jnp.ndarray:
    """Per-block patches of ``img`` shifted by per-block vectors.

    Returns (By, Bx, win+2, win+2) where win = block_size + 2*border; the +2
    margin covers the ±1 spiral.  Out-of-range reads replicate the edge of
    the active (ny, nx) region.  One XLA gather with patch-sized slices.
    """
    By, Bx = mv_y.shape
    win = block_size + 2 * border + 2
    lo = border + 1 + max_mv
    padded = _padded_active(img, ny, nx, lo, By, Bx, block_size, win)
    base_y = (jnp.arange(By, dtype=jnp.int32) * block_size)[:, None]
    base_x = (jnp.arange(Bx, dtype=jnp.int32) * block_size)[None, :]
    return blocks.gather_block_patches(
        padded, base_y + mv_y + (lo - border - 1),
        base_x + mv_x + (lo - border - 1), win, win)


def _pred_windows(img: jnp.ndarray, block_size: int, border: int,
                  By: int, Bx: int, ny: int, nx: int) -> jnp.ndarray:
    """(By, Bx, win, win) windows of the predicted frame around each block."""
    win = block_size + 2 * border
    padded = _padded_active(img, ny, nx, border, By, Bx, block_size, win)
    base_y = (jnp.arange(By, dtype=jnp.int32) * block_size)[:, None]
    base_x = (jnp.arange(Bx, dtype=jnp.int32) * block_size)[None, :]
    return blocks.gather_block_patches(
        padded, jnp.broadcast_to(base_y, (By, Bx)),
        jnp.broadcast_to(base_x, (By, Bx)), win, win)


def _refine_level(pred: jnp.ndarray, ref_prev: jnp.ndarray,
                  ref_next: jnp.ndarray, mv: jnp.ndarray,
                  block_size: int, border: int, ny: int, nx: int,
                  max_mv: int) -> jnp.ndarray:
    """One ±1 spiral refinement of all blocks (local_me_for_image,
    motion_estimate.cpp:196-225).

    ``mv``: (2 dirs, 2 comps(y,x), By, Bx) int32, |mv| <= max_mv.
    Returns updated mv.
    """
    By, Bx = mv.shape[2], mv.shape[3]
    win = block_size + 2 * border
    predw = _pred_windows(pred, block_size, border, By, Bx, ny, nx)
    patches_p = _gather_patches(ref_prev, mv[0, 0], mv[0, 1],
                                block_size, border, ny, nx, max_mv)
    patches_n = _gather_patches(ref_next, mv[1, 0], mv[1, 1],
                                block_size, border, ny, nx, max_mv)

    neg = jnp.iinfo(jnp.int32).max
    best_err_p = jnp.full((By, Bx), neg, dtype=jnp.int32)
    best_err_n = jnp.full((By, Bx), neg, dtype=jnp.int32)
    best_d_p = jnp.zeros((2, By, Bx), dtype=jnp.int32)
    best_d_n = jnp.zeros((2, By, Bx), dtype=jnp.int32)

    for dy, dx in SPIRAL:
        # PREV probes at +d, NEXT at -d (COMPUTE_ERRORS,
        # motion_estimate.cpp:89-101)
        sl_p = patches_p[:, :, 1 + dy:1 + dy + win, 1 + dx:1 + dx + win]
        sl_n = patches_n[:, :, 1 - dy:1 - dy + win, 1 - dx:1 - dx + win]
        # SAD accumulates past int16 (window sums reach ~1e6): widen the
        # per-pixel |diff| (always < 2^15) before the reduction
        err_p = jnp.sum(jnp.abs(predw - sl_p).astype(jnp.int32), axis=(2, 3))
        err_n = jnp.sum(jnp.abs(predw - sl_n).astype(jnp.int32), axis=(2, 3))
        take_p = err_p <= best_err_p           # later probe wins ties
        take_n = err_n <= best_err_n
        best_err_p = jnp.where(take_p, err_p, best_err_p)
        best_err_n = jnp.where(take_n, err_n, best_err_n)
        d = jnp.asarray([dy, dx], dtype=jnp.int32)[:, None, None]
        best_d_p = jnp.where(take_p[None], d, best_d_p)
        best_d_n = jnp.where(take_n[None], -d, best_d_n)

    mv = mv.at[0].add(best_d_p)
    mv = mv.at[1].add(best_d_n)
    return mv


def _upsample_mv(mv: jnp.ndarray, by_c: int, bx_c: int,
                 by_f: int, bx_f: int) -> jnp.ndarray:
    """Duplicate the coarse (by_c, bx_c) field 2x2 onto the finer grid
    (packed-Haar-with-zero-highs semantics, motion_estimate.cpp:314-317).
    Works on (..., 2, 2, By, Bx) fields (any leading batch axes)."""
    coarse = mv[..., :by_c, :bx_c]
    up = jnp.repeat(jnp.repeat(coarse, 2, axis=-2), 2, axis=-1)
    up = up[..., :by_f, :bx_f]
    return mv.at[..., :by_f, :bx_f].set(up)


def _refine_level_batch(preds: jnp.ndarray, prevs: jnp.ndarray,
                        nexts: jnp.ndarray, mv: jnp.ndarray,
                        block_size: int, border: int, ny: int, nx: int,
                        max_mv: int) -> jnp.ndarray:
    """Batched spiral refinement of a whole level's frame pairs.

    ``preds``/``prevs``/``nexts``: (P, H', W') lumas whose active region
    is (ny, nx); ``mv``: (P, 2, 2, By, Bx)."""
    f = partial(_refine_level, block_size=block_size, border=border, ny=ny,
                nx=nx, max_mv=max_mv)
    return jax.vmap(f)(preds, prevs, nexts, mv)


def estimate_pair(pred: jnp.ndarray, ref_prev: jnp.ndarray,
                  ref_next: jnp.ndarray, block_size: int,
                  search_range: int, border_size: int = 0,
                  subpixel_accuracy: int = 0) -> jnp.ndarray:
    """Motion field for one (even, odd, even) triple; lumas (H, W) int32.

    Returns mv of shape (2, 2, By, Bx): [PREV|NEXT][y|x][by][bx], such that
    ``ref[ y + mv_y, x + mv_x ]`` predicts ``pred[y, x]``.
    """
    return estimate_sequence(jnp.stack([ref_prev, ref_next]), pred[None],
                             block_size, search_range, border_size,
                             subpixel_accuracy)[0]


@partial(jax.jit, static_argnames=("block_size", "search_range",
                                   "border_size", "subpixel_accuracy"))
def estimate_sequence(evens: jnp.ndarray, odds: jnp.ndarray,
                      block_size: int, search_range: int,
                      border_size: int = 0, subpixel_accuracy: int = 0
                      ) -> jnp.ndarray:
    """Motion fields for a whole temporal level.

    ``evens``: (P+1, H, W) luma; ``odds``: (P, H, W).  Pair i uses
    (evens[i], odds[i], evens[i+1]) (motion_estimate.cpp:784-907).
    Returns (P, 2, 2, By, Bx).

    Batched end to end: the DWT pyramid is built ONCE per frame stack
    (each interior even frame previously downsampled twice, once as PREV
    and once as NEXT of adjacent pairs), and each refinement level runs
    all pairs through one vmapped gather formulation.
    """
    P = odds.shape[0]
    H, W = odds.shape[-2], odds.shape[-1]
    By, Bx = H // block_size, W // block_size
    dwt_levels = max(int(round(math.log2(search_range))) - 1, 0)

    def ll_pyramid(stack):
        """LL stacks at depths 0..dwt_levels (depth l = what the reference
        sees after synthesizing back to level l,
        motion_estimate.cpp:283-309).

        Only the LL band is ever consumed, so each level uses the
        closed-form 5/3 low-pass (``downsample2``) — bit-identical to the
        packed ``analyze`` LL corner but without computing or packing the
        three high bands."""
        lls = [stack]
        for _ in range(dwt_levels):
            lls.append(dwt2d.downsample2(lls[-1]))
        return lls

    lls_e = ll_pyramid(evens)
    lls_o = ll_pyramid(odds)

    mv = jnp.zeros((P, 2, 2, By, Bx), dtype=jnp.int32)

    # coarsest level first (motion_estimate.cpp:292-298)
    ny, nx = _ceil_half(H, dwt_levels), _ceil_half(W, dwt_levels)
    by_l, bx_l = _ceil_half(By, dwt_levels), _ceil_half(Bx, dwt_levels)
    mv_l = _refine_level_batch(lls_o[dwt_levels], lls_e[dwt_levels][:-1],
                               lls_e[dwt_levels][1:],
                               mv[..., :by_l, :bx_l],
                               block_size, border_size, ny, nx,
                               search_range)
    mv = mv.at[..., :by_l, :bx_l].set(mv_l)

    for l in range(dwt_levels - 1, -1, -1):
        ny, nx = _ceil_half(H, l), _ceil_half(W, l)
        by_f, bx_f = _ceil_half(By, l), _ceil_half(Bx, l)
        by_c, bx_c = _ceil_half(By, l + 1), _ceil_half(Bx, l + 1)
        mv = _upsample_mv(mv, by_c, bx_c, by_f, bx_f)
        mv = jnp.clip(mv * 2, -search_range, search_range)
        mv_l = _refine_level_batch(
            lls_o[l], lls_e[l][:-1], lls_e[l][1:],
            mv[..., :by_f, :bx_f], block_size, border_size, ny, nx,
            search_range)
        mv = mv.at[..., :by_f, :bx_f].set(mv_l)

    if subpixel_accuracy > 0:
        up_e, up_o = evens, odds
        for s in range(1, subpixel_accuracy + 1):
            up_e = dwt2d.upsample2(up_e)
            up_o = dwt2d.upsample2(up_o)
            cap = search_range << subpixel_accuracy
            mv = jnp.clip(mv * 2, -cap, cap)
            mv = _refine_level_batch(up_o, up_e[:-1], up_e[1:], mv,
                                     block_size << s, border_size >> s,
                                     H << s, W << s, cap)
    return mv
