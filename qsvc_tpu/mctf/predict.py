"""MCTF predict lifting step (forward = decorrelate, inverse = correlate).

Re-creates ``trunk/src/decorrelate.cpp`` as batched array code:

* chroma planes are interpolated to luma resolution by zero-stuffing the
  packed high bands and running one 5/3 synthesis (decorrelate.cpp:591-648),
  because motion vectors apply at luma precision to all components;
* the prediction of each pixel is the truncating average of the two
  motion-shifted references (``predict()``, decorrelate.cpp:99-108) — here a
  single per-direction gather driven by a per-pixel motion map (the
  block-constant MV field expanded with ``jnp.repeat``) instead of per-block
  scalar loops;
* the prediction is clipped to [0,255], chroma is brought back to 4:2:0 by
  one packed analysis keeping the LL band (decorrelate.cpp:841-861);
* the residue is ``clip(odd - prediction, -128, 127)`` stored +128 biased
  (decorrelate.cpp:918-929, 1007-1022);
* the adaptive I/B decision compares first-order entropies:
  ``H(odd)*pixels <= H(residue)*pixels + H(motion)*blocks`` selects an
  I-frame, which stores the odd frame unchanged and zeroes its motion field
  (decorrelate.cpp:934-1027).  Inside jit both branches are computed and
  selected — no data-dependent control flow.

Out-of-frame reads use edge replication (texture.cpp fill_border semantics)
via functional padding by ``picture_border = 4*search_range +
block_overlaping`` (decorrelate.cpp:539).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops import blocks, dwt2d
from ..ops.border import pad_edge
from ..ops.entropy import histogram_entropy
from ..ops.lifting import tdiv


class FramePlanes(NamedTuple):
    """One frame stack: luma (N,H,W), chroma u/v (N,H/2,W/2), all int32."""
    y: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray


def upsample_chroma(c: jnp.ndarray) -> jnp.ndarray:
    """Chroma to luma resolution (zero-high 5/3 synthesis,
    decorrelate.cpp:610-648)."""
    return dwt2d.upsample2(c)


def downsample_chroma(c: jnp.ndarray) -> jnp.ndarray:
    """Luma-res chroma back to 4:2:0 (one packed analysis, LL kept,
    decorrelate.cpp:860-861)."""
    return dwt2d.downsample2(c)


def mv_to_pixel_map(mv: jnp.ndarray, block_size: int, H: int, W: int
                    ) -> jnp.ndarray:
    """Expand a block motion field (..., By, Bx) to per-pixel (..., H, W)."""
    m = jnp.repeat(jnp.repeat(mv, block_size, axis=-2), block_size, axis=-1)
    return m[..., :H, :W]


def _mc_gather(ref: jnp.ndarray, mv_y: jnp.ndarray, mv_x: jnp.ndarray,
               block_size: int, border: int) -> jnp.ndarray:
    """Motion-compensated gather: ``out`` block (i,j) = the ``ref`` block
    shifted by that block's vector, with edge replication ``border`` pixels
    deep.  One XLA gather with block-sized slices: each block row is a
    contiguous load, where a per-pixel index gather reads element by
    element.

    ``mv_y``/``mv_x``: (By, Bx) block-constant vectors, |mv| <= border.
    """
    By, Bx = mv_y.shape
    padded = pad_edge(ref, border)
    base_y = (jnp.arange(By, dtype=jnp.int32) * block_size)[:, None]
    base_x = (jnp.arange(Bx, dtype=jnp.int32) * block_size)[None, :]
    patches = blocks.gather_block_patches(
        padded, base_y + mv_y + border, base_x + mv_x + border,
        block_size, block_size)
    return blocks.blocks_to_image(patches)


def predict_frame(ref_prev: jnp.ndarray, ref_next: jnp.ndarray,
                  mv: jnp.ndarray, block_size: int, border: int
                  ) -> jnp.ndarray:
    """Bidirectional prediction of one frame at luma resolution.

    ``ref_*``: (C, H, W) int (chroma already upsampled);
    ``mv``: (2 dirs, 2 comps, By, Bx).
    """
    g_prev = _mc_gather(ref_prev, mv[0, 0], mv[0, 1], block_size, border)
    g_next = _mc_gather(ref_next, mv[1, 0], mv[1, 1], block_size, border)
    pred = tdiv(g_prev + g_next, 2)
    return jnp.clip(pred, 0, 255)


def predict_frames_batch(refs_prev: jnp.ndarray, refs_next: jnp.ndarray,
                         mv: jnp.ndarray, block_size: int,
                         search_range: int, block_overlaping: int = 0
                         ) -> jnp.ndarray:
    """Batched bidirectional prediction of a level's frame pairs.

    ``refs_*``: (P, C, H, W); ``mv``: (P, 2, 2, By, Bx).
    """
    if block_overlaping > 0:
        return _predict_frames_ola(refs_prev, refs_next, mv, block_size,
                                   search_range, block_overlaping)
    border = 4 * search_range + block_overlaping
    return jax.vmap(partial(predict_frame, block_size=block_size,
                            border=border))(refs_prev, refs_next, mv)


def _predict_frames_ola(refs_prev: jnp.ndarray, refs_next: jnp.ndarray,
                        mv: jnp.ndarray, block_size: int,
                        search_range: int, block_overlaping: int
                        ) -> jnp.ndarray:
    """Overlapped-block (OLA) bidirectional prediction
    (decorrelate.cpp:69-189).

    Each block's prediction window is widened by ``block_overlaping``
    pixels per side, block-DWT-analyzed ``log2(block_overlaping)``
    levels, each subband cropped back to the block's own coefficients
    (discarding the border's), stitched into a full-frame packed pyramid
    and synthesized — neighbouring blocks then share border texture
    inside every wavelet subband, which smooths block seams.

    ``refs``: (P, C, H, W); ``mv``: (P, 2, 2, By, Bx).  Returns
    (P, C, H, W) predictions clipped to [0, 255].
    """
    d = block_overlaping
    levels = int(round(math.log2(d)))
    bs = block_size
    P, C, H, W = refs_prev.shape
    By, Bx = H // bs, W // bs
    border = 4 * search_range + d
    win = bs + 2 * d

    base_y = (jnp.arange(By, dtype=jnp.int32) * bs)[:, None]
    base_x = (jnp.arange(Bx, dtype=jnp.int32) * bs)[None, :]

    def windows(ref, mv_y, mv_x):
        padded = pad_edge(ref, border)
        return blocks.gather_block_patches(
            padded, base_y + mv_y + border - d, base_x + mv_x + border - d,
            win, win)                     # (By, Bx, C, win, win)

    def one(ref_p, ref_n, mvp):
        wp = windows(ref_p, mvp[0, 0], mvp[0, 1])
        wn = windows(ref_n, mvp[1, 0], mvp[1, 1])
        avg = tdiv(wp + wn, 2)            # truncating /2, decorrelate.cpp:106
        packed = dwt2d.analyze(avg, levels)
        canvas = jnp.zeros((C, H, W), dtype=avg.dtype)

        def stitch(sub):                  # (By, Bx, C, b, b) -> (C, ..)
            b = sub.shape[-1]
            return sub.transpose(2, 0, 3, 1, 4).reshape(C, By * b, Bx * b)

        for l in range(1, levels + 1):
            b = bs >> l
            off = d >> l
            hoff = (bs + 3 * d) >> l
            Hl, Wl = H >> l, W >> l
            canvas = canvas.at[:, :Hl, Wl:2 * Wl].set(
                stitch(packed[..., off:off + b, hoff:hoff + b]))
            canvas = canvas.at[:, Hl:2 * Hl, :Wl].set(
                stitch(packed[..., hoff:hoff + b, off:off + b]))
            canvas = canvas.at[:, Hl:2 * Hl, Wl:2 * Wl].set(
                stitch(packed[..., hoff:hoff + b, hoff:hoff + b]))
        b = bs >> levels
        off = d >> levels
        canvas = canvas.at[:, :H >> levels, :W >> levels].set(
            stitch(packed[..., off:off + b, off:off + b]))
        pred = dwt2d.synthesize(canvas, levels)
        return jnp.clip(pred, 0, 255)     # decorrelate.cpp:842-848

    return jax.vmap(one)(refs_prev, refs_next, mv)


def predict_frames_subpixel(refs_prev: jnp.ndarray, refs_next: jnp.ndarray,
                            mv: jnp.ndarray, block_size: int,
                            search_range: int, subpixel_accuracy: int,
                            block_overlaping: int = 0) -> jnp.ndarray:
    """Batched bidirectional prediction with sub-pixel motion.

    Mirrors decorrelate.cpp's sub-pixel path (decorrelate.cpp:656-686,
    828-861): the 4:4:4 references are interpolated x2 per accuracy level
    (zero-high 5/3 synthesis), the block prediction runs at the
    interpolated resolution with ``block_size << a`` and the motion
    vectors applied directly (ME emits them in sub-pixel units,
    motion_estimate.cpp:361-407), the prediction is clipped to [0,255]
    and brought back to base resolution by ``a`` analysis levels keeping
    LL (decorrelate.cpp:852-858).  Returns base-resolution (P, C, H, W).
    """
    a = subpixel_accuracy
    if a <= 0:
        return predict_frames_batch(refs_prev, refs_next, mv, block_size,
                                    search_range, block_overlaping)
    up_p, up_n = refs_prev, refs_next
    for _ in range(a):
        up_p = dwt2d.upsample2(up_p)
        up_n = dwt2d.upsample2(up_n)
    pred = predict_frames_batch(up_p, up_n, mv, block_size << a,
                                search_range << a, block_overlaping << a)
    # prediction clip happens inside the block average (values stay in
    # [0,255] there); the reference's post-predict clip is equivalent
    for _ in range(a):
        pred = dwt2d.downsample2(pred)
    return pred


def refs_to_444(frame: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]
                ) -> jnp.ndarray:
    """(y, u, v) planes at native 4:2:0 -> (3, H, W) stack at luma res."""
    y, u, v = frame
    return jnp.stack([y, upsample_chroma(u), upsample_chroma(v)])


class PredictResult(NamedTuple):
    high_y: jnp.ndarray       # biased residue or raw I-frame luma (H, W)
    high_u: jnp.ndarray       # (H/2, W/2)
    high_v: jnp.ndarray
    mv_out: jnp.ndarray       # motion field, zeroed for I frames
    is_B: jnp.ndarray         # scalar bool


def decorrelate_pair(odd: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                     ref_prev_444: jnp.ndarray, ref_next_444: jnp.ndarray,
                     mv: jnp.ndarray, block_size: int, search_range: int,
                     block_overlaping: int = 0, always_B: bool = False
                     ) -> PredictResult:
    """Forward predict step for one odd frame (decorrelate.cpp ANALYZE path)."""
    border = 4 * search_range + block_overlaping
    pred = predict_frame(ref_prev_444, ref_next_444, mv, block_size, border)
    return decorrelate_from_pred(odd, pred, mv, always_B)


def decorrelate_from_pred(odd: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                          pred: jnp.ndarray, mv: jnp.ndarray,
                          always_B: bool = False) -> PredictResult:
    """Residue formation + I/B decision given the 4:4:4 prediction."""
    oy, ou, ov = odd
    H, W = oy.shape
    By, Bx = mv.shape[-2], mv.shape[-1]
    pred_u = downsample_chroma(pred[1])
    pred_v = downsample_chroma(pred[2])

    res_y = jnp.clip(oy - pred[0], -128, 127)
    res_u = jnp.clip(ou - pred_u, -128, 127)
    res_v = jnp.clip(ov - pred_v, -128, 127)

    # I/B decision on luma + motion entropy (decorrelate.cpp:934-979)
    predicted_entropy = histogram_entropy(jnp.clip(oy, 0, 255))
    residue_entropy = histogram_entropy(res_y + 128)
    motion_entropy = histogram_entropy(mv.reshape(-1) + 128, bins=257)
    pixels = jnp.float32(H * W)
    blocks = jnp.float32(By * Bx)
    predicted_size = (predicted_entropy * pixels).astype(jnp.int32)
    residue_size = (residue_entropy * pixels).astype(jnp.int32)
    motion_size = (motion_entropy * blocks).astype(jnp.int32)
    if always_B:
        is_B = jnp.bool_(True)
    else:
        is_B = predicted_size > residue_size + motion_size

    high_y = jnp.where(is_B, jnp.clip(res_y + 128, 0, 255), oy)
    high_u = jnp.where(is_B, jnp.clip(res_u + 128, 0, 255), ou)
    high_v = jnp.where(is_B, jnp.clip(res_v + 128, 0, 255), ov)
    mv_out = jnp.where(is_B, mv, jnp.zeros_like(mv))
    return PredictResult(high_y, high_u, high_v, mv_out, is_B)


def correlate_pair(high: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                   ref_prev_444: jnp.ndarray, ref_next_444: jnp.ndarray,
                   mv: jnp.ndarray, is_B: jnp.ndarray, block_size: int,
                   search_range: int, block_overlaping: int = 0
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Inverse predict step: reconstruct the odd frame
    (decorrelate.cpp:1036-1061 SYNTHESIZE path)."""
    border = 4 * search_range + block_overlaping
    pred = predict_frame(ref_prev_444, ref_next_444, mv, block_size, border)
    return correlate_from_pred(high, pred, is_B)


def correlate_from_pred(high: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                        pred: jnp.ndarray, is_B: jnp.ndarray
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    hy, hu, hv = high
    pred_u = downsample_chroma(pred[1])
    pred_v = downsample_chroma(pred[2])
    oy = jnp.clip((hy - 128) + pred[0], 0, 255)
    ou = jnp.clip((hu - 128) + pred_u, 0, 255)
    ov = jnp.clip((hv - 128) + pred_v, 0, 255)
    oy = jnp.where(is_B, oy, hy)
    ou = jnp.where(is_B, ou, hu)
    ov = jnp.where(is_B, ov, hv)
    return oy, ou, ov
