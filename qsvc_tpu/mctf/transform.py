"""The full MCTF temporal transform: analyze (encode) and synthesize (decode).

Chains the per-level pipeline of the reference's ``analyze.py`` /
``analyze_step.py`` (split -> motion_estimate -> decorrelate -> update) and
its inverse ``synthesize.py`` / ``synthesize_step.py`` (un_update ->
correlate -> merge) — but as one jittable on-device computation per
sequence instead of per-stage processes exchanging files
(SURVEY.md §3.1/§3.2; reference compress.py:180-226).

Level schedule (pictures halving, search range doubling capped at 128,
block size halving floored) comes from ``CodecConfig.level_schedule()``
(analyze.py:121-153).  The temporal "lazy split" is pure indexing
(split.cpp: deinterleave even/odd frames).

All shapes are static per level; frame pairs vectorize with ``vmap``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import CodecConfig
from . import me, predict, update


class LevelData(NamedTuple):
    """Encoded data of one temporal level ``t``."""
    high_y: jnp.ndarray    # (P, H, W) biased residue / raw I frames
    high_u: jnp.ndarray    # (P, H/2, W/2)
    high_v: jnp.ndarray
    mv: jnp.ndarray        # (P, 2, 2, By, Bx) filtered motion (0 for I)
    is_B: jnp.ndarray      # (P,) bool frame types


class MCTFStream(NamedTuple):
    """Full temporal decomposition of a sequence."""
    low_y: jnp.ndarray     # final low band L_{TRLs-1}
    low_u: jnp.ndarray
    low_v: jnp.ndarray
    levels: Tuple[LevelData, ...]   # level 1 (finest) .. TRLs-1 (coarsest)


def _refs444(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(N,H,W)+(N,H/2,W/2)x2 -> (N, 3, H, W) luma-resolution stacks."""
    return jax.vmap(lambda a, b, c: predict.refs_to_444((a, b, c)))(y, u, v)


def _analyze_level(low: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                   block_size: int, search_range: int, cfg: CodecConfig
                   ) -> Tuple[Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                              LevelData]:
    y, u, v = low
    ey, eu, ev = y[0::2], u[0::2], v[0::2]
    oy, ou, ov = y[1::2], u[1::2], v[1::2]

    mv = me.estimate_sequence(ey, oy, block_size, search_range,
                              cfg.border_size, cfg.subpixel_accuracy)

    evens444 = _refs444(ey, eu, ev)

    preds = predict.predict_frames_subpixel(
        evens444[:-1], evens444[1:], mv, block_size, search_range,
        cfg.subpixel_accuracy, cfg.block_overlaping)
    dec = jax.vmap(partial(predict.decorrelate_from_pred,
                           always_B=cfg.always_B))(
        (oy, ou, ov), preds, mv)

    if cfg.update_factor != 0.0:
        res444 = jax.vmap(update.residue_to_444)(
            (dec.high_y, dec.high_u, dec.high_v),
            dec.is_B[:, None, None, None])
        # update applies whole-pixel offsets: sub-pixel vectors scale
        # down by 2^a (arithmetic shift = floor).  The reference instead
        # feeds sub-pixel-unit vectors straight into update.cpp's pixel
        # indexing (update.cpp:93-140 never consults subpixel_accuracy) -
        # a latent bug we do not replicate; enc/dec stay mirrored.
        mv_pix = (jnp.right_shift(dec.mv_out, cfg.subpixel_accuracy)
                  if cfg.subpixel_accuracy else dec.mv_out)
        upd_prev, upd_next = update.update_fields_batch2(
            res444, mv_pix, block_size, cfg.update_factor, search_range)
        # phase 1: even[j] += NEXT-update of pair j-1 (update.cpp iteration
        # order; reference[1] updated first), phase 2: even[j] += PREV-update
        # of pair j — each phase truncates and clamps like the C code.
        ev444 = evens444
        ev444 = ev444.at[1:].set(jax.vmap(partial(update.apply_update, sign=1))(
            ev444[1:], upd_next))
        ev444 = ev444.at[:-1].set(jax.vmap(partial(update.apply_update, sign=1))(
            ev444[:-1], upd_prev))
        ly = ev444[:, 0]
        lu = jax.vmap(predict.downsample_chroma)(ev444[:, 1])
        lv = jax.vmap(predict.downsample_chroma)(ev444[:, 2])
    else:
        ly, lu, lv = ey, eu, ev

    return (ly, lu, lv), LevelData(dec.high_y, dec.high_u, dec.high_v,
                                   dec.mv_out, dec.is_B)


def _synthesize_level(low: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                      lev: LevelData, block_size: int, search_range: int,
                      cfg: CodecConfig
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    ly, lu, lv = low
    low444 = _refs444(ly, lu, lv)

    if cfg.update_factor != 0.0:
        res444 = jax.vmap(update.residue_to_444)(
            (lev.high_y, lev.high_u, lev.high_v),
            lev.is_B[:, None, None, None])
        mv_pix = (jnp.right_shift(lev.mv, cfg.subpixel_accuracy)
                  if cfg.subpixel_accuracy else lev.mv)
        upd_prev, upd_next = update.update_fields_batch2(
            res444, mv_pix, block_size, cfg.update_factor, search_range)
        ev444 = low444
        ev444 = ev444.at[1:].set(jax.vmap(partial(update.apply_update, sign=-1))(
            ev444[1:], upd_next))
        ev444 = ev444.at[:-1].set(jax.vmap(partial(update.apply_update, sign=-1))(
            ev444[:-1], upd_prev))
    else:
        ev444 = low444

    preds = predict.predict_frames_subpixel(
        ev444[:-1], ev444[1:], lev.mv, block_size, search_range,
        cfg.subpixel_accuracy, cfg.block_overlaping)
    oy, ou, ov = jax.vmap(predict.correlate_from_pred)(
        (lev.high_y, lev.high_u, lev.high_v), preds,
        lev.is_B[:, None, None])

    ey = ev444[:, 0]
    eu = jax.vmap(predict.downsample_chroma)(ev444[:, 1])
    ev_ = jax.vmap(predict.downsample_chroma)(ev444[:, 2])

    # merge: re-interleave even/odd frames (split.cpp inverse)
    def merge(e, o):
        n = e.shape[0] + o.shape[0]
        out = jnp.zeros((n,) + e.shape[1:], dtype=e.dtype)
        return out.at[0::2].set(e).at[1::2].set(o)

    return merge(ey, oy), merge(eu, ou), merge(ev_, ov)


def analyze(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
            cfg: CodecConfig) -> MCTFStream:
    """Forward MCTF of a (2k+1)-frame sequence; planes in [0,255] (any
    integer dtype — uint8 inputs are widened on device, so the host upload
    stays 1 byte/pixel).

    All temporal-transform arithmetic runs in int16 (values stay within
    [-32768, 32767] throughout: pixels, 4:4:4 interpolations, residues and
    update contributions are all < 2^10 in magnitude); reductions that can
    exceed 16 bits (ME SAD sums, update collision accumulation, entropy
    histograms) widen locally.  Halving the element width halves the
    device-memory traffic of the memory-bound MC/lifting steps."""
    low = (y.astype(jnp.int16), u.astype(jnp.int16), v.astype(jnp.int16))
    levels: List[LevelData] = []
    for lp in cfg.level_schedule():
        low, lev = _analyze_level(low, lp.block_size, lp.search_range, cfg)
        levels.append(lev)
    return MCTFStream(low[0], low[1], low[2], tuple(levels))


def synthesize(stream: MCTFStream, cfg: CodecConfig
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Inverse MCTF: reconstruct the frame sequence."""
    low = (stream.low_y, stream.low_u, stream.low_v)
    schedule = cfg.level_schedule()
    for lp, lev in zip(reversed(schedule), reversed(stream.levels)):
        low = _synthesize_level(low, lev, lp.block_size, lp.search_range, cfg)
    return low


analyze_jit = jax.jit(analyze, static_argnames=("cfg",))
synthesize_jit = jax.jit(synthesize, static_argnames=("cfg",))
