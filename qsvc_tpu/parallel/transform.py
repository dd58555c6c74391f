"""Distributed MCTF: GOPs sharded over a device mesh, boundary halos
exchanged with collectives.

Each device runs the full per-GOP temporal transform locally (split, ME,
predict — all intra-GOP by construction, since a GOP carries both of its
boundary reference frames); only the MCTF **update** step couples adjacent
GOPs through the shared boundary frame: in the sequential reference, the
boundary even frame receives the NEXT-direction update from the last pair
of GOP ``g`` and the PREV-direction update from the first pair of GOP
``g+1`` (update.cpp iteration order).  Here that is exactly two
``lax.ppermute`` halo exchanges of one frame per temporal level:

  phase 1: every device applies its local NEXT updates; the updated right
           boundary is sent rightward, replacing the neighbour's left
           boundary copy;
  phase 2: every device applies its local PREV updates (the received left
           boundary now accumulates both contributions, in the reference's
           order); the finished left boundary is sent leftward so both
           copies of the shared frame agree.

Synthesis mirrors the same pattern with subtraction.  With
``update_factor == 0`` there is no cross-GOP coupling and the transform is
embarrassingly parallel.

Usage: ``shard_map`` over the ``gop`` mesh axis with one GOP per device
(the multi-device dry run), or vmap-within-device for more GOPs
than devices.  ``analyze_sharded`` and ``synthesize_sharded`` are each
one jitted program: a ``shard_map`` called outside ``jit`` runs eagerly,
compiling and dispatching every primitive on its own, as
``encode_step_sharded`` (the scaling harness's step) still does.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import CodecConfig
from ..mctf import me, predict, update
from ..mctf.transform import LevelData, MCTFStream


def _right_shift(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Receive the left neighbour's value (device i gets i-1's x)."""
    n = lax.axis_size(axis_name)
    return lax.ppermute(x, axis_name, [(i, (i + 1) % n) for i in range(n)])


def _left_shift(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    n = lax.axis_size(axis_name)
    return lax.ppermute(x, axis_name, [(i, (i - 1) % n) for i in range(n)])


def _analyze_level_dist(low, block_size, search_range, cfg, axis_name):
    """One temporal level on local per-GOP frames with halo exchange."""
    y, u, v = low
    ey, eu, ev = y[0::2], u[0::2], v[0::2]
    oy, ou, ov = y[1::2], u[1::2], v[1::2]

    mv = me.estimate_sequence(ey, oy, block_size, search_range,
                              cfg.border_size, cfg.subpixel_accuracy)
    evens444 = jax.vmap(lambda a, b, c: predict.refs_to_444((a, b, c)))(
        ey, eu, ev)
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
        upd_prev = update.update_fields_batch(
            res444, mv_pix[:, 0, 0], mv_pix[:, 0, 1], block_size,
            cfg.update_factor, search_range)
        upd_next = update.update_fields_batch(
            res444, mv_pix[:, 1, 0], mv_pix[:, 1, 1], block_size,
            cfg.update_factor, search_range)
        ev444 = evens444
        # phase 1: NEXT updates (evens 1..k locally)
        ev444 = ev444.at[1:].set(jax.vmap(partial(update.apply_update,
                                                  sign=1))(
            ev444[1:], upd_next))
        # halo: device g's updated right boundary -> device g+1's left copy
        idx = lax.axis_index(axis_name)
        from_left = _right_shift(ev444[-1], axis_name)
        left0 = jnp.where(idx == 0, ev444[0], from_left)
        ev444 = ev444.at[0].set(left0)
        # phase 2: PREV updates (evens 0..k-1 locally)
        ev444 = ev444.at[:-1].set(jax.vmap(partial(update.apply_update,
                                                   sign=1))(
            ev444[:-1], upd_prev))
        # halo back: device g+1's finished left boundary -> device g's right
        n = lax.axis_size(axis_name)
        from_right = _left_shift(ev444[0], axis_name)
        rightk = jnp.where(idx == n - 1, ev444[-1], from_right)
        ev444 = ev444.at[-1].set(rightk)
        ly = ev444[:, 0]
        lu = jax.vmap(predict.downsample_chroma)(ev444[:, 1])
        lv = jax.vmap(predict.downsample_chroma)(ev444[:, 2])
    else:
        ly, lu, lv = ey, eu, ev

    return (ly, lu, lv), LevelData(dec.high_y, dec.high_u, dec.high_v,
                                   dec.mv_out, dec.is_B)


def _synthesize_level_dist(low, lev: LevelData, block_size, search_range,
                           cfg, axis_name):
    ly, lu, lv = low
    low444 = jax.vmap(lambda a, b, c: predict.refs_to_444((a, b, c)))(
        ly, lu, lv)

    if cfg.update_factor != 0.0:
        res444 = jax.vmap(update.residue_to_444)(
            (lev.high_y, lev.high_u, lev.high_v),
            lev.is_B[:, None, None, None])
        mv_pix = (jnp.right_shift(lev.mv, cfg.subpixel_accuracy)
                  if cfg.subpixel_accuracy else lev.mv)
        upd_prev = update.update_fields_batch(
            res444, mv_pix[:, 0, 0], mv_pix[:, 0, 1], block_size,
            cfg.update_factor, search_range)
        upd_next = update.update_fields_batch(
            res444, mv_pix[:, 1, 0], mv_pix[:, 1, 1], block_size,
            cfg.update_factor, search_range)
        ev444 = low444
        ev444 = ev444.at[1:].set(jax.vmap(partial(update.apply_update,
                                                  sign=-1))(
            ev444[1:], upd_next))
        idx = lax.axis_index(axis_name)
        from_left = _right_shift(ev444[-1], axis_name)
        left0 = jnp.where(idx == 0, ev444[0], from_left)
        ev444 = ev444.at[0].set(left0)
        ev444 = ev444.at[:-1].set(jax.vmap(partial(update.apply_update,
                                                   sign=-1))(
            ev444[:-1], upd_prev))
        n = lax.axis_size(axis_name)
        from_right = _left_shift(ev444[0], axis_name)
        rightk = jnp.where(idx == n - 1, ev444[-1], from_right)
        ev444 = ev444.at[-1].set(rightk)
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

    def merge(e, o):
        n_ = e.shape[0] + o.shape[0]
        out = jnp.zeros((n_,) + e.shape[1:], dtype=e.dtype)
        return out.at[0::2].set(e).at[1::2].set(o)

    return merge(ey, oy), merge(eu, ou), merge(ev_, ov)


def _analyze_local(y, u, v, cfg: CodecConfig, axis_name: str) -> MCTFStream:
    # int16 transform arithmetic, matching the sequential path (see
    # mctf.transform.analyze)
    low = (y.astype(jnp.int16), u.astype(jnp.int16), v.astype(jnp.int16))
    levels = []
    for lp in cfg.level_schedule():
        low, lev = _analyze_level_dist(low, lp.block_size, lp.search_range,
                                       cfg, axis_name)
        levels.append(lev)
    return MCTFStream(low[0], low[1], low[2], tuple(levels))


def _synthesize_local(stream: MCTFStream, cfg: CodecConfig, axis_name: str):
    low = (stream.low_y, stream.low_u, stream.low_v)
    for lp, lev in zip(reversed(cfg.level_schedule()),
                       reversed(stream.levels)):
        low = _synthesize_level_dist(low, lev, lp.block_size,
                                     lp.search_range, cfg, axis_name)
    return low


@partial(jax.jit, static_argnames=("cfg", "mesh", "axis"))
def analyze_sharded(y, u, v, cfg: CodecConfig, mesh: Mesh,
                    axis: str = "gop"):
    """Distributed forward MCTF.

    ``y``: (D, k*S+1, H, W) sharded on the leading chunk axis with
    D == mesh axis size and k GOPs per device (k=1: one GOP per
    device); chroma likewise.  A chunk is simply a shorter open-GOP
    sequence — the level loop reads block_size/search_range from the
    schedule and frame counts from the array shapes, and the ppermute
    halos couple chunk edges exactly as they couple single GOPs —
    so any multiplicity shards with the same program.  Returns a
    per-chunk MCTFStream pytree with the leading axis sharded.
    """
    assert y.shape[0] == mesh.shape[axis], (
        f"one chunk per device: got {y.shape[0]} chunks on a "
        f"{mesh.shape[axis]}-device mesh (fold extra GOPs INTO chunks: "
        f"shard_gops with gop_size*k)")

    def fn(y_, u_, v_):
        # local shapes (1, k*S+1, ...) -> per-chunk compute
        st = _analyze_local(y_[0], u_[0], v_[0], cfg, axis)
        return jax.tree.map(lambda a: a[None], st)

    spec = P(axis)
    return shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, check_vma=False)(y, u, v)


@partial(jax.jit, static_argnames=("cfg", "mesh", "axis"))
def synthesize_sharded(stream, cfg: CodecConfig, mesh: Mesh,
                       axis: str = "gop"):
    """Distributed inverse MCTF on a per-chunk stream pytree.  (The
    level loop only reads block_size/search_range from the schedule —
    picture counts come from the array shapes — so the global cfg
    serves chunks of any GOP multiplicity.)"""
    assert stream.low_y.shape[0] == mesh.shape[axis], (
        stream.low_y.shape, dict(mesh.shape))

    def fn(st):
        local = jax.tree.map(lambda a: a[0], st)
        out = _synthesize_local(local, cfg, axis)
        return jax.tree.map(lambda a: a[None], out)

    spec = P(axis)
    return shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
                     check_vma=False)(stream)


def encode_step_sharded(y, u, v, cfg: CodecConfig, mesh: Mesh,
                        axis: str = "gop"):
    """Full device-side encode step: distributed MCTF + packed spatial DWT
    of every subband frame (the part of ``compress`` that runs on chips;
    EBCOT consumes the returned coefficient planes on host)."""
    from ..ops import dwt2d

    srl = cfg.SRLs - 1
    assert y.shape[0] == mesh.shape[axis], (y.shape, dict(mesh.shape))

    def fn(y_, u_, v_):
        st = _analyze_local(y_[0], u_[0], v_[0], cfg, axis)

        def dwt(frames, filt="5/3"):
            return dwt2d.analyze(frames - 128, srl, filt)

        out = {
            "low": tuple(dwt(x) for x in
                         (st.low_y, st.low_u, st.low_v)),
            "levels": tuple(
                (dwt(lev.high_y), dwt(lev.high_u), dwt(lev.high_v),
                 lev.mv, lev.is_B)
                for lev in st.levels),
        }
        return jax.tree.map(lambda a: a[None], out)

    spec = P(axis)
    return shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, check_vma=False)(y, u, v)
