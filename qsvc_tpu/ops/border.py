"""Frame border handling (edge replication) and block windowing.

The reference allocates frames with a margin and replicates the nearest
pixel into it (``texture.cpp:34-113`` ``alloc``/``fill_border``); motion
search and compensation then index freely into the margin.  Here frames
stay un-padded in device memory and the padded view is materialized with
``jnp.pad(mode="edge")`` just before the ops that need it — XLA fuses the
pad into the consumer.
"""

from __future__ import annotations

import jax.numpy as jnp


def pad_edge(x: jnp.ndarray, border: int) -> jnp.ndarray:
    """Edge-replicating pad of the last two axes (texture.cpp:55-113)."""
    if border == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(border, border), (border, border)]
    return jnp.pad(x, pad, mode="edge")


def block_index_grids(blocks_y: int, blocks_x: int, win: int,
                      block_size: int, offset: int):
    """Per-block pixel coordinate grids of a (win x win) window anchored at
    each block's top-left corner minus ``offset``.

    Returns (iy, ix) of shape (blocks_y, blocks_x, win, win) in un-padded
    frame coordinates (may be negative / beyond the frame; add the pad
    border before gathering).
    """
    by = jnp.arange(blocks_y)[:, None, None, None] * block_size
    bx = jnp.arange(blocks_x)[None, :, None, None] * block_size
    wy = jnp.arange(win)[None, None, :, None] - offset
    wx = jnp.arange(win)[None, None, None, :] - offset
    iy = by + wy
    ix = bx + wx
    return jnp.broadcast_to(iy, (blocks_y, blocks_x, win, win)), \
        jnp.broadcast_to(ix, (blocks_y, blocks_x, win, win))
