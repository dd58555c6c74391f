"""Block-granular gather helpers for motion compensation.

The MC predict/update steps read, for every block of the destination
frame, one block-sized patch of a reference at a block-constant motion
offset.  Expressed as per-pixel index-array gathers XLA lowers this to an
elementwise gather; expressed as a vmapped ``lax.dynamic_slice`` it
lowers to a gather with big contiguous slice sizes, whose rows are
contiguous loads.  These helpers are the
framework-wide building blocks for that pattern (ME spiral patches, MC
predict, MC update inverse-gather).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def gather_block_patches(img: jnp.ndarray, start_y: jnp.ndarray,
                         start_x: jnp.ndarray, ph: int, pw: int
                         ) -> jnp.ndarray:
    """Per-block patches: ``out[i, j] = img[..., sy[i,j]:+ph, sx[i,j]:+pw]``.

    ``img``: (..., Hp, Wp); ``start_y``/``start_x``: (By, Bx) int32,
    assumed in-range (pad the image first).  Returns
    (By, Bx, ..., ph, pw).  Lowers to one XLA gather with (ph, pw) slices.
    """
    By, Bx = start_y.shape
    lead = img.shape[:-2]
    zeros = (jnp.int32(0),) * len(lead)

    def slice_one(sy, sx):
        return lax.dynamic_slice(img, zeros + (sy, sx), lead + (ph, pw))

    flat = jax.vmap(slice_one)(start_y.reshape(-1).astype(jnp.int32),
                               start_x.reshape(-1).astype(jnp.int32))
    return flat.reshape((By, Bx) + lead + (ph, pw))


def blocks_to_image(blocks: jnp.ndarray) -> jnp.ndarray:
    """(By, Bx, ..., bs, bs) non-overlapping blocks -> (..., By*bs, Bx*bs)."""
    By, Bx = blocks.shape[0], blocks.shape[1]
    bs_y, bs_x = blocks.shape[-2], blocks.shape[-1]
    lead = blocks.shape[2:-2]
    n = len(lead)
    # (By, Bx, ..., bs, bs) -> (..., By, bs, Bx, bs)
    perm = tuple(range(2, 2 + n)) + (0, 2 + n, 1, 3 + n)
    return blocks.transpose(perm).reshape(lead + (By * bs_y, Bx * bs_x))
