"""Motion-vector field decorrelation across temporal levels.

Re-creates the reference's motion compression front end
(``motion_compress.py:146-180``):

* **inter-level decorrelation** (``interlevel_motion_decorrelate.cpp:40-69``):
  each motion field at level ``t`` is predicted by half the co-located field
  of the coarser level ``t+1`` — two consecutive finer fields share one
  coarser reference (pair ``i`` maps to coarse pair ``i // 2``); residue =
  ``field - coarse/2`` with C truncating division;
* **bidirectional decorrelation** at the coarsest level
  (``bidirectional_motion_decorrelate.cpp:34-43``): ``NEXT -= PREV``
  (linear-motion prior).

Where block grids differ between levels (block size halves per level until
``block_size_min``, analyze.py:149-151), the coarser field is expanded to
the finer grid by nearest-neighbour duplication — the same packed-Haar
upsampling convention used inside the hierarchical ME.  The reference
passes mismatched grid dims through unchanged (a latent bug); the clean
mapping here is invertible by construction.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..ops.lifting import tdiv


def _expand_to(coarse: jnp.ndarray, By: int, Bx: int) -> jnp.ndarray:
    """NN-duplicate a (..., by, bx) field onto a (..., By, Bx) grid."""
    by, bx = coarse.shape[-2], coarse.shape[-1]
    if (by, bx) == (By, Bx):
        return coarse
    ry, rx = -(-By // by), -(-Bx // bx)
    up = jnp.repeat(jnp.repeat(coarse, ry, axis=-2), rx, axis=-1)
    return up[..., :By, :Bx]


def decorrelate(fields: Sequence[jnp.ndarray]) -> List[jnp.ndarray]:
    """Forward MV decorrelation.

    ``fields[t]``: (P_t, 2, 2, By_t, Bx_t) for levels t = 0 .. L-1 (finest
    first, matching MCTFStream.levels).  Returns residue fields of the same
    shapes.
    """
    L = len(fields)
    out: List[jnp.ndarray] = []
    for t in range(L - 1):
        fine = fields[t]
        coarse = fields[t + 1]
        P, _, _, By, Bx = fine.shape
        ref = coarse[jnp.arange(P) // 2]        # shared coarser reference
        ref = _expand_to(ref, By, Bx)
        out.append(fine - tdiv(ref, 2))
    coarsest = fields[L - 1]
    # NEXT -= PREV at the coarsest level
    res = coarsest.at[:, 1].add(-coarsest[:, 0])
    out.append(res)
    return out


def correlate(residues: Sequence[jnp.ndarray]) -> List[jnp.ndarray]:
    """Inverse of :func:`decorrelate` (coarsest reconstructed first)."""
    L = len(residues)
    fields: List[jnp.ndarray] = [None] * L
    coarsest = residues[L - 1]
    fields[L - 1] = coarsest.at[:, 1].add(coarsest[:, 0])
    for t in range(L - 2, -1, -1):
        res = residues[t]
        P, _, _, By, Bx = res.shape
        ref = fields[t + 1][jnp.arange(P) // 2]
        ref = _expand_to(ref, By, Bx)
        fields[t] = res + tdiv(ref, 2)
    return fields


# Jitted entry points: motion fields are small, but eagerly dispatching the
# individual ops above costs one device dispatch each; one jitted call per
# level-list shape amortizes everything.
decorrelate_jit = jax.jit(decorrelate)
correlate_jit = jax.jit(correlate)
