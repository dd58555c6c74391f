"""Device mesh construction and GOP sharding.

The reference has no distribution at all (SURVEY.md §2.4) — its GOPs are
independent units processed sequentially.  Here GOPs are the data-parallel
axis of a ``jax.sharding.Mesh``: the sequence ``GOPs*S+1`` frames is
reshaped to ``(GOPs, S+1, ...)`` with the shared boundary frame duplicated
(the open-GOP rule, GOP.py:22-23 / analyze.py:110-112), sharded over the
``gop`` axis, and the only cross-device traffic is the boundary frame's
MCTF update halo (see :mod:`.transform`), exchanged with ``ppermute``.
The mesh is 1D: the GPUs of one host are joined all to all, so no device
order is closer than another.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CodecConfig


def make_mesh(n_devices: Optional[int] = None, axis: str = "gop") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_gops(x: np.ndarray, gop_size: int) -> np.ndarray:
    """(G*S+1, ...) frames -> (G, S+1, ...) with duplicated boundaries."""
    P_ = x.shape[0]
    G = (P_ - 1) // gop_size
    idx = np.arange(G)[:, None] * gop_size + np.arange(gop_size + 1)[None, :]
    return np.asarray(x)[idx]


def unshard_gops(x: np.ndarray) -> np.ndarray:
    """(G, k+1, ...) per-GOP frames -> (G*k+1, ...) dropping duplicate
    boundaries (the last frame of GOP g equals the first of GOP g+1)."""
    G, k1 = x.shape[0], x.shape[1]
    head = x[:, :-1].reshape((G * (k1 - 1),) + x.shape[2:])
    return np.concatenate([head, x[-1:, -1]], axis=0)


def put_sharded(x: np.ndarray, mesh: Mesh, axis: str = "gop"):
    """Place a (G, ...) array with the leading axis sharded over the mesh."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))
