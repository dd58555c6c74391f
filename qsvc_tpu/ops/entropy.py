"""Shannon entropy of a 256-bin histogram (reference entropy.cpp:19-33).

Drives the adaptive I/B frame decision (decorrelate.cpp:934-1027).  Computed
on device: a bincount + masked p*log2(p) reduction, float32 like the
reference's ``float`` accumulation.
"""

from __future__ import annotations

import jax.numpy as jnp


def histogram_entropy(values: jnp.ndarray, bins: int = 256) -> jnp.ndarray:
    """Entropy (bits/symbol) of the histogram of integer ``values``.

    Values are assumed to lie in [0, bins) (the callers clip/bias first,
    matching the reference's uint8/biased inputs).  The histogram is a
    compare-and-reduce over a broadcast (bins, pixels) equality: a fused
    reduction with no scatter, deterministic on every backend.
    """
    flat = values.reshape(1, -1).astype(jnp.int32)
    idx = jnp.arange(bins, dtype=jnp.int32).reshape(-1, 1)
    count = jnp.sum((idx == flat).astype(jnp.int32), axis=1)
    total = jnp.sum(count)
    p = count.astype(jnp.float32) / total.astype(jnp.float32)
    terms = jnp.where(count > 0, p * jnp.log2(p), 0.0)
    return -jnp.sum(terms)
