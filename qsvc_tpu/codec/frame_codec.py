"""Per-frame texture codec: DWT + quantization + EBCOT over code-blocks.

This is the framework's replacement for the reference's per-frame
``kdu_compress`` / ``kdu_expand`` calls (texture_compress_fb_j2k.py:183-196,
texture_expand_fb_j2k.py:152-177): DC level shift, ``SRLs-1``-level 2D DWT
(reversible integer 5/3 or irreversible CDF 9/7), deadzone quantization
(9/7 path), and EBCOT Tier-1 coding of each code-block with per-pass
rate/distortion recorded.  Every pass carries a distortion-length slope on
the block's convex hull, so quality-layer formation and bitstream
extraction are sorts/slices over recorded slopes instead of the reference's
decode-probe search (transcode.py:535-790).

The DWT runs on device (jit); Tier-1 runs on host — numpy reference here,
C++/OpenMP fast path via :mod:`.fast` when built.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import dwt2d
from . import bp_device, fast, subbands, tier1

#: slope-unit mapping: threshold T(u) = 2**((u - SLOPE_ANCHOR)/256), chosen
#: so the reference's useful 42000-46000 slope range spans the useful
#: distortion-per-byte range of 8-bit video (42000 ~ near-transparent,
#: 45000 ~ mid-rate, 46000 ~ very low rate; calibrated on 1080p content).
SLOPE_ANCHOR = 43500.0


def slope_to_threshold(u: float) -> float:
    return float(2.0 ** ((float(u) - SLOPE_ANCHOR) / 256.0))


def threshold_to_slope(t: float) -> float:
    if t <= 0:
        return 0.0
    return SLOPE_ANCHOR + 256.0 * math.log2(t)


@dataclass
class EncodedBlock:
    band_key: str
    level: int
    band: str
    y0: int
    x0: int
    shape: Tuple[int, int]
    msbs: int
    data: bytes
    pass_ends: List[int]
    pass_slopes: List[float]        # hull slope (weighted SSE per byte)

    @property
    def num_passes(self) -> int:
        return len(self.pass_ends)

    def truncate(self, threshold: float) -> "EncodedBlock":
        """Keep only passes whose hull slope >= threshold (no re-encode)."""
        n = 0
        for s in self.pass_slopes:
            if s >= threshold:
                n += 1
            else:
                break
        if n == len(self.pass_ends):
            return self                 # nothing cut (incl. empty blocks)
        end = self.pass_ends[n - 1] if n else 0
        return EncodedBlock(self.band_key, self.level, self.band, self.y0,
                            self.x0, self.shape, self.msbs, self.data[:end],
                            self.pass_ends[:n], self.pass_slopes[:n])

    def passes_for_threshold(self, threshold: float) -> int:
        n = 0
        for s in self.pass_slopes:
            if s >= threshold:
                n += 1
            else:
                break
        return n


@dataclass
class EncodedFrame:
    H: int
    W: int
    levels: int
    reversible: bool
    delta: float                     # base quantization step (9/7 path)
    codeblock_size: int
    blocks: List[EncodedBlock]
    coder: str = "mq"                # "mq" (spec MQ) | "bp" (bit-parallel)

    @property
    def total_bytes(self) -> int:
        return sum(len(b.data) for b in self.blocks)

    def truncate(self, threshold: float) -> "EncodedFrame":
        return EncodedFrame(self.H, self.W, self.levels, self.reversible,
                            self.delta, self.codeblock_size,
                            [b.truncate(threshold) for b in self.blocks],
                            self.coder)


@partial(jax.jit, static_argnames=("levels", "reversible"))
def _dwt_device(plane: jnp.ndarray, levels: int, reversible: bool):
    """Forward texture DWT; batches over any leading axes."""
    if reversible:
        return dwt2d.analyze(plane.astype(jnp.int32) - 128, levels, "5/3")
    return dwt2d.analyze(plane.astype(jnp.float32) - 128.0, levels, "9/7")


@partial(jax.jit, static_argnames=("levels", "reversible"))
def _dwt_quant16(plane: jnp.ndarray, levels: int, reversible: bool,
                 delta: jnp.ndarray):
    """Forward DWT + quantization fused on device, int16 output (halves the
    host transfer) plus an overflow flag for the rare int16-exceeding case."""
    if reversible:
        q = dwt2d.analyze(plane.astype(jnp.int32) - 128, levels, "5/3")
    else:
        c = dwt2d.analyze(plane.astype(jnp.float32) - 128.0, levels, "9/7")
        q = jnp.trunc(c / delta).astype(jnp.int32)
    q16 = q.astype(jnp.int16)
    overflow = jnp.any(q16.astype(jnp.int32) != q)
    return q16, overflow


@partial(jax.jit, static_argnames=("levels", "reversible"))
def _dwt_quant32(plane: jnp.ndarray, levels: int, reversible: bool,
                 delta: jnp.ndarray):
    if reversible:
        return dwt2d.analyze(plane.astype(jnp.int32) - 128, levels, "5/3")
    c = dwt2d.analyze(plane.astype(jnp.float32) - 128.0, levels, "9/7")
    return jnp.trunc(c / delta).astype(jnp.int32)


@partial(jax.jit, static_argnames=("levels", "reversible"))
def _dequant_idwt(q: jnp.ndarray, levels: int, reversible: bool,
                  delta: jnp.ndarray):
    """Dequantization + inverse DWT fused on device."""
    if reversible:
        rec = dwt2d.synthesize(q.astype(jnp.int32), levels, "5/3") + 128
        return jnp.clip(rec, 0, 255).astype(jnp.int32)
    v = q.astype(jnp.float32)
    v = (v + jnp.where(v > 0, 0.5, jnp.where(v < 0, -0.5, 0.0))) * delta
    rec = dwt2d.synthesize(v, levels, "9/7") + 128.0
    return jnp.clip(jnp.round(rec), 0, 255).astype(jnp.int32)


@partial(jax.jit, static_argnames=("levels", "reversible"))
def _idwt_device(packed: jnp.ndarray, levels: int, reversible: bool):
    if reversible:
        rec = dwt2d.synthesize(packed, levels, "5/3") + 128
    else:
        rec = dwt2d.synthesize(packed, levels, "9/7") + 128.0
    return jnp.clip(jnp.round(rec), 0, 255).astype(jnp.int32)


def _hull_slopes(pass_ends: Sequence[int], dists: Sequence[float],
                 dist0: float, weight: float) -> List[float]:
    """Convex-hull distortion-length slopes; non-hull passes inherit the
    slope of the hull segment that covers them (so threshold truncation is
    monotone and never cuts inside a hull segment)."""
    n = len(pass_ends)
    if n == 0:
        return []
    rates = [0] + list(pass_ends)
    dd = [dist0] + list(dists)
    # convex hull (lower envelope) over (rate, dist).  A pass that does not
    # strictly reduce distortion below the current hull top is dominated
    # (>= rate, >= dist) and is skipped — it must NOT pop the top, or a
    # flat pass after a steep one would discard the best truncation point.
    hull = [0]
    for i in range(1, n + 1):
        if dd[i] >= dd[hull[-1]]:
            continue
        while hull:
            j = hull[-1]
            if rates[i] <= rates[j]:
                if j == 0:          # keep the zero-rate origin vertex
                    break
                hull.pop()          # same or less rate, strictly less dist
                continue
            s_new = (dd[j] - dd[i]) / (rates[i] - rates[j])
            if len(hull) >= 2:
                k = hull[-2]
                s_old = (dd[k] - dd[j]) / max(rates[j] - rates[k], 1e-12)
                if s_new >= s_old:
                    hull.pop()
                    continue
            break
        hull.append(i)
    # slope per pass = hull-segment slope covering that pass
    slopes = [0.0] * n
    prev = hull[0]
    for idx in hull[1:]:
        s = (dd[prev] - dd[idx]) / max(rates[idx] - rates[prev], 1e-12)
        for p in range(prev, idx):
            slopes[p] = s * weight
        prev = idx
    for p in range(prev, n):
        slopes[p] = 0.0
    # enforce monotone non-increasing slopes (numerical safety)
    for p in range(1, n):
        if slopes[p] > slopes[p - 1]:
            slopes[p] = slopes[p - 1]
    return slopes


#: per-(H, W, levels, codeblock) tile template: (band, ty, tx, th, tw,
#: gain_rev, gain_irr) for one frame in layout order.
_TEMPLATE_CACHE: Dict[Tuple[int, int, int, int], List[Tuple]] = {}


def _tile_template(H: int, W: int, levels: int, cb: int) -> List[Tuple]:
    key = (H, W, levels, cb)
    tpl = _TEMPLATE_CACHE.get(key)
    if tpl is None:
        tpl = []
        for b in subbands.band_layout(H, W, levels):
            g_rev = subbands.band_gain(b.band, b.level, True)
            g_irr = subbands.band_gain(b.band, b.level, False)
            for (ty, tx, th, tw) in subbands.codeblock_tiles(b.h, b.w, cb):
                tpl.append((b, ty, tx, th, tw, g_rev, g_irr))
        _TEMPLATE_CACHE[key] = tpl
    return tpl


#: per-template empty EncodedBlock singletons: blocks are treated as
#: immutable everywhere, so the (overwhelmingly many) uncoded blocks of a
#: sparse frame can share one object per template slot instead of
#: constructing ~10^4 dataclasses per GOP on the host hot path.
_EMPTY_CACHE: Dict[Tuple[int, int, int, int], List["EncodedBlock"]] = {}


def _empty_blocks(H: int, W: int, levels: int, cb: int
                  ) -> List["EncodedBlock"]:
    key = (H, W, levels, cb)
    out = _EMPTY_CACHE.get(key)
    if out is None:
        out = [EncodedBlock(b.key, b.level, b.band, ty, tx, (th, tw),
                            0, b"", [], [])
               for (b, ty, tx, th, tw, _gr, _gi)
               in _tile_template(H, W, levels, cb)]
        _EMPTY_CACHE[key] = out
    return out


_DIMS_CACHE: Dict[Tuple[int, int, int, int], Tuple[np.ndarray, np.ndarray]] \
    = {}


def _tile_dims(H: int, W: int, levels: int, cb: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-template-tile true (th, tw) arrays for the device R-D sim."""
    key = (H, W, levels, cb)
    dims = _DIMS_CACHE.get(key)
    if dims is None:
        tpl = _tile_template(H, W, levels, cb)
        dims = (np.asarray([t[3] for t in tpl], np.int32),
                np.asarray([t[4] for t in tpl], np.int32))
        _DIMS_CACHE[key] = dims
    return dims


@partial(jax.jit, static_argnames=("levels", "reversible", "cb"))
def _dwt_quant_tiles(plane: jnp.ndarray, levels: int, reversible: bool,
                     delta: jnp.ndarray, cb: int):
    """Forward DWT + quantize + code-block tiling fused on device.

    Returns (tiles, maxabs, sse, overflow): ``tiles`` is (N, nb, cb, cb)
    int16 in band-layout/template order (edge tiles zero-padded), plus
    per-tile max magnitude and sum-of-squares so the host can decide which
    blocks will actually be coded before transferring them — only coded
    blocks cross the host link (the hot-path replacement for fetching the
    whole packed plane).
    """
    if reversible:
        q = dwt2d.analyze(plane.astype(jnp.int32) - 128, levels, "5/3")
    else:
        c = dwt2d.analyze(plane.astype(jnp.float32) - 128.0, levels, "9/7")
        q = jnp.trunc(c / delta).astype(jnp.int32)
    q16 = q.astype(jnp.int16)
    overflow = jnp.any(q16.astype(jnp.int32) != q)
    N, H, W = q16.shape
    parts = []
    for b in subbands.band_layout(H, W, levels):
        band = q16[:, b.y0:b.y0 + b.h, b.x0:b.x0 + b.w]
        nh, nw = -(-b.h // cb), -(-b.w // cb)
        band = jnp.pad(band, ((0, 0), (0, nh * cb - b.h),
                              (0, nw * cb - b.w)))
        parts.append(band.reshape(N, nh, cb, nw, cb)
                     .transpose(0, 1, 3, 2, 4).reshape(N, nh * nw, cb, cb))
    tiles = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    maxabs = jnp.abs(tiles.astype(jnp.int32)).max(axis=(2, 3))
    sse = jnp.sum(jnp.square(tiles.astype(jnp.float32)), axis=(2, 3))
    return tiles, maxabs, sse, overflow


@jax.jit
def _compact_tiles(tiles: jnp.ndarray, maxabs: jnp.ndarray,
                   smax: jnp.ndarray, ms: jnp.ndarray):
    """Device-side block selection + stable compaction.

    ``ms``: (N, nb) float32 per-tile slope floor (<= 0 disables).  Returns
    the full tile stack reordered with the kept tiles first (in ascending
    flat-index order, matching ``np.flatnonzero`` of the mask on host) and
    the boolean keep mask.  Doing this at dispatch time removes two host
    round trips per stack from the selection stage: the host never uploads
    an index array, it just fetches the mask with the stats and then the
    ``[:K]`` prefix."""
    N, nb, cb, _ = tiles.shape
    keep = (maxabs > 0) & (smax >= ms)
    order = jnp.argsort(jnp.where(keep, 0, 1).ravel(), stable=True)
    compact = tiles.reshape(N * nb, cb, cb)[order]
    return compact, keep


def _slope_floor(min_threshold, N: int, nb: int, tpl, reversible: bool,
                 delta: float, coder: str) -> np.ndarray:
    """(N, nb) float32 floor on the device smax for block selection.

    A block is kept iff its maximum achievable weighted slope (the first
    segment of its R-D hull, computed exactly on device for the bp coder)
    reaches the truncation threshold.  For the spec-MQ coder the bp byte
    counts are an upper bound on the MQ rate, so the criterion is relaxed
    by the MQ coder's plausible compaction margin (strictly conservative;
    MQ typically compacts the raw bp bits 2-4x, 32x margin is safe —
    pinned by test_sparse_selection_never_drops_surviving_blocks)."""
    thr = np.broadcast_to(np.asarray(min_threshold, np.float64), (N,))
    if not np.any(thr > 0):
        return np.zeros((N, nb), np.float32)
    margin = 1.0 if coder == "bp" else 32.0
    wts = np.empty(nb, np.float64)
    for i, (b, ty, tx, th, tw, g_rev, g_irr) in enumerate(tpl):
        wts[i] = g_rev if reversible else g_irr * float(delta) * float(delta)
    return (thr[:, None] / wts[None, :] / margin).astype(np.float32)


def encode_frames_dispatch_sparse(planes, levels: int, reversible: bool,
                                  delta: float, codeblock_size: int,
                                  min_threshold=0.0, coder: str = "bp"):
    """Stage 1 (sparse path): fused device DWT+quantize+tile, non-blocking.

    Also dispatches the device-side bp R-D simulation
    (:func:`bp_device.bp_max_slope`) and the threshold-driven block
    selection + compaction (:func:`_compact_tiles`), so the selection
    stage only fetches the tiny keep mask and the compact prefix — no
    coefficient and no index array crosses the host link for blocks that
    cannot survive truncation."""
    d = jnp.float32(delta)
    pl = jnp.asarray(planes)
    cb = codeblock_size
    tiles, maxabs, sse, ovf = _dwt_quant_tiles(pl, levels, reversible, d, cb)
    N, nb = tiles.shape[0], tiles.shape[1]
    H, W = pl.shape[1], pl.shape[2]
    th, tw = _tile_dims(H, W, levels, cb)
    smax, _d0 = bp_device.bp_max_slope(
        tiles.reshape(N * nb, cb, cb),
        jnp.asarray(np.tile(th, N)), jnp.asarray(np.tile(tw, N)))
    tpl = _tile_template(H, W, levels, cb)
    ms = _slope_floor(min_threshold, N, nb, tpl, reversible, float(delta),
                      coder)
    compact, keep = _compact_tiles(tiles, maxabs, smax.reshape(N, nb),
                                   jnp.asarray(ms))
    # store delta as a python float: a device scalar here would cost the
    # select stage a blocking round trip per stack (float(jax_scalar))
    return (pl, compact, maxabs, keep, ovf, levels, reversible,
            float(delta), cb)


def encode_frames_select_sparse(pending, min_threshold, coder: str = "bp",
                                stats=None):
    """Stage 2: fetch the tiny per-tile stats and slice the compact prefix.

    The selection itself already happened on device at dispatch time (see
    :func:`_compact_tiles`); this stage turns the fetched keep mask into
    host bookkeeping and dispatches the ``[:K]`` prefix slice.

    ``min_threshold`` is kept for signature compatibility (the floor was
    applied at dispatch).  ``stats``: optionally the already-fetched host
    values of ``(maxabs, keep, ovf)`` — the pipelined caller batches those
    fetches across stacks into one round trip.
    """
    (pl, compact, maxabs, keep, ovf, levels, reversible, d, cb) = pending
    if stats is None:
        maxabs_h, keep_h, ovf_h = jax.device_get((maxabs, keep, ovf))
    else:
        maxabs_h, keep_h, ovf_h = stats
    if bool(ovf_h):
        return ("packed", np.asarray(_dwt_quant32(pl, levels, reversible, d)),
                None, None, levels, reversible, float(d), cb)
    N, nb = maxabs_h.shape
    flat_idx = np.flatnonzero(keep_h.ravel()).astype(np.int32)
    # bucket the prefix-slice length: a raw [:k] would compile one XLA
    # slice program per distinct survivor count (one per stack per GOP,
    # forever); bucketing reuses a handful of programs — and the
    # zero-filled prewarm GOP compiles the same ones the first real GOP
    # uses (cold start).  finish trims to k on host.
    kb = min(_bucket(max(len(flat_idx), 1)), compact.shape[0])
    return ("sparse", compact[:kb], flat_idx, (N, nb, maxabs_h),
            levels, reversible, float(d), cb)


def encode_frames_finish_sparse(selected, H: int, W: int,
                                min_threshold, coder: str
                                ) -> List[EncodedFrame]:
    """Stage 3: fetch compact tiles, run the native coder on them only.

    ``min_threshold``: scalar or per-frame (N,) array (see select stage).
    """
    (mode, data, flat_idx, stats, levels, reversible, delta, cb) = selected
    if mode == "packed":
        return encode_frames_host(data, levels, reversible, delta, cb,
                                  min_threshold, coder)
    # (kb, cb, cb) int16; trim the bucketed prefix to the true count
    compact = np.asarray(data)[:len(flat_idx)]
    N, nb, maxabs_h = stats
    thr = np.broadcast_to(np.asarray(min_threshold, np.float64), (N,))
    any_thr = bool(np.any(thr > 0))
    tpl = _tile_template(H, W, levels, cb)
    K = compact.shape[0]
    tiles_meta: List[Tuple] = []
    bands: List[str] = []
    min_slopes: List[float] = []
    metas: List[Tuple] = []
    for k, fi in enumerate(flat_idx):
        n, ti = divmod(int(fi), nb)
        (b, ty, tx, th, tw, g_rev, g_irr) = tpl[ti]
        w = g_rev if reversible else g_irr * delta * delta
        tiles_meta.append((k, 0, 0, th, tw))
        bands.append(b.band)
        min_slopes.append(thr[n] / w / 8.0 if thr[n] > 0 else 0.0)
        metas.append((n, b, ty, tx, th, tw, w))
    encoded = fast.encode_packed_planes(
        compact, tiles_meta, bands,
        min_slopes if any_thr else None, coder=coder)
    per_frame: List[List[EncodedBlock]] = [[] for _ in range(N)]
    coded = {}
    for cbk, (n, b, ty, tx, th, tw, w) in zip(encoded, metas):
        slopes = _hull_slopes(cbk.pass_ends, cbk.pass_dist, cbk.dist0, w)
        coded[(n, b.key, ty, tx)] = EncodedBlock(
            b.key, b.level, b.band, ty, tx, (th, tw), cbk.msbs,
            cbk.data, cbk.pass_ends, slopes)
    empties = _empty_blocks(H, W, levels, cb)
    for n in range(N):
        for ti, (b, ty, tx, th, tw, g_rev, g_irr) in enumerate(tpl):
            blk = coded.get((n, b.key, ty, tx))
            per_frame[n].append(empties[ti] if blk is None else blk)
    return [EncodedFrame(H, W, levels, reversible, delta, cb, blocks, coder)
            for blocks in per_frame]


def encode_frames_dispatch(planes, levels: int, reversible: bool,
                           delta: float):
    """Stage 1: dispatch the fused device DWT+quantize (non-blocking).

    Returns an opaque pending handle for :func:`encode_frames_fetch`.
    Dispatching every stack before fetching any lets the device pipeline
    all transforms while the host drains transfers."""
    d = jnp.float32(delta)
    pl = jnp.asarray(planes)
    q16, ovf = _dwt_quant16(pl, levels, reversible, d)
    return (pl, q16, ovf, levels, reversible, d)


def encode_frames_fetch(pending) -> np.ndarray:
    """Stage 2: pull the quantized int16 planes to host (transfer-bound)."""
    pl, q16, ovf, levels, reversible, d = pending
    if bool(ovf):
        return np.asarray(_dwt_quant32(pl, levels, reversible, d))
    return np.asarray(q16)


def encode_frames_host(packed_all: np.ndarray, levels: int, reversible: bool,
                       delta: float, codeblock_size: int,
                       min_threshold, coder: str
                       ) -> List[EncodedFrame]:
    """Stage 3: native entropy coding of fetched planes (CPU-bound)."""
    N, H, W = packed_all.shape
    thr = np.broadcast_to(np.asarray(min_threshold, np.float64), (N,))
    any_thr = bool(np.any(thr > 0))
    tpl = _tile_template(H, W, levels, codeblock_size)
    tiles_meta: List[Tuple] = []
    bands: List[str] = []
    meta: List[Tuple] = []
    min_slopes: List[float] = []
    for n in range(N):
        for (b, ty, tx, th, tw, g_rev, g_irr) in tpl:
            w = g_rev if reversible else g_irr * delta * delta
            tiles_meta.append((n, b.y0 + ty, b.x0 + tx, th, tw))
            bands.append(b.band)
            meta.append((n, b, ty, tx, th, tw, w))
            min_slopes.append(thr[n] / w / 8.0 if thr[n] > 0 else 0.0)
    encoded = fast.encode_packed_planes(packed_all, tiles_meta, bands,
                                        min_slopes if any_thr
                                        else None, coder=coder)
    per_frame: List[List[EncodedBlock]] = [[] for _ in range(N)]
    for cb, (n, b, ty, tx, th, tw, w) in zip(encoded, meta):
        slopes = _hull_slopes(cb.pass_ends, cb.pass_dist, cb.dist0, w)
        per_frame[n].append(EncodedBlock(
            b.key, b.level, b.band, ty, tx, (th, tw), cb.msbs,
            cb.data, cb.pass_ends, slopes))
    return [EncodedFrame(H, W, levels, reversible, delta, codeblock_size,
                         blocks, coder) for blocks in per_frame]


def encode_frames(planes, levels: int, reversible: bool = True,
                  delta: float = 0.125, codeblock_size: int = 64,
                  min_threshold: float = 0.0, coder: str = "mq"
                  ) -> List[EncodedFrame]:
    """Encode a stack of component planes (N, H, W): ONE fused device
    DWT+quantize call (int16 transfer), ONE native strided batch over all
    code-blocks of all frames — the production path.

    ``planes`` may be a device array (preferred: MCTF outputs then never
    round-trip through the host) or a numpy array.  This is the serial
    convenience wrapper; the pipelined path in :mod:`..api` overlaps
    device compute, host transfers and native coding across stacks via
    the dispatch/fetch/host stages.
    """
    pending = encode_frames_dispatch_sparse(planes, levels, reversible,
                                            delta, codeblock_size,
                                            min_threshold, coder)
    H, W = pending[0].shape[1], pending[0].shape[2]
    selected = encode_frames_select_sparse(pending, min_threshold, coder)
    return encode_frames_finish_sparse(selected, H, W, min_threshold, coder)


@partial(jax.jit, static_argnames=("N", "H", "W"))
def _scatter_tiles(tiles: jnp.ndarray, pos: jnp.ndarray,
                   N: int, H: int, W: int) -> jnp.ndarray:
    """Scatter decoded (K, cb, cb) code-block tiles into a zero
    (N, H, W) packed plane stack on device.  Out-of-bounds elements
    (padding rows of edge tiles past the plane, and the dummy rows used
    to bucket K) are dropped; in-bounds zero padding lands in
    neighbouring bands as ``+= 0``."""
    K, cb, _ = tiles.shape
    ar = jnp.arange(cb)
    iN = jnp.broadcast_to(pos[:, 0, None, None], (K, cb, cb))
    iY = pos[:, 1, None, None] + ar[None, :, None]
    iX = pos[:, 2, None, None] + ar[None, None, :]
    packed = jnp.zeros((N, H, W), tiles.dtype)
    return packed.at[iN, iY, iX].add(tiles, mode="drop")


def _bucket(k: int, floor: int = 32) -> int:
    """Round K up so the dependent program compiles for a small ladder
    of shapes (powers of two above a floor).  The floor keeps the
    ladder short; the power-of-two steps keep padded transfer overhead
    < 2x (padding rows are real bytes on the host<->device link)."""
    n = floor
    while n < k:
        n <<= 1
    return n


def decode_frames(efs: List[EncodedFrame], threshold: float = 0.0,
                  discard_levels: int = 0, to_host: bool = True):
    """Decode a stack of same-geometry frames with ONE native batch
    entropy decode and ONE fused device dequantize+inverse-DWT call;
    returns (N, H', W').

    The coefficients cross the host->device link SPARSELY: only the
    coded code-block tiles are uploaded and scattered into the packed
    plane stack on device (at lossy operating points the packed planes
    are ~99% zeros: 140 MB/GOP at 1080p densely vs a few MB of
    surviving tiles).

    ``to_host=False`` returns the decoded stack as a DEVICE array — the
    inverse MCTF consumes it directly, avoiding a download+re-upload
    round trip per subband (api.expand uses this)."""
    if not efs:
        return np.zeros((0, 0, 0), np.int32)
    from ..utils import trace
    ef0 = efs[0]
    H, W, levels = ef0.H, ef0.W, ef0.levels
    layout = subbands.band_layout(H, W, levels)
    by_key = {}
    for b in layout:
        by_key.setdefault(b.key, b)
    todo = []
    positions = []
    with trace.stage("decode.todo"):
        for n, ef in enumerate(efs):
            for blk in ef.blocks:
                if blk.level <= discard_levels and blk.band != "LL":
                    continue
                np_ = (blk.num_passes if threshold <= 0
                       else blk.passes_for_threshold(threshold))
                if np_ == 0 or not blk.data:
                    continue        # decodes to zeros: nothing to do
                todo.append((blk.data, blk.msbs, np_, blk.shape, blk.band,
                             blk.pass_ends))
                b = by_key[blk.band_key]
                positions.append((n, b.y0 + blk.y0, b.x0 + blk.x0))

    cb = max((max(b[3]) for b in todo), default=1)
    coded_area = sum(b[3][0] * b[3][1] for b in todo)
    use_sparse = coded_area * 2 < len(efs) * H * W

    d = jnp.float32(ef0.delta)
    sizes_y = dwt2d._level_sizes(H, discard_levels or 0)
    sizes_x = dwt2d._level_sizes(W, discard_levels or 0)
    Hd = sizes_y[-1] if discard_levels else H
    Wd = sizes_x[-1] if discard_levels else W

    if use_sparse:
        with trace.stage("decode.native", blocks=len(todo)):
            if ef0.coder == "bp":
                if not fast.available():
                    # mirror decode_packed_planes' guard: the pure-python
                    # fallback is the tier1 MQ decoder, which would
                    # silently mis-decode bp data into garbage pixels.
                    raise RuntimeError(
                        "bp coder requires the native library: "
                        "build qsvc_tpu/native (fast.build())")
                tiles = fast.bp_decode_tiles([(b[0], b[1], b[2], b[3])
                                              for b in todo])
            else:
                tiles = fast.decode_codeblocks_batch(todo)
        with trace.stage("decode.pack"):
            K = _bucket(max(len(tiles), 1))
            vmax = max((int(np.abs(t).max()) for t in tiles if t.size),
                       default=0)
            dt = np.int16 if vmax < 32768 else np.int32
            # bucketed tile extent: sizing by the exact max CODED tile
            # (data-dependent) compiled a fresh scatter program per
            # content (observed (256,1,1), (256,60,60), an 8 s compile
            # mid-measurement); a power-of-two ladder capped at the
            # codeblock size bounds the program set while keeping the
            # upload proportional to the coded area
            cb = min(_bucket(cb, 8), ef0.codeblock_size)
            tile_arr = np.zeros((K, cb, cb), dt)
            pos = np.full((K, 3), (0, Hd, Wd), np.int32)  # dummies: OOB
            for i, ((n, y0, x0), b, t) in enumerate(zip(positions, todo,
                                                        tiles)):
                th, tw = b[3]
                tile_arr[i, :th, :tw] = t
                pos[i] = (n, y0, x0)
        with trace.stage("decode.dispatch", tiles=len(todo), K=K):
            packed_dev = _scatter_tiles(jnp.asarray(tile_arr),
                                        jnp.asarray(pos), len(efs), Hd, Wd)
    else:
        with trace.stage("decode.native", blocks=len(todo), dense=True):
            packed = np.zeros((len(efs), H, W), np.int32)
            fast.decode_packed_planes(todo, positions, packed,
                                      coder=ef0.coder)
        with trace.stage("decode.dispatch"):
            if discard_levels:
                packed = packed[:, :Hd, :Wd]
            packed_dev = _to_device_small(np.ascontiguousarray(packed))

    with trace.stage("decode.idwt_dispatch"):
        out = _dequant_idwt(packed_dev, levels - (discard_levels or 0),
                            ef0.reversible, d)
    if to_host:
        with trace.stage("decode.fetch"):
            return np.asarray(out)
    return out


def _to_device_small(packed: np.ndarray) -> jnp.ndarray:
    """Upload int16 when values fit (halves the host->device transfer)."""
    p16 = packed.astype(np.int16)
    if np.array_equal(p16, packed):
        return jnp.asarray(p16)
    return jnp.asarray(packed)


def encode_frame(plane: np.ndarray, levels: int, reversible: bool = True,
                 delta: float = 0.125, codeblock_size: int = 64,
                 min_threshold: float = 0.0, coder: str = "mq"
                 ) -> EncodedFrame:
    """Encode one component plane (uint8-range values).

    ``min_threshold``: weighted-slope floor — planes whose distortion-length
    slope falls well below it are never coded (they cannot survive
    truncation at that threshold), which skips most deep bit-planes at
    lossy operating points."""
    return encode_frames(np.asarray(plane)[None], levels, reversible, delta,
                         codeblock_size, min_threshold, coder)[0]


def decode_frame(ef: EncodedFrame,
                 threshold: float = 0.0,
                 discard_levels: int = 0) -> np.ndarray:
    """Decode a frame, optionally truncating by slope threshold (QS) and
    discarding the finest ``discard_levels`` resolution levels (SS — the
    reference's ``-reduce`` / ``--discard_SRLs``, transcode.py:558-582).

    With ``discard_levels = d`` the returned plane has the dimensions of the
    d-times-reduced image (the LL_d band geometry).
    """
    return decode_frames([ef], threshold, discard_levels)[0]
