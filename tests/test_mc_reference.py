"""MCTF motion stages against independent numpy references.

Each stage's array formulation (block-patch gathers, inverse-gather
update, batched spiral SADs) is checked against the per-pixel definition
it replaces: edge-replicating reads, a scatter-add, a brute-force spiral
search.  These are the semantics any faster kernel must keep."""

import numpy as np
import pytest

import jax.numpy as jnp

from qsvc_tpu.mctf import me, predict, update


def _block_map(mv, bs, H, W):
    """(..., By, Bx) block field -> (..., H, W) per-pixel field."""
    return np.repeat(np.repeat(mv, bs, axis=-2), bs, axis=-1)[..., :H, :W]


def _predict_ref(refs_p, refs_n, mv, bs):
    """Per-pixel bidirectional prediction with edge-replicated reads."""
    P, C, H, W = refs_p.shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = np.empty(refs_p.shape, np.int64)
    for p in range(P):
        src = []
        for d, ref in enumerate((refs_p[p], refs_n[p])):
            my = _block_map(mv[p, d, 0], bs, H, W)
            mx = _block_map(mv[p, d, 1], bs, H, W)
            ys = np.clip(yy + my, 0, H - 1)
            xs = np.clip(xx + mx, 0, W - 1)
            src.append(ref[:, ys, xs].astype(np.int64))
        out[p] = np.clip((src[0] + src[1]) // 2, 0, 255)
    return out


@pytest.mark.parametrize("case", ["random", "extreme_corners", "odd_width"])
def test_predict_frames_batch_matches_pixel_loop(case):
    rng = np.random.default_rng(11)
    bs, sr = 16, 4
    H, W = (64, 256) if case != "odd_width" else (48, 176)
    P, By, Bx = 2, H // bs, W // bs
    refs_p = rng.integers(0, 256, (P, 3, H, W)).astype(np.int16)
    refs_n = rng.integers(0, 256, (P, 3, H, W)).astype(np.int16)
    if case == "extreme_corners":
        # |mv| == search_range, pointing out of the frame at every edge
        sy = np.where(np.arange(By) < By // 2, -sr, sr)[:, None]
        sx = np.where(np.arange(Bx) < Bx // 2, -sr, sr)[None, :]
        one = np.stack([np.broadcast_to(sy, (By, Bx)),
                        np.broadcast_to(sx, (By, Bx))])
        mv = np.broadcast_to(np.stack([one, -one]), (P, 2, 2, By, Bx))
        mv = np.ascontiguousarray(mv, np.int32)
    else:
        mv = rng.integers(-sr, sr + 1, (P, 2, 2, By, Bx)).astype(np.int32)
    got = predict.predict_frames_batch(jnp.asarray(refs_p),
                                       jnp.asarray(refs_n),
                                       jnp.asarray(mv), bs, sr)
    np.testing.assert_array_equal(np.asarray(got),
                                  _predict_ref(refs_p, refs_n, mv, bs))


def _update_ref(res, mv_y, mv_x, bs, factor):
    """Scatter-add of floor(res * factor) from each source pixel to its
    motion-shifted destination; destinations outside the frame drop."""
    C, H, W = res.shape
    contrib = np.floor(res.astype(np.float32)
                       * np.float32(factor)).astype(np.int64)
    out = np.zeros((C, H, W), np.int64)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dy = yy + _block_map(mv_y, bs, H, W)
    dx = xx + _block_map(mv_x, bs, H, W)
    ok = (dy >= 0) & (dy < H) & (dx >= 0) & (dx < W)
    for c in range(C):
        np.add.at(out[c], (dy[ok], dx[ok]), contrib[c][ok])
    return out


@pytest.mark.parametrize("bs,sr,extreme", [(16, 4, False), (8, 16, False),
                                           (16, 16, True)])
def test_update_fields_batch2_matches_scatter_add(bs, sr, extreme):
    rng = np.random.default_rng(bs + sr)
    P, H, W = 2, 64, 96
    By, Bx = H // bs, W // bs
    res = rng.integers(-128, 128, (P, 3, H, W)).astype(np.int16)
    if extreme:             # |mv| == block_size: the K=1 reach boundary
        mv = np.where(rng.random((P, 2, 2, By, Bx)) < 0.5, -bs, bs)
    else:
        mv = rng.integers(-sr, sr + 1, (P, 2, 2, By, Bx))
    mv = mv.astype(np.int32)
    up, un = update.update_fields_batch2(jnp.asarray(res), jnp.asarray(mv),
                                         bs, 0.25, sr)
    for p in range(P):
        for d, got in enumerate((up, un)):
            want = _update_ref(res[p], mv[p, d, 0], mv[p, d, 1], bs, 0.25)
            np.testing.assert_array_equal(np.asarray(got[p]), want)


def _refine_ref(pred, prev, nxt, mv, bs, ny, nx):
    """Brute-force ±1 spiral: clamped reads of the active (ny, nx) region,
    PREV probed at +d and NEXT at -d, the later probe winning ties."""
    By, Bx = mv.shape[-2], mv.shape[-1]
    out = mv.copy()

    def window(img, y0, x0):
        ys = np.clip(np.arange(y0, y0 + bs), 0, ny - 1)
        xs = np.clip(np.arange(x0, x0 + bs), 0, nx - 1)
        return img[np.ix_(ys, xs)].astype(np.int64)

    for by in range(By):
        for bx in range(Bx):
            base = window(pred, by * bs, bx * bs)
            for d, (ref, sign) in enumerate(((prev, 1), (nxt, -1))):
                best, best_d = None, (0, 0)
                for dy, dx in me.SPIRAL:
                    oy = by * bs + mv[d, 0, by, bx] + sign * dy
                    ox = bx * bs + mv[d, 1, by, bx] + sign * dx
                    err = np.abs(base - window(ref, oy, ox)).sum()
                    if best is None or err <= best:
                        best, best_d = err, (sign * dy, sign * dx)
                out[d, 0, by, bx] += best_d[0]
                out[d, 1, by, bx] += best_d[1]
    return out


@pytest.mark.parametrize("odd_region", [False, True])
def test_refine_level_batch_matches_brute_force(odd_region):
    rng = np.random.default_rng(5)
    P, H, W, bs, sr = 2, 64, 96, 16, 4
    ny, nx = (H - 10, W - 20) if odd_region else (H, W)
    By, Bx = H // bs, W // bs
    pred, prev, nxt = (rng.integers(0, 256, (P, H, W)).astype(np.int16)
                       for _ in range(3))
    mv = rng.integers(-sr, sr + 1, (P, 2, 2, By, Bx)).astype(np.int32)
    got = me._refine_level_batch(jnp.asarray(pred), jnp.asarray(prev),
                                 jnp.asarray(nxt), jnp.asarray(mv), bs, 0,
                                 ny, nx, sr)
    for p in range(P):
        np.testing.assert_array_equal(
            np.asarray(got[p]),
            _refine_ref(pred[p], prev[p], nxt[p], mv[p], bs, ny, nx))
