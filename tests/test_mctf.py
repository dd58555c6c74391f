"""MCTF temporal transform: round-trip reconstruction, I/B decisions,
motion estimation sanity, MV decorrelation losslessness."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qsvc_tpu.config import CodecConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.mctf import me, motion_coding, transform


def _video_arrays(frames, h, w, kind="moving", seed=3):
    vid = synthetic_video(frames, h, w, seed=seed, kind=kind)
    return (jnp.asarray(vid.y.astype(np.int32)),
            jnp.asarray(vid.u.astype(np.int32)),
            jnp.asarray(vid.v.astype(np.int32)))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, dtype=np.float64)
                   - np.asarray(b, dtype=np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else np.inf


def test_me_finds_global_translation():
    # frame pair shifted by a known even vector -> ME recovers it exactly
    # (even shifts commute with the pyramid downsampling in the interior;
    # odd shifts are only found to ±1, as in the reference's FAST_SEARCH)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (80, 96)).astype(np.int32)
    base = jnp.asarray(base)
    dy, dx = 2, -2
    shifted = jnp.roll(jnp.roll(base, -dy, axis=0), -dx, axis=1)
    # pred[y,x] should equal ref[y+dy, x+dx]; search both directions
    mv = me.estimate_pair(shifted, base, base, block_size=16, search_range=4)
    mv = np.asarray(mv)
    # interior blocks (avoid wrap-around edges of jnp.roll)
    inner = mv[:, :, 1:-1, 1:-1]
    assert (inner[0, 0] == dy).all() and (inner[0, 1] == dx).all(), inner[0]
    assert (inner[1, 0] == dy).all() and (inner[1, 1] == dx).all(), inner[1]


def test_mctf_roundtrip_lossless_without_update():
    cfg = CodecConfig(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=1,
                      block_size=16, search_range=4, update_factor=0.0)
    y, u, v = _video_arrays(cfg.pictures, 80, 96)
    stream = transform.analyze(y, u, v, cfg)
    ry, ru, rv = transform.synthesize(stream, cfg)
    np.testing.assert_array_equal(np.asarray(ry), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(ru), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(rv), np.asarray(v))


def test_mctf_roundtrip_with_update_near_lossless():
    cfg = CodecConfig(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=1,
                      block_size=16, search_range=4, update_factor=0.25)
    y, u, v = _video_arrays(cfg.pictures, 80, 96)
    stream = transform.analyze(y, u, v, cfg)
    ry, ru, rv = transform.synthesize(stream, cfg)
    # update step is not exactly invertible (trunc+clamp, like the
    # reference); reconstruction must still be visually transparent
    assert _psnr(ry, y) > 45, _psnr(ry, y)
    assert _psnr(ru, u) > 45
    assert _psnr(rv, v) > 45


def test_mctf_shapes_and_frame_types():
    cfg = CodecConfig(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=2,
                      block_size=16, search_range=4, update_factor=0.0)
    y, u, v = _video_arrays(cfg.pictures, 80, 96)
    assert cfg.pictures == 9
    stream = transform.analyze(y, u, v, cfg)
    assert len(stream.levels) == 2
    assert stream.levels[0].high_y.shape == (4, 80, 96)
    assert stream.levels[1].high_y.shape == (2, 80, 96)
    assert stream.low_y.shape == (3, 80, 96)
    assert stream.levels[0].mv.shape[0] == 4
    # moving content should pick B frames (prediction helps)
    assert bool(np.asarray(stream.levels[0].is_B).any())


def test_unpredictable_low_entropy_frame_picks_I():
    # flat odd frame between random evens: storing the frame itself (zero
    # entropy) beats the high-entropy residue -> I decision, zeroed motion
    cfg = CodecConfig(pixels_in_x=96, pixels_in_y=80, TRLs=2, GOPs=1,
                      block_size=16, search_range=4, update_factor=0.0)
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (3, 80, 96)).astype(np.int32)
    u = rng.integers(0, 256, (3, 40, 48)).astype(np.int32)
    v = rng.integers(0, 256, (3, 40, 48)).astype(np.int32)
    y[1] = 128; u[1] = 128; v[1] = 128   # flat odd frame
    stream = transform.analyze(jnp.asarray(y), jnp.asarray(u),
                               jnp.asarray(v), cfg)
    assert not bool(np.asarray(stream.levels[0].is_B).any())
    assert (np.asarray(stream.levels[0].mv) == 0).all()
    # I-frame high band stores the odd frame unchanged
    np.testing.assert_array_equal(np.asarray(stream.levels[0].high_y[0]), y[1])
    # and decodes losslessly
    ry, ru, rv = transform.synthesize(stream, cfg)
    np.testing.assert_array_equal(np.asarray(ry), y)


def test_mv_decorrelate_roundtrip(rng):
    fields = []
    shapes = [(8, 2, 2, 6, 8), (4, 2, 2, 6, 8), (2, 2, 2, 3, 4)]
    for s in shapes:
        fields.append(jnp.asarray(
            rng.integers(-64, 65, size=s, dtype=np.int32)))
    res = motion_coding.decorrelate(fields)
    rec = motion_coding.correlate(res)
    for f, r in zip(fields, rec):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(f))


def test_mctf_jit_compiles():
    cfg = CodecConfig(pixels_in_x=64, pixels_in_y=48, TRLs=2, GOPs=1,
                      block_size=16, search_range=4, update_factor=0.25)
    y, u, v = _video_arrays(cfg.pictures, 48, 64)
    stream = transform.analyze_jit(y, u, v, cfg)
    ry, ru, rv = transform.synthesize_jit(stream, cfg)
    assert ry.shape == y.shape


def test_update_fields_batch2_matches_single(rng):
    """update_fields_batch2 == two update_fields_batch calls."""
    from qsvc_tpu.mctf import update
    P, H, W, BS, SR = 2, 64, 256, 16, 4
    res = rng.integers(-128, 128, (P, 3, H, W)).astype(np.int16)
    mv = rng.integers(-SR, SR + 1,
                      (P, 2, 2, H // BS, W // BS)).astype(np.int32)
    up, un = update.update_fields_batch2(jnp.asarray(res), jnp.asarray(mv),
                                         BS, 0.25, SR)
    wp = update.update_fields_batch(jnp.asarray(res), jnp.asarray(mv[:, 0, 0]),
                                    jnp.asarray(mv[:, 0, 1]), BS, 0.25, SR)
    wn = update.update_fields_batch(jnp.asarray(res), jnp.asarray(mv[:, 1, 0]),
                                    jnp.asarray(mv[:, 1, 1]), BS, 0.25, SR)
    np.testing.assert_array_equal(np.asarray(up), np.asarray(wp))
    np.testing.assert_array_equal(np.asarray(un), np.asarray(wn))
