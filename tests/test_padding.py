"""Arbitrary input geometry / length: pad on ingest, crop on decode.

SURVEY §7 lists the reference's input constraints as quirks to NOT
replicate (trunk/readme.txt:102-110 rejects dims not divisible by
block_size and pictures != k*gop_size+1; the reference CLI aborts).
Here `api._pad_to_grid` edge-replicates to the coded grid, the v4 stream
header records the true geometry, and `api.expand` crops back.
"""

import numpy as np
import pytest

from qsvc_tpu import api
from qsvc_tpu.codec.codestream import VideoStream
from qsvc_tpu.config import CodecConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.io.yuv import Video, video_psnr


def _odd_video(frames, height, width, seed=3):
    """A video whose dims break every coded-grid rule (odd, not
    block-divisible): built by cropping an aligned synthetic sequence."""
    big = synthetic_video(frames, height + (-height % 32),
                          width + (-width % 32), seed=seed,
                          kind="translate", velocity=(1.0, 2.0))
    ch, cw = -(-height // 2), -(-width // 2)
    return Video(big.y[:, :height, :width], big.u[:, :ch, :cw],
                 big.v[:, :ch, :cw])


def test_non_divisible_dims_round_trip():
    # 94x82 with block 16: neither dim divisible; decoder must crop back
    cfg = CodecConfig(pixels_in_x=94, pixels_in_y=82, TRLs=3, GOPs=1,
                      block_size=16, search_range=2, SRLs=3,
                      quantization_texture=0)
    vid = _odd_video(cfg.pictures, 82, 94)
    vs = api.compress(vid, cfg, reversible=True, lossless=True)
    assert vs.cfg.pixels_in_x % 16 == 0 and vs.cfg.pixels_in_y % 16 == 0
    assert vs.true_dims == (94, 82)
    rec = api.expand(VideoStream.from_bytes(vs.to_bytes()))
    assert rec.y.shape == vid.y.shape and rec.u.shape == vid.u.shape
    # lossless texture + update_factor!=0 clamping can perturb a few
    # boundary pixels; demand near-exactness
    assert video_psnr(vid, rec)[0] > 45


def test_odd_dims_round_trip():
    cfg = CodecConfig(pixels_in_x=93, pixels_in_y=81, TRLs=2, GOPs=1,
                      block_size=16, search_range=2, SRLs=3,
                      quantization_texture=0, update_factor=0.0)
    vid = _odd_video(cfg.pictures, 81, 93)
    vs = api.compress(vid, cfg, reversible=True, lossless=True)
    rec = api.expand(vs)
    # update_factor=0 + lossless texture -> bit-exact through the pad+crop
    np.testing.assert_array_equal(rec.y, vid.y)
    np.testing.assert_array_equal(rec.u, vid.u)
    np.testing.assert_array_equal(rec.v, vid.v)


def test_arbitrary_frame_count_whole_sequence():
    # 12 frames, gop_size 4 -> padded to 13 with a repeated tail frame
    cfg = CodecConfig(pixels_in_x=64, pixels_in_y=48, TRLs=3, GOPs=1,
                      block_size=16, search_range=2, SRLs=3,
                      quantization_texture=0, update_factor=0.0)
    vid = synthetic_video(12, 48, 64, seed=9, kind="translate",
                          velocity=(1.0, 1.0))
    vs = api.compress(vid, cfg, reversible=True, lossless=True)
    assert vs.true_frames == 12 and vs.cfg.pictures == 13
    rec = api.expand(VideoStream.from_bytes(vs.to_bytes()))
    assert rec.frames == 12
    np.testing.assert_array_equal(rec.y, vid.y)


def test_arbitrary_frame_count_streaming_gops():
    # 100 frames, gop_size 4 -> 25 GOPs, tail exact; then 102 -> short tail
    cfg = CodecConfig(pixels_in_x=64, pixels_in_y=48, TRLs=3,
                      block_size=16, search_range=2, SRLs=3,
                      quantization_texture=0, update_factor=0.0)
    for n in (100, 102):
        vid = synthetic_video(n, 48, 64, seed=11, kind="translate",
                              velocity=(1.0, 1.0))
        streams = api.compress_gops(vid, cfg, reversible=True,
                                    lossless=True)
        rec = api.expand_gops(streams)
        assert rec.frames == n, (n, rec.frames)
        np.testing.assert_array_equal(rec.y, vid.y)


@pytest.mark.slow
def test_1918x1080_lossy():
    # real-content dims that are not
    # block-divisible at the FHD block size
    cfg = CodecConfig(pixels_in_x=1918, pixels_in_y=1080, TRLs=2, GOPs=1,
                      search_range=2, SRLs=5, quantization_texture=45000)
    vid = _odd_video(cfg.pictures, 1080, 1918, seed=1)
    vs = api.compress(vid, cfg, reversible=False)
    assert vs.cfg.pixels_in_x % vs.cfg.auto_block_size == 0
    rec = api.expand(vs)
    assert rec.y.shape == vid.y.shape
    assert video_psnr(vid, rec)[0] > 25
