"""Benchmark: 1080p full-pipeline encode throughput on one device.

Measures the BASELINE.md headline config (config 3): 1080p GOP=16 MCTF +
spatial DWT + device R-D simulation + native EBCOT entropy coding, at the
default operating point (slope 45000).  Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "fps", "detail": {...}}

The headline ``value`` is timed from device-resident frames to the encoded
byte streams in host memory (device MCTF+DWT+R-D, code-block fetch, native
EBCOT and container assembly included).  ``detail.e2e_fps`` is the
pipelined host-frames -> streams number (uploads included), and
``detail.decode_e2e_fps`` the streams -> host-frames decode.

Run from the repo root:  python bench.py
"""

import json
import sys
import time


def main() -> int:
    import jax
    import jax.numpy as jnp
    from qsvc_tpu import api
    from qsvc_tpu.config import CodecConfig
    from qsvc_tpu.io import synthetic_video

    GOPS = 4
    cfg = CodecConfig(pixels_in_x=1920, pixels_in_y=1088, TRLs=5, GOPs=GOPS,
                      SRLs=5, search_range=4, update_factor=0.25,
                      quantization_texture=45000)
    vid = synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                          seed=0)

    # warmup: compile the device graphs — the four big programs compile
    # concurrently (api.prewarm; XLA releases the GIL) instead of
    # serially on first use; persistent cache cuts repeats
    t0 = time.time()
    prewarm_s = api.prewarm(cfg, reversible=False)
    streams = api.compress_gops(vid, cfg, reversible=False)
    warm = time.time() - t0

    # end-to-end steady state: host frames -> encoded streams, pipelined
    # uploads
    t0 = time.time()
    streams = api.compress_gops(vid, cfg, reversible=False)
    e2e_dt = time.time() - t0
    e2e_fps = vid.frames / e2e_dt

    # headline: full pipeline from device-resident frames (BASELINE.md's
    # "wall-clock over full pipeline, block_until_ready")
    S = cfg.gop_size
    gop_cfg = cfg.replace(GOPs=1)
    from qsvc_tpu.io.yuv import Video
    chunks = [Video(vid.y[g * S:(g + 1) * S + 1],
                    vid.u[g * S:(g + 1) * S + 1],
                    vid.v[g * S:(g + 1) * S + 1]) for g in range(GOPS)]
    staged = [Video(jnp.asarray(c.y), jnp.asarray(c.u), jnp.asarray(c.v))
              for c in chunks]
    for c in staged:
        jax.device_get(c.y.ravel()[:1])
    _ = api.compress_chunks(staged, gop_cfg, reversible=False)  # warm path
    t0 = time.time()
    _ = api.compress_chunks(staged, gop_cfg, reversible=False)
    dt = time.time() - t0
    fps = vid.frames / dt

    # quality at the headline operating point + decode-side throughput:
    # a throughput number at an unverified quality point is gameable, and
    # a codec whose decoder is untimed is half-benchmarked
    from qsvc_tpu.io.yuv import video_psnr
    dec_prewarm_s = api.prewarm_decode(cfg, reversible=False)
    rec = api.expand_gops(streams)              # decode warmup/compile
    t0 = time.time()
    rec = api.expand_gops(streams)
    dec_dt = time.time() - t0
    t0 = time.time()
    for s in streams:                            # staged: device-resident
        api.expand(s, to_host=False)             # uint8 frames
    dec_staged_dt = time.time() - t0
    psnr_y, psnr_u, psnr_v = video_psnr(vid, rec)

    nbytes = sum(len(s.to_bytes()) for s in streams)
    raw = vid.y.size * 3 // 2
    print(json.dumps({
        "metric": "1080p_gop16_encode_fps_per_chip",
        "value": round(fps, 3),
        "unit": "fps",
        "detail": {
            "frames": vid.frames,
            "gops": GOPS,
            "seconds": round(dt, 2),
            "warmup_seconds": round(warm, 2),
            "prewarm_seconds": round(prewarm_s, 2),
            "e2e_fps": round(e2e_fps, 3),
            "bpp": round(nbytes * 8 / raw, 3),
            "psnr_y": round(psnr_y, 3),
            "psnr_u": round(psnr_u, 3),
            "psnr_v": round(psnr_v, 3),
            "decode_fps": round(vid.frames / dec_staged_dt, 3),
            "decode_e2e_fps": round(vid.frames / dec_dt, 3),
            "decode_prewarm_seconds": round(dec_prewarm_s, 2),
            "device": str(jax.devices()[0]),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
