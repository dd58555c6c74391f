"""Top-level codec API: compress / expand / psnr.

The one-process, on-device equivalent of the reference's pipeline
orchestrators (``compress.py:180-228``: analyze -> motion_compress ->
texture_compress; ``expand.py:214-256``: texture_expand -> motion_expand ->
synthesize).  The MCTF temporal transform and DWTs run jitted on the device;
EBCOT entropy coding runs in the native host path; everything flows through
arrays instead of files.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .config import CodecConfig
from .io.yuv import Video
from .utils import trace
from .mctf import motion_coding, transform
from .codec import codestream, frame_codec
from .codec.codestream import LevelSection, VideoStream
from .codec.frame_codec import slope_to_threshold


def _encode_plane_set(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                      levels: int, reversible: bool, delta: float,
                      codeblock: int, min_threshold: float = 0.0,
                      coder: str = "mq"
                      ) -> List[Dict[str, frame_codec.EncodedFrame]]:
    """Batched per-component encode: one device DWT + one native EBCOT
    batch per component stack."""
    ey = frame_codec.encode_frames(y, levels, reversible, delta, codeblock,
                                   min_threshold, coder)
    eu = frame_codec.encode_frames(u, levels, reversible, delta, codeblock,
                                   min_threshold, coder)
    ev = frame_codec.encode_frames(v, levels, reversible, delta, codeblock,
                                   min_threshold, coder)
    return [{"y": a, "u": b, "v": c} for a, b, c in zip(ey, eu, ev)]


def _decode_plane_set(frames: List[Dict[str, frame_codec.EncodedFrame]],
                      threshold: float = 0.0, discard_levels: int = 0,
                      to_host: bool = True):
    """``to_host=False`` keeps the decoded stacks on device — the
    inverse MCTF consumes them directly (no download+re-upload per
    subband)."""
    from .codec import backends as _bk
    if frames and isinstance(frames[0]["y"], _bk.BackendFrame):
        if discard_levels:
            raise ValueError("SS extraction requires the internal "
                             "texture codec (backend frames carry no "
                             "resolution levels)")

        def dec(comp):
            # int32: the inverse MCTF subtracts the +128 bias — uint8
            # arithmetic would wrap
            return np.stack([
                _bk.get(fr[comp].backend).decode(
                    fr[comp].payload, fr[comp].H, fr[comp].W)
                for fr in frames]).astype(np.int32)
        return dec("y"), dec("u"), dec("v")
    ys = frame_codec.decode_frames([fr["y"] for fr in frames], threshold,
                                   discard_levels, to_host)
    us = frame_codec.decode_frames([fr["u"] for fr in frames], threshold,
                                   discard_levels, to_host)
    vs = frame_codec.decode_frames([fr["v"] for fr in frames], threshold,
                                   discard_levels, to_host)
    return ys, us, vs


def _operating_point(cfg: CodecConfig, reversible: bool,
                     delta: Optional[float], lossless: Optional[bool]
                     ) -> Tuple[float, bool, str]:
    if lossless is None:
        lossless = reversible and cfg.quantization_texture <= 0
    if delta is None:
        # tie the 9/7 base quantization step to the operating point: finer
        # than the truncation threshold needs, but no finer — deep planes
        # that any truncation would drop are then never produced (the
        # equivalent of choosing Qstep to match -slope in Kakadu)
        if not reversible and not lossless and cfg.quantization_texture > 0:
            t = slope_to_threshold(float(cfg.quantization_texture))
            delta = float(np.clip(math.sqrt(t) / 8.0, 0.125, 8.0))
        else:
            delta = 0.125
    from .codec import fast as _fast
    coder = cfg.texture_coder if _fast.available() else "mq"
    return delta, lossless, coder


def _pad_to_grid(video: Video, cfg: CodecConfig
                 ) -> Tuple[Video, CodecConfig,
                            Optional[Tuple[int, int]], Optional[int]]:
    """Pad arbitrary input to the coded grid (SURVEY §7 quirk fix: the
    reference *rejects* dims not divisible by block_size and frame counts
    != k*gop_size+1, trunk/readme.txt:102-110; here we edge-replicate
    spatially and repeat the last frame temporally, record the true
    geometry in the stream header (v4), and crop on decode).

    Returns (padded video, cfg with coded geometry, true (W,H) or None,
    true frame count or None)."""
    H, W, n = video.height, video.width, video.frames
    bs = cfg.auto_block_size if cfg.TRLs > 1 else 2
    Ht, Wt = -(-H // bs) * bs, -(-W // bs) * bs
    if cfg.TRLs > 1:
        S = cfg.gop_size
        gops = max(1, -(-(n - 1) // S))
        nt = gops * S + 1
    else:
        gops = cfg.GOPs
        nt = n
    if (Ht, Wt, nt) == (H, W, n):
        if (cfg.pixels_in_x, cfg.pixels_in_y, cfg.pictures) != (W, H, n):
            cfg = cfg.replace(pixels_in_x=W, pixels_in_y=H, GOPs=gops)
        return video, cfg, None, None

    def pad(plane, h, w, frames):
        p = np.asarray(plane)
        return np.pad(p, ((0, frames - p.shape[0]), (0, h - p.shape[1]),
                          (0, w - p.shape[2])), mode="edge")

    video = Video(pad(video.y, Ht, Wt, nt),
                  pad(video.u, Ht // 2, Wt // 2, nt),
                  pad(video.v, Ht // 2, Wt // 2, nt))
    cfg = cfg.replace(pixels_in_x=Wt, pixels_in_y=Ht, GOPs=gops)
    return (video, cfg,
            (W, H) if (Ht, Wt) != (H, W) else None,
            n if nt != n else None)


def compress_dispatch(video: Video, cfg: CodecConfig,
                      reversible: bool = True,
                      delta: Optional[float] = None,
                      lossless: Optional[bool] = None) -> dict:
    """Dispatch the device side of an encode without blocking.

    Uploads the frames (1 byte/pixel), queues the MCTF analyze, the fused
    texture DWT+quantize+tile+R-D-sim over TWO consolidated stacks, and
    the motion-field decorrelation.  Nothing is fetched: the returned
    pending handle can sit in flight while further sequences (the next
    GOPs of a stream) are dispatched behind it — the pipelined path that
    overlaps host->device uploads with device compute.

    Every temporal subband keeps the full spatial resolution (MCTF is a
    purely temporal transform), so the low band and all high bands
    concatenate into one luma and one chroma stack — 2 fused device
    programs instead of 3*TRLs, ONE round trip for the per-tile stats and
    ONE for the compacted code-blocks.
    """
    video, cfg, true_dims, true_frames = _pad_to_grid(video, cfg)
    cfg.validate()
    delta, lossless, coder = _operating_point(cfg, reversible, delta,
                                              lossless)
    # upload 1 byte/pixel; widening happens on device inside analyze.
    # Planes already resident on device pass through untouched.
    def up(x):
        if isinstance(x, jax.Array):
            return x
        return jnp.asarray(np.asarray(x, np.uint8))

    with trace.stage("upload+mctf_dispatch", frames=int(video.frames)):
        y, u, v = up(video.y), up(video.u), up(video.v)
    if cfg.TRLs > 1:
        stream = transform.analyze_jit(y, u, v, cfg)
    else:
        stream = transform.MCTFStream(y.astype(jnp.int16),
                                      u.astype(jnp.int16),
                                      v.astype(jnp.int16), ())
    return _dispatch_stream(stream, cfg, reversible, delta, lossless,
                            coder, true_dims, true_frames)


def _dispatch_stream(stream: "transform.MCTFStream", cfg: CodecConfig,
                     reversible: bool, delta: float, lossless: bool,
                     coder: str,
                     true_dims: Optional[Tuple[int, int]] = None,
                     true_frames: Optional[int] = None) -> dict:
    """Dispatch the entropy side of an encode for an already-computed MCTF
    stream: the consolidated texture stacks (fused DWT+quant+tile+R-D sim
    + device compaction) and the MV decorrelation.  The tail of
    :func:`compress_dispatch`, shared with the halo-exact distributed path
    (``parallel.distributed.compress_distributed`` feeds the per-GOP
    shards of ``analyze_sharded`` through this same code so the
    distributed byte streams are identical to the sequential ones)."""
    srl_levels = cfg.SRLs - 1
    cb = cfg.codeblock_size
    slopes = cfg.slopes()

    def thr(row: int) -> float:
        if lossless:
            return 0.0
        return slope_to_threshold(slopes[row][0])

    luma_planes = [stream.low_y]
    chroma_planes = [stream.low_u, stream.low_v]
    luma_thr = [np.full(stream.low_y.shape[0], thr(0))]
    chroma_thr = [np.full(2 * stream.low_u.shape[0], thr(0))]
    for t, lev in enumerate(stream.levels, start=1):
        mt = thr(cfg.TRLs - t)
        luma_planes.append(lev.high_y)
        chroma_planes += [lev.high_u, lev.high_v]
        luma_thr.append(np.full(lev.high_y.shape[0], mt))
        chroma_thr.append(np.full(2 * lev.high_u.shape[0], mt))
    luma = jnp.concatenate(luma_planes)
    chroma = jnp.concatenate(chroma_planes)

    luma_thr_arr = np.concatenate(luma_thr)
    chroma_thr_arr = np.concatenate(chroma_thr)
    pend_l = frame_codec.encode_frames_dispatch_sparse(
        luma, srl_levels, reversible, delta, cb, luma_thr_arr, coder)
    pend_c = frame_codec.encode_frames_dispatch_sparse(
        chroma, srl_levels, reversible, delta, cb, chroma_thr_arr, coder)

    mv_fields = [lev.mv for lev in stream.levels]
    residues_dev = (motion_coding.decorrelate_jit(mv_fields)
                    if mv_fields else [])

    return dict(cfg=cfg, reversible=reversible, delta=delta,
                lossless=lossless, coder=coder, stream=stream,
                luma_shape=luma.shape, chroma_shape=chroma.shape,
                luma_thr=luma_thr_arr, chroma_thr=chroma_thr_arr,
                pend_l=pend_l, pend_c=pend_c, residues_dev=residues_dev,
                thr=thr, true_dims=true_dims, true_frames=true_frames)


def compress_finish_stats(pending: dict) -> dict:
    """Finish, phase 1: block on the dispatched device encode, fetch the
    tiny per-tile stats + MV residues (one round trip), and dispatch the
    compact ``[:K]`` prefix slices.

    Split out of :func:`compress_finish` so a pipelined caller can queue
    this GOP's slice programs on the device BEFORE dispatching the next
    GOP's encode — the device queue is FIFO, so a slice dispatched after
    ``window`` further encodes would wait for all of them."""
    coder = pending["coder"]
    pend_l, pend_c = pending["pend_l"], pending["pend_c"]
    luma_thr, chroma_thr = pending["luma_thr"], pending["chroma_thr"]

    with trace.stage("device_encode+stats_fetch"):
        # one batched fetch: per-tile stats of both stacks + MV residues
        (stats_l, stats_c, residues) = jax.device_get(
            ((pend_l[2], pend_l[3], pend_l[4]),
             (pend_c[2], pend_c[3], pend_c[4]), pending["residues_dev"]))

    sel_l = frame_codec.encode_frames_select_sparse(
        pend_l, luma_thr, coder, stats=stats_l)
    sel_c = frame_codec.encode_frames_select_sparse(
        pend_c, chroma_thr, coder, stats=stats_c)
    pending = dict(pending)
    pending["_sel"] = (sel_l, sel_c)
    pending["_residues"] = residues
    return pending


def compress_finish(pending: dict) -> VideoStream:
    """Drain one dispatched encode: fetch stats (one round trip), select
    and gather the surviving code-blocks (one round trip), entropy-code
    them natively, and assemble the stream container."""
    if "_sel" not in pending:
        pending = compress_finish_stats(pending)
    cfg = pending["cfg"]
    stream = pending["stream"]
    coder = pending["coder"]
    luma_thr, chroma_thr = pending["luma_thr"], pending["chroma_thr"]
    thr = pending["thr"]
    sel_l, sel_c = pending["_sel"]
    residues = pending["_residues"]

    with trace.stage("select+gather_fetch"):
        # one batched fetch: both compacted code-block stacks
        comp_l, comp_c = jax.device_get((sel_l[1], sel_c[1]))
    sel_l = sel_l[:1] + (comp_l,) + sel_l[2:]
    sel_c = sel_c[:1] + (comp_c,) + sel_c[2:]
    (_, Hl, Wl) = pending["luma_shape"]
    (_, Hc, Wc) = pending["chroma_shape"]
    with trace.stage("native_entropy_coding"):
        enc_l = frame_codec.encode_frames_finish_sparse(
            sel_l, Hl, Wl, luma_thr, coder)
        enc_c = frame_codec.encode_frames_finish_sparse(
            sel_c, Hc, Wc, chroma_thr, coder)

    def trunc(frames, row):
        t = thr(row)
        if t <= 0:
            return frames
        return [{c: ef.truncate(t) for c, ef in fr.items()} for fr in frames]

    # slice the consolidated results back into per-subband plane sets
    def plane_set(lo_y, lo_c, n):
        return [{"y": enc_l[lo_y + i], "u": enc_c[lo_c + i],
                 "v": enc_c[lo_c + n + i]} for i in range(n)]

    n0 = stream.low_y.shape[0]
    low = trunc(plane_set(0, 0, n0), 0)

    # one native call for every motion field of every level (the per-call
    # marshalling dominates for these tiny blocks)
    all_fields = [np.asarray(residues[t])[i]
                  for t in range(len(stream.levels))
                  for i in range(np.asarray(residues[t]).shape[0])]
    all_motion = codestream.encode_motion_fields(all_fields)

    levels: List[LevelSection] = []
    oy, oc = n0, 2 * n0
    mo = 0
    for t, lev in enumerate(stream.levels, start=1):
        p = lev.high_y.shape[0]
        high = trunc(plane_set(oy, oc, p), cfg.TRLs - t)
        oy += p
        oc += 2 * p
        motion = all_motion[mo:mo + p]
        mo += p
        ftypes = bytes(b"B"[0] if b else b"I"[0]
                       for b in np.asarray(lev.is_B))
        levels.append(LevelSection(high, motion, ftypes))

    return VideoStream(cfg, pending["reversible"], pending["delta"], low,
                       levels, true_dims=pending["true_dims"],
                       true_frames=pending["true_frames"])


def prewarm(cfg: CodecConfig, reversible: bool = False,
            delta: Optional[float] = None,
            lossless: Optional[bool] = None) -> float:
    """Compile the per-GOP encode programs CONCURRENTLY before first use.

    The four big programs — MCTF analyze, the luma and chroma fused
    DWT+quant+tile+R-D dispatches, and the MV decorrelation — compile
    from four threads (XLA releases the GIL, so the compiles overlap).
    Zero-filled inputs of the production shapes trigger exactly the
    executables the first real GOP needs, so the first frame no longer
    pays the serial compile chain.  Returns seconds spent.  Cheap when
    the persistent compile cache is already warm."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()
    gop_cfg = cfg.replace(GOPs=1)
    gop_cfg.validate()
    delta, lossless, coder = _operating_point(gop_cfg, reversible, delta,
                                              lossless)
    H, W = gop_cfg.pixels_in_y, gop_cfg.pixels_in_x
    n = gop_cfg.pictures
    y = jnp.zeros((n, H, W), jnp.uint8)
    u = jnp.zeros((n, H // 2, W // 2), jnp.uint8)
    v = jnp.zeros((n, H // 2, W // 2), jnp.uint8)
    # consolidated stack sizes (low band n0=2 for a 1-GOP dispatch, plus
    # one high stack per level — see compress_dispatch)
    n_l = n
    luma = jnp.zeros((n_l, H, W), jnp.int16)
    chroma = jnp.zeros((2 * n_l, H // 2, W // 2), jnp.int16)
    mvs = [jnp.zeros((lp.pictures // 2, 2, 2, H // lp.block_size,
                      W // lp.block_size), jnp.int32)
           for lp in gop_cfg.level_schedule()]
    cb = gop_cfg.codeblock_size
    srl = gop_cfg.SRLs - 1

    def warm_analyze():
        if gop_cfg.TRLs > 1:
            jax.block_until_ready(transform.analyze_jit(y, u, v, gop_cfg))

    def warm_stack(pl):
        pend = frame_codec.encode_frames_dispatch_sparse(
            pl, srl, reversible, delta, cb, 0.0, coder)
        jax.block_until_ready(pend[1])

    def warm_mv():
        if mvs:
            jax.block_until_ready(motion_coding.decorrelate_jit(mvs))

    with trace.stage("prewarm"):
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(warm_analyze), ex.submit(warm_stack, luma),
                    ex.submit(warm_stack, chroma), ex.submit(warm_mv)]
            for f in futs:
                f.result()
    return time.time() - t0


def prewarm_decode(cfg: CodecConfig, reversible: bool = False,
                   delta: Optional[float] = None,
                   lossless: Optional[bool] = None) -> float:
    """Compile the per-GOP DECODE programs concurrently before first use
    (the decode mirror of :func:`prewarm`): the sparse tile scatter +
    fused dequant+IDWT for every plane-set geometry, the inverse MV
    correlation, and the jitted inverse MCTF.  Zero inputs of the
    production shapes; returns seconds spent."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()
    gop_cfg = cfg.replace(GOPs=1)
    gop_cfg.validate()
    delta, lossless, coder = _operating_point(gop_cfg, reversible, delta,
                                              lossless)
    H, W = gop_cfg.pixels_in_y, gop_cfg.pixels_in_x
    sched = gop_cfg.level_schedule()
    srl = gop_cfg.SRLs - 1
    cb = gop_cfg.codeblock_size
    d = jnp.float32(delta)
    # plane-set stack shapes of one GOP's decode: the low band (2
    # frames) plus one high stack per level, luma + half-res chroma
    counts = [2] + [lp.pictures // 2 for lp in sched]
    shapes = ([(n, H, W) for n in counts] +
              [(n, H // 2, W // 2) for n in counts])
    K = frame_codec._bucket(1)

    def warm_set(shape):
        n, h, w = shape
        tiles = jnp.zeros((K, cb, cb), jnp.int16)
        pos = jnp.full((K, 3), jnp.asarray((0, h, w), jnp.int32))
        packed = frame_codec._scatter_tiles(tiles, pos, n, h, w)
        jax.block_until_ready(
            frame_codec._dequant_idwt(packed, srl, reversible, d))

    def warm_synth():
        if gop_cfg.TRLs <= 1:
            return
        zs = lambda *s: jnp.zeros(s, jnp.int32)
        levels = tuple(
            transform.LevelData(
                zs(lp.pictures // 2, H, W),
                zs(lp.pictures // 2, H // 2, W // 2),
                zs(lp.pictures // 2, H // 2, W // 2),
                zs(lp.pictures // 2, 2, 2, H // lp.block_size,
                   W // lp.block_size),
                jnp.ones(lp.pictures // 2, bool))
            for lp in sched)
        m = transform.MCTFStream(zs(2, H, W), zs(2, H // 2, W // 2),
                                 zs(2, H // 2, W // 2), levels)
        jax.block_until_ready(_synthesize_partial(m, gop_cfg, 0))

    def warm_mv():
        if gop_cfg.TRLs > 1:
            res = [jnp.zeros((lp.pictures // 2, 2, 2, H // lp.block_size,
                              W // lp.block_size), jnp.int32)
                   for lp in sched]
            jax.block_until_ready(motion_coding.correlate_jit(res))

    with trace.stage("prewarm_decode"):
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = ([ex.submit(warm_synth), ex.submit(warm_mv)] +
                    [ex.submit(warm_set, s) for s in shapes])
            for f in futs:
                f.result()
    return time.time() - t0


def _compress_with_backend(video: Video, cfg: CodecConfig) -> VideoStream:
    """Encode with an alternative texture backend (codec/backends.py) —
    the reference's codec-registry capability (mcj2k/mcmj2k/mccp
    profiles, texture_compress.py:39): device MCTF as usual, then each
    subband frame plane is coded by the selected per-plane codec instead
    of the internal fused DWT+EBCOT path.  Subband planes are already
    uint8-range (high bands stored +128-biased, decorrelate.cpp
    convention), so every backend sees plain grayscale planes."""
    from .codec import backends
    be = backends.get(cfg.texture_backend)
    video, cfg, true_dims, true_frames = _pad_to_grid(video, cfg)
    cfg.validate()

    def up(x):
        if isinstance(x, jax.Array):
            return x
        return jnp.asarray(np.asarray(x, np.uint8))

    y, u, v = up(video.y), up(video.u), up(video.v)
    if cfg.TRLs > 1:
        stream = transform.analyze_jit(y, u, v, cfg)
    else:
        stream = transform.MCTFStream(y.astype(jnp.int16),
                                      u.astype(jnp.int16),
                                      v.astype(jnp.int16), ())
    q = 0.0 if be.lossless else float(cfg.quantization_texture)

    def enc_planes(py, pu, pv) -> List[Dict[str, backends.BackendFrame]]:
        ay, au, av = jax.device_get((py, pu, pv))
        out = []
        for i in range(ay.shape[0]):
            fr = {}
            for comp, a in (("y", ay), ("u", au), ("v", av)):
                p = np.clip(a[i], 0, 255).astype(np.uint8)
                fr[comp] = backends.BackendFrame(
                    be.name, p.shape[0], p.shape[1], be.encode(p, q))
            out.append(fr)
        return out

    low = enc_planes(stream.low_y, stream.low_u, stream.low_v)
    mv_fields = [lev.mv for lev in stream.levels]
    residues = (jax.device_get(motion_coding.decorrelate_jit(mv_fields))
                if mv_fields else [])
    levels: List[LevelSection] = []
    for t, lev in enumerate(stream.levels):
        high = enc_planes(lev.high_y, lev.high_u, lev.high_v)
        motion = [codestream.encode_motion_field(
            np.asarray(residues[t][i]).astype(np.int64))
            for i in range(np.asarray(residues[t]).shape[0])]
        ftypes = bytes(b"B"[0] if b else b"I"[0]
                       for b in np.asarray(lev.is_B))
        levels.append(LevelSection(high, motion, ftypes))
    # header metadata must reflect the backend: a lossy backend (mj2k)
    # stream is not reversible, and delta is meaningless (backends do
    # their own quantization) — 0.0 marks it unused.
    return VideoStream(cfg, be.lossless, 0.0, low, levels,
                       true_dims=true_dims, true_frames=true_frames)


def compress(video: Video, cfg: CodecConfig, reversible: bool = True,
             delta: Optional[float] = None, lossless: Optional[bool] = None
             ) -> VideoStream:
    """Encode a video to a :class:`VideoStream`.

    ``reversible``: use the integer 5/3 texture path (plus no quantization)
    — with ``lossless=True`` (default when reversible and
    ``quantization_texture <= 0``) nothing is truncated and intra-only
    streams decode bit-exactly.  Otherwise blocks are truncated at the
    per-subband slope thresholds from ``cfg.slopes()``
    (texture_compress.py:148-176 rate-allocation policy).

    ``cfg.texture_backend`` other than "internal" routes the texture
    layer through the alternative-codec registry (codec/backends.py).
    """
    if cfg.texture_backend != "internal":
        return _compress_with_backend(video, cfg)
    return compress_finish(compress_dispatch(video, cfg, reversible, delta,
                                             lossless))


def compress_gops(video: Video, cfg: CodecConfig, reversible: bool = True,
                  delta: Optional[float] = None,
                  lossless: Optional[bool] = None,
                  window: int = 2) -> List[VideoStream]:
    """Streaming encode: one self-contained :class:`VideoStream` per GOP,
    pipelined ``window`` GOPs deep.

    GOPs are closed units sharing only their boundary frame (the open-GOP
    rule, reference GOP.py:22-23); encoding them independently makes each
    GOP separately decodable/shippable (the reference's per-GOP transcode
    loop, transcode.py:2102-2127) and lets GOP ``g+1``'s upload and device
    transform run while GOP ``g``'s code-blocks are fetched and
    entropy-coded — steady-state throughput is max(upload, device, host)
    instead of their sum.

    Arbitrary frame counts are allowed: the tail chunk is short and gets
    frame-padded inside its own dispatch (true count in its v4 header),
    so ``expand_gops`` reconstructs exactly the input frames.
    """
    S = cfg.gop_size
    gop_cfg = cfg.replace(GOPs=1)
    G = max(1, -(-(video.frames - 1) // S)) if cfg.TRLs > 1 else cfg.GOPs
    chunks = [Video(video.y[g * S:(g + 1) * S + 1],
                    video.u[g * S:(g + 1) * S + 1],
                    video.v[g * S:(g + 1) * S + 1])
              for g in range(G)]
    return compress_chunks(chunks, gop_cfg, reversible, delta, lossless,
                           window)


def compress_chunks(chunks, gop_cfg: CodecConfig,
                    reversible: bool = True, delta: Optional[float] = None,
                    lossless: Optional[bool] = None,
                    window: int = 2, progress=None) -> List[VideoStream]:
    """Pipelined encode of a list of (already sliced) GOP chunks.

    Device-queue-aware interleave: GOP ``g``'s stats fetch + compact-slice
    dispatch run BEFORE GOP ``g+window``'s encode dispatch, so the tiny
    slice programs sit directly behind their own GOP's encode in the FIFO
    device queue instead of behind ``window`` later encodes; the compact
    download and the host entropy coding of GOP ``g`` then overlap the
    device compute of the following GOPs.

    ``chunks`` may be any iterable (a generator keeps memory bounded to
    ``window`` in-flight GOPs); ``progress(index, stream)`` is called as
    each GOP's stream is finished, in order."""
    if gop_cfg.texture_backend != "internal":
        # alternative backends are host codecs: no device pipeline
        out = []
        for i, chunk in enumerate(chunks):
            vs = _compress_with_backend(chunk, gop_cfg)
            if progress is not None:
                progress(i, vs)
            out.append(vs)
        return out
    pendings: List[dict] = []
    out: List[VideoStream] = []

    def finish_one():
        vs = compress_finish(pendings.pop(0))
        if progress is not None:
            progress(len(out), vs)
        out.append(vs)

    for chunk in chunks:
        if len(pendings) >= max(window, 1):
            finish_one()
        if pendings and "_sel" not in pendings[0]:
            pendings[0] = compress_finish_stats(pendings[0])
        pendings.append(compress_dispatch(chunk, gop_cfg, reversible,
                                          delta, lossless))
    while pendings:
        finish_one()
    return out


def expand_gops(streams: List[VideoStream], **kw) -> Video:
    """Decode a per-GOP stream list back to one sequence (drops the
    duplicated shared boundary frames).

    Two GOPs decode concurrently: the host entropy decode of GOP g+1
    (native, releases the GIL) overlaps GOP g's device synthesis and
    output download — the decode-side mirror of the encode pipeline's
    host/device overlap."""
    from concurrent.futures import ThreadPoolExecutor
    if len(streams) > 1:
        with ThreadPoolExecutor(max_workers=2) as ex:
            vids = list(ex.map(lambda vs: expand(vs, **kw), streams))
    else:
        vids = [expand(vs, **kw) for vs in streams]
    y = np.concatenate([v.y[:-1] for v in vids] + [vids[-1].y[-1:]])
    u = np.concatenate([v.u[:-1] for v in vids] + [vids[-1].u[-1:]])
    v_ = np.concatenate([v.v[:-1] for v in vids] + [vids[-1].v[-1:]])
    return Video(y, u, v_)


def expand(vs: VideoStream, threshold: float = 0.0,
           discard_TRLs: int = 0, to_host: bool = True) -> Video:
    """Decode a :class:`VideoStream` back to video.

    ``threshold``: extra decode-time slope-threshold truncation (QS).
    ``discard_TRLs``: drop the finest ``d`` temporal levels — decodes at
    reduced frame rate (TS extraction, transcode.py semantics).
    ``to_host=False`` returns device-resident uint8 planes (the staged
    decode convention — the final download is environment transport,
    measured separately; the uint8 cast happens ON DEVICE either way so
    the host link carries 1 byte/pixel, not the transform's int32).
    """
    cfg = vs.cfg
    ly, lu, lv = _decode_plane_set(vs.low, threshold, to_host=False)
    use_levels = vs.levels[discard_TRLs:] if discard_TRLs else vs.levels

    lev_data = []
    residue_fields = []
    for lev in use_levels:
        hy, hu, hv = _decode_plane_set(lev.high, threshold, to_host=False)
        with trace.stage("decode.motion"):
            res = [codestream.decode_motion_field(m) for m in lev.motion]
        if res:
            residue_fields.append(jnp.asarray(np.stack(res)))
        lev_data.append((hy, hu, hv,
                         np.frombuffer(lev.frame_types, np.uint8) ==
                         ord("B")))

    # reconstruct motion fields (inverse inter-level/bidirectional coding)
    if residue_fields:
        mv_fields = motion_coding.correlate_jit(residue_fields)
    else:
        mv_fields = []

    levels = []
    for i, (hy, hu, hv, is_b) in enumerate(lev_data):
        levels.append(transform.LevelData(
            jnp.asarray(hy), jnp.asarray(hu), jnp.asarray(hv),
            mv_fields[i].astype(jnp.int32), jnp.asarray(is_b)))

    mstream = transform.MCTFStream(jnp.asarray(ly), jnp.asarray(lu),
                                   jnp.asarray(lv), tuple(levels))
    with trace.stage("decode.synthesize_dispatch"):
        if len(levels) == 0:
            ry, ru, rv = mstream.low_y, mstream.low_u, mstream.low_v
        else:
            ry, ru, rv = _synthesize_partial(mstream, cfg, discard_TRLs)
        # uint8 cast on device: the download is 1 byte/pixel instead of
        # the transform's wider dtype (measured 213 -> 53 MB per GOP)
        ry, ru, rv = (ry.astype(jnp.uint8), ru.astype(jnp.uint8),
                      rv.astype(jnp.uint8))
    if not to_host:
        with trace.stage("decode.wait_device"):
            jax.block_until_ready((ry, ru, rv))
        vid = Video(ry, ru, rv)
    else:
        with trace.stage("decode.output_download"):
            vid = Video(np.asarray(ry), np.asarray(ru), np.asarray(rv))
    if vs.true_dims is not None or vs.true_frames is not None:
        tw, th = vs.true_dims or (vid.width, vid.height)
        tf = vs.true_frames if vs.true_frames is not None else vid.frames
        if discard_TRLs:     # frames surviving at the reduced rate
            tf = (tf - 1) // 2 ** discard_TRLs + 1
        ch, cw = -(-th // 2), -(-tw // 2)       # ceil: odd true dims
        vid = Video(vid.y[:tf, :th, :tw],
                    vid.u[:tf, :ch, :cw], vid.v[:tf, :ch, :cw])
    return vid


@partial(jax.jit, static_argnames=("cfg", "discard_TRLs"))
def _synthesize_partial(mstream: transform.MCTFStream, cfg: CodecConfig,
                        discard_TRLs: int = 0):
    """Inverse MCTF over the kept levels only (TS extraction decodes the
    coarser levels with their own schedule entries).  Jitted: an eager
    per-level loop dispatches every op separately."""
    schedule = cfg.level_schedule()
    low = (mstream.low_y, mstream.low_u, mstream.low_v)
    kept = schedule[discard_TRLs:]
    for lp, lev in zip(reversed(kept), reversed(mstream.levels)):
        low = transform._synthesize_level(low, lev, lp.block_size,
                                          lp.search_range, cfg)
    return low


def compress_bytes(video: Video, cfg: CodecConfig, **kw) -> bytes:
    return compress(video, cfg, **kw).to_bytes()


def expand_bytes(data: bytes, **kw) -> Video:
    return expand(VideoStream.from_bytes(data), **kw)
