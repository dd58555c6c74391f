"""Smoke test of the encode/decode path on NVIDIA GPUs.

Drives the main path once through ``qsvc_tpu.api`` (``prewarm``,
``compress_gops``, ``expand_gops``), in the one process that uses the
card, at the repository's real operating point W1 (``bench.py``):
1920x1088, TRLs=5 (GOP 16), 4 GOPs
(65 frames), SRLs=5, search range 4, update factor 1/4, irreversible 9/7 at
slope 45000, bp coder.  Content is ``synthetic_video(seed=0)``.

Phases, in order (any failure exits non-zero and prints no result line):

1. device: JAX's default device must be a GPU; prints the card's name and
   power limit (``nvidia-smi``);
2. native coder: the host entropy coder (``native/ebcot.cpp``) must build
   and load;
3. stages: the MCTF analyze of one GOP on the GPU must equal the CPU
   backend's bit for bit (motion estimation, compensation and update are
   integer arithmetic); then the device time, compulsory bytes and
   achieved bandwidth of ME, MC predict and MC update at W1's shapes;
4. lossless: reversible 5/3 at slope 0 round-trips one W1-sized GOP
   exactly (update factor 0: the update step's [0, 255] clamp makes a
   non-zero factor only near-lossless, on any device);
5. lossy W1: the 4-GOP encode and decode with fps, warm-up seconds, PSNR
   and bpp; one GOP is compared with the CPU backend's run of the same
   configuration: PSNR-Y within 0.05 dB and bytes within 0.5 %.  The
   tolerance covers float32 9/7 lifting and the float R-D sums, which a
   backend may contract into FMAs or reduce in another order.  The
   package has no matrix products, so TF32 does not arise.

The CPU results of phases 3 and 5 come from a child process
(``JAX_PLATFORMS=cpu``) that runs while the GPU phases do.  It keeps no
persistent compile cache: XLA:CPU entries are machine code for one host,
and the cache directory this program shares between machines holds only
GPU programs.

``--chips 4`` runs only the GOP-sharded encode on four GPUs instead: both
distributed paths must produce the bytes of the one-device encode, with
every GOP encoded on its own card.  The four encodes run one after
another, each timed with its compiles.

The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Run from the repository root:  python chip_smoke.py [--chips 4]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from qsvc_tpu import api
from qsvc_tpu.codec import fast
from qsvc_tpu.codec.codestream import VideoStream
from qsvc_tpu.config import CodecConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.io.yuv import Video, video_psnr
from qsvc_tpu.mctf import me, predict, transform, update
from qsvc_tpu.utils import trace

W1 = CodecConfig(pixels_in_x=1920, pixels_in_y=1088, TRLs=5, GOPs=4,
                 SRLs=5, search_range=4, update_factor=0.25,
                 quantization_texture=45000)
PEAK_HBM_BYTES_S = 3.35e12      # H100 SXM data sheet
PSNR_TOL_DB = 0.05
BYTES_TOL = 0.005


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def gop(vid: Video, cfg: CodecConfig, g: int) -> Video:
    S = cfg.gop_size
    return vid[g * S:(g + 1) * S + 1]


def w1_video() -> Video:
    return synthetic_video(W1.pictures, W1.pixels_in_y, W1.pixels_in_x,
                           seed=0)


def _save(out_dir: str, name: str, arrays: dict) -> None:
    tmp = os.path.join(out_dir, name + ".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(out_dir, name + ".npz"))
    print(name, flush=True)


def cpu_reference(out_dir: str) -> None:
    """Child process body: GOP 0 of W1 on the CPU backend.  Writes
    ``analyze.npz`` (every leaf of the MCTF analyze) and then
    ``lossy.npz`` (the one-GOP stream and its PSNR-Y) to ``out_dir``,
    announcing each by name on standard output."""
    check(jax.devices()[0].platform == "cpu", "reference must run on cpu")
    gcfg = W1.replace(GOPs=1)
    g0 = gop(w1_video(), W1, 0)
    t0 = time.time()
    st = jax.device_get(transform.analyze_jit(*g0.planes(), gcfg))
    _save(out_dir, "analyze", {
        "seconds": np.float64(time.time() - t0),
        **{f"leaf{i}": x
           for i, x in enumerate(jax.tree_util.tree_leaves(st))}})
    blob = api.compress(g0, gcfg, reversible=False).to_bytes()
    psnr_y = video_psnr(g0, api.expand(VideoStream.from_bytes(blob)))[0]
    _save(out_dir, "lossy", {"blob": np.frombuffer(blob, np.uint8),
                             "psnr_y": np.float64(psnr_y)})


class CpuReference:
    """The child process that computes :func:`cpu_reference` while the
    GPU phases run."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_ref")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_ENABLE_COMPILATION_CACHE="false")
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; chip_smoke.cpu_reference(sys.argv[1])",
             self.dir],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, text=True)
        self.ready = set()

    def get(self, name: str) -> dict:
        while name not in self.ready:
            line = self.proc.stdout.readline()
            if not line:
                raise SmokeError(f"cpu reference exited with code "
                                 f"{self.proc.wait()} before '{name}'")
            self.ready.add(line.strip())
        with np.load(os.path.join(self.dir, name + ".npz")) as f:
            return dict(f)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def phase_device(n: int) -> str:
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's default device is {devs[0]}")
    check(len(devs) >= n, f"{n} GPUs needed, JAX sees {len(devs)}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = out.strip().splitlines()[0]
    print(f"[device] {devs[0].device_kind} x{len(devs)}; "
          f"nvidia-smi: {card}", flush=True)
    return card


def phase_native() -> None:
    check(fast.available(), f"native coder unavailable: {fast._build_error}")
    print("[native] entropy coder built and loaded", flush=True)


def _device_busy_seconds(path: str) -> float | None:
    """Union of the GPU stream events' intervals in a profiler trace."""
    from jax.profiler import ProfileData
    spans = []
    for f in glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                       recursive=True):
        for plane in ProfileData.from_file(f).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if line.name.startswith("Stream"):
                    spans += [(e.start_ns, e.start_ns + e.duration_ns)
                              for e in line.events]
    if not spans:
        return None
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-9


def time_stage(fn, args, reps: int = 5):
    """(device seconds per call from a profiler trace or None, median
    host seconds per call with block_until_ready)."""
    jax.block_until_ready(fn(*args))                 # compile
    walls = []
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*args))
                walls.append(time.perf_counter() - t0)
        busy = _device_busy_seconds(d)
    return (None if busy is None else busy / reps), float(np.median(walls))


def _nbytes(tree) -> int:
    return sum(int(x.size) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree))


def _first_mismatch(la, lb) -> str | None:
    names = ["low_y", "low_u", "low_v"] + [
        f"level{t + 1}.{f}" for t in range((len(la) - 3) // 5)
        for f in ("high_y", "high_u", "high_v", "mv", "is_B")]
    for name, x, y in zip(names, la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or not np.array_equal(x, y):
            diff = (np.flatnonzero((x != y).reshape(x.shape[0], -1).any(1))
                    if x.shape == y.shape else "shape")
            return f"{name}: frames differing {diff}"
    return None


def phase_stages(vid: Video, cfg: CodecConfig, ref: CpuReference) -> None:
    gcfg = cfg.replace(GOPs=1)
    g0 = gop(vid, cfg, 0)
    gpu = jax.devices()[0]
    t0 = time.time()
    st_g = jax.device_get(transform.analyze_jit(
        *jax.device_put(g0.planes(), gpu), gcfg))
    t_g = time.time() - t0
    leaves_g = jax.tree_util.tree_leaves(st_g)
    r = ref.get("analyze")
    bad = _first_mismatch(leaves_g,
                          [r[f"leaf{i}"] for i in range(len(leaves_g))])
    check(bad is None, f"analyze on {gpu.platform} != cpu: {bad}")
    types = " ".join("".join("B" if b else "I" for b in lev.is_B)
                     for lev in st_g.levels)
    print(f"[stages] analyze of one GOP bit-exact vs cpu (motion fields, "
          f"frame types {types}, every subband); first call incl. compile "
          f"{t_g:.1f} s {gpu.platform}, {float(r['seconds']):.1f} s cpu "
          f"(no compile cache)", flush=True)

    # per-stage device time at the shapes of every temporal level of one
    # GOP, fed with the GOP's own frames and motion fields.  Bytes are
    # compulsory traffic: each input read once, each output written once.
    y = jnp.asarray(g0.y, jnp.int16)
    u = jnp.asarray(g0.u, jnp.int16)
    v = jnp.asarray(g0.v, jnp.int16)
    refs = transform._refs444(y[0::2], u[0::2], v[0::2])
    rows = {"me": [], "mc_predict": [], "mc_update": []}
    for t, lp in enumerate(gcfg.level_schedule()):
        P = lp.pictures // 2
        bs, sr = lp.block_size, lp.search_range
        mv = jnp.asarray(st_g.levels[t].mv)
        evens, odds = y[0:2 * P + 1:2], y[1:2 * P:2]
        e444 = refs[:P + 1]
        lev = st_g.levels[t]
        res = jax.vmap(update.residue_to_444)(
            tuple(jnp.asarray(h, jnp.int16)
                  for h in (lev.high_y, lev.high_u, lev.high_v)),
            jnp.asarray(lev.is_B)[:, None, None, None])
        stages = {
            "me": (jax.jit(lambda e, o, bs=bs, sr=sr: me.estimate_sequence(
                e, o, bs, sr, gcfg.border_size, gcfg.subpixel_accuracy)),
                (evens, odds)),
            "mc_predict": (jax.jit(
                lambda r, m, bs=bs, sr=sr: predict.predict_frames_batch(
                    r[:-1], r[1:], m, bs, sr)), (e444, mv)),
            "mc_update": (jax.jit(
                lambda r, m, bs=bs, sr=sr: update.update_fields_batch2(
                    r, m, bs, gcfg.update_factor, sr)), (res, mv)),
        }
        for name, (fn, args) in stages.items():
            dev_s, wall_s = time_stage(fn, args)
            nbytes = _nbytes(args) + _nbytes(jax.eval_shape(fn, *args))
            rows[name].append((dev_s, wall_s, nbytes))
    for name, r in rows.items():
        nbytes = sum(b for _, _, b in r)
        wall = sum(w for _, w, _ in r)
        if all(d is not None for d, _, _ in r):
            dev = sum(d for d, _, _ in r)
            rate = nbytes / dev
            dev_txt = (f"device {dev * 1e3:.3f} ms, {rate / 1e9:.1f} GB/s "
                       f"= {100 * rate / PEAK_HBM_BYTES_S:.2f}% of 3.35 TB/s")
        else:
            dev_txt = "device time not measured (no GPU events in trace)"
        print(f"[stages] {name}: one GOP, {len(r)} levels: {dev_txt}; "
              f"host-timed {wall * 1e3:.3f} ms; compulsory bytes "
              f"{nbytes / 1e6:.2f} MB", flush=True)


def phase_lossless(vid: Video, cfg: CodecConfig) -> None:
    lcfg = cfg.replace(GOPs=1, update_factor=0.0, quantization_texture=0)
    g0 = gop(vid, cfg, 0)
    t0 = time.time()
    blob = api.compress(g0, lcfg, reversible=True).to_bytes()
    rec = api.expand(VideoStream.from_bytes(blob))
    dt = time.time() - t0
    for name, a, b in zip("yuv", g0.planes(), rec.planes()):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"lossless round trip differs in plane {name}")
    print(f"[lossless] 5/3 slope 0, {g0.frames} frames: exact, "
          f"{len(blob)} bytes, {dt:.1f} s incl. compile", flush=True)


def phase_lossy(vid: Video, cfg: CodecConfig, ref: CpuReference,
                card: str) -> None:
    raw = vid.y.size * 3 // 2       # samples of Y+U+V (bench.py's bpp)
    prewarm_s = api.prewarm(cfg, reversible=False)
    api.compress_gops(vid, cfg, reversible=False)          # first run
    t0 = time.time()
    blobs = [s.to_bytes()
             for s in api.compress_gops(vid, cfg, reversible=False)]
    enc_s = time.time() - t0
    prewarm_dec_s = api.prewarm_decode(cfg, reversible=False)
    api.expand_gops([VideoStream.from_bytes(b) for b in blobs])
    t0 = time.time()
    rec = api.expand_gops([VideoStream.from_bytes(b) for b in blobs])
    dec_s = time.time() - t0
    check(rec.y.shape == vid.y.shape, f"decoded shape {rec.y.shape}")
    py, pu, pv = video_psnr(vid, rec)
    nbytes = sum(len(b) for b in blobs)
    print(f"[lossy] W1 {vid.frames} frames on {card}: encode "
          f"{vid.frames / enc_s:.3f} fps ({enc_s:.3f} s, host YUV -> "
          f"bytes), decode {vid.frames / dec_s:.3f} fps ({dec_s:.3f} s, "
          f"bytes -> host YUV), prewarm {prewarm_s:.1f} s, prewarm_decode "
          f"{prewarm_dec_s:.1f} s; PSNR Y/U/V {py:.4f}/{pu:.4f}/{pv:.4f} dB, "
          f"{nbytes} bytes, {nbytes * 8 / raw:.5f} bpp", flush=True)

    # one GOP against the CPU backend
    g0 = gop(vid, cfg, 0)
    rec_g = api.expand(VideoStream.from_bytes(blobs[0]))
    psnr_g = video_psnr(g0, rec_g)[0]
    r = ref.get("lossy")
    blob_c, psnr_c = r["blob"].tobytes(), float(r["psnr_y"])
    d_psnr = abs(psnr_g - psnr_c)
    d_bytes = abs(len(blobs[0]) - len(blob_c)) / len(blob_c)
    print(f"[lossy] GOP 0 vs cpu: PSNR-Y {psnr_g:.4f} vs {psnr_c:.4f} dB "
          f"(|d| {d_psnr:.4f} <= {PSNR_TOL_DB}), bytes {len(blobs[0])} vs "
          f"{len(blob_c)} (|d| {100 * d_bytes:.3f}% <= {100 * BYTES_TOL}%)",
          flush=True)
    check(d_psnr <= PSNR_TOL_DB, "PSNR-Y differs from the cpu run")
    check(d_bytes <= BYTES_TOL, "byte count differs from the cpu run")


def phase_multichip(vid: Video, cfg: CodecConfig, n: int) -> None:
    """Both distributed encodes against their one-device equivalents, one
    after another; each time includes that encode's compiles."""
    from qsvc_tpu.parallel import distributed as pdist
    mesh = pdist.make_gop_mesh(n)
    ids = [d.id for d in mesh.devices.ravel()]
    jobs = {
        "api.compress": lambda: api.compress(
            vid, cfg, reversible=False).to_bytes(),
        "compress_distributed": lambda: pdist.compress_distributed(
            vid, cfg, mesh, reversible=False).to_bytes(),
        "api.compress_gops": lambda: [s.to_bytes() for s in api.compress_gops(
            vid, cfg, reversible=False)],
        "encode_gops_distributed": lambda: pdist.encode_gops_distributed(
            vid, cfg, mesh, reversible=False),
    }
    log = trace.RunLog()
    prev = trace.set_run_log(log)
    res = {}
    try:
        for name, fn in jobs.items():
            t0 = time.time()
            res[name] = fn()
            print(f"[multichip] {name}: {time.time() - t0:.1f} s incl. "
                  f"compile", flush=True)
    finally:
        trace.set_run_log(prev)

    def placement(path):
        return {r["gop"]: r["devices"] for r in log.records
                if r["stage"] == "distributed.gop_devices"
                and r["path"] == path}

    k = cfg.GOPs // n
    got_sh = placement("compress_distributed")
    got_pg = placement("encode_gops_distributed")
    print(f"[multichip] {n} devices {ids}; compress_distributed chunk "
          f"placement {got_sh}; encode_gops_distributed GOP placement "
          f"{got_pg}", flush=True)
    check(got_sh == {c: [ids[c]] for c in range(n)},
          f"compress_distributed placement {got_sh}")
    check(got_pg == {g: [ids[g // k]] for g in range(cfg.GOPs)},
          f"encode_gops_distributed placement {got_pg}")
    check(res["compress_distributed"] == res["api.compress"],
          "compress_distributed bytes != api.compress on one device")
    check(res["encode_gops_distributed"] == res["api.compress_gops"],
          "encode_gops_distributed bytes != api.compress_gops")
    print(f"[multichip] compress_distributed == api.compress "
          f"({len(res['api.compress'])} bytes) and "
          f"encode_gops_distributed == api.compress_gops "
          f"({sum(map(len, res['api.compress_gops']))} bytes), byte for "
          f"byte; every GOP on its own card", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="4: run only the GOP-sharded encode on 4 GPUs")
    args = ap.parse_args(argv)
    ref = None
    try:
        card = phase_device(args.chips)
        phase_native()
        if args.chips == 1:
            ref = CpuReference()
        vid = w1_video()
        if args.chips > 1:
            phase_multichip(vid, W1, args.chips)
        else:
            phase_stages(vid, W1, ref)
            phase_lossless(vid, W1)
            phase_lossy(vid, W1, ref, card)
    except Exception as e:  # report and fail: no result line
        import traceback
        traceback.print_exc()
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if ref is not None:
            ref.close()
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
