"""Multi-host distribution: ``jax.distributed`` runtime, (host x chip)
meshes, GOP sharding across hosts, and the distributed byte-stream
gather.

The reference has no distribution at all — its "transport" is copying
files between directories (trunk/readme.txt:27-29, SURVEY §2.4/§5).
Here the sequence's GOP axis shards over every chip of every host:

* ``initialize()`` wires the process into the JAX distributed runtime
  (coordinator + process id, one call per host) so the global device
  list spans all hosts;
* ``make_gop_mesh()`` builds a 1D ``gop`` mesh over the global devices
  in process order — consecutive GOPs land on chips of the same host,
  so the MCTF boundary-update halos (one frame per temporal level, see
  parallel/transform.py) travel between the devices of one host and
  cross the network only at host boundaries;
* ``encode_gops_distributed()`` runs the device-side encode step
  sharded over the mesh, then each HOST entropy-codes only the GOPs
  resident on its local devices (the per-code-block EBCOT work never
  leaves the host that holds the coefficients) and the per-GOP byte
  streams are gathered to every process with
  ``multihost_utils.process_allgather`` — the distributed analogue of
  the reference's per-GOP file drops.

Single-process fallback: with no distributed runtime every helper
degrades to the local-device mesh, so the same code path serves the
8-virtual-device CPU tests, the multi-device dry run, and the GPUs of
one host.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CodecConfig
from ..io.yuv import Video
from ..utils import trace
from . import mesh as pmesh
from . import transform as ptransform


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the JAX distributed runtime (multi-host).  Arguments default
    to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); on a single host with no
    coordinator configured this is a no-op."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    num_processes = int(num_processes if num_processes is not None
                        else os.environ["JAX_NUM_PROCESSES"])
    process_id = int(process_id if process_id is not None
                     else os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_gop_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1D ``gop`` mesh over the GLOBAL device list in process order
    (``jax.devices()`` already sorts by process), so each host owns a
    contiguous run of GOPs and inter-host halo traffic crosses the
    network only at the two run boundaries."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("gop",))


def shard_video_gops(video: Video, cfg: CodecConfig, mesh: Mesh):
    """(G*S+1)-frame planes -> (D, k*S+1, ...) device arrays sharded on
    the gop axis (boundary frames duplicated per the open-GOP rule;
    k = G / D GOPs per device when the sequence outnumbers devices)."""
    D = mesh.devices.size
    G = cfg.GOPs
    assert G % D == 0, (G, D)
    S = cfg.gop_size * (G // D)
    out = []
    for plane in video.planes():
        g = pmesh.shard_gops(np.asarray(plane), S)
        out.append(jax.device_put(
            g, NamedSharding(mesh, P("gop", *([None] * (g.ndim - 1))))))
    return tuple(out)


def encode_gops_distributed(video: Video, cfg: CodecConfig,
                            mesh: Optional[Mesh] = None,
                            reversible: bool = False) -> List[bytes]:
    """Distributed encode: device MCTF+DWT sharded over the mesh, per-host
    EBCOT of the locally resident GOPs, cross-host gather of the per-GOP
    byte streams.  Returns the ordered list of self-contained per-GOP
    streams (every process returns the full list)."""
    from .. import api

    mesh = mesh or make_gop_mesh()
    G = cfg.GOPs
    D = mesh.devices.size
    assert G % D == 0, (G, D)
    k = G // D                          # GOPs per device
    gop_cfg = cfg.replace(GOPs=1)
    S = cfg.gop_size

    # GOP -> owning process, per the mesh's device order: each host
    # transforms and entropy-codes only its own GOPs (closed-GOP mode;
    # the halo-exact open-GOP transform lives in analyze_sharded)
    local_gops = [i for i in range(G)
                  if mesh.devices.ravel()[i // k].process_index
                  == jax.process_index()]

    chunks = {g: Video(*(np.asarray(p[g * S:(g + 1) * S + 1])
                         for p in video.planes())) for g in local_gops}
    if gop_cfg.texture_backend != "internal":
        # alternative texture backends are host codecs (codec/backends.py)
        payloads: List[Tuple[int, bytes]] = [
            (g, api.compress(c, gop_cfg, reversible=reversible).to_bytes())
            for g, c in chunks.items()]
    else:
        # each GOP is uploaded to and encoded on the mesh device that owns
        # it; all local GOPs are dispatched before any is drained, so the
        # devices run concurrently while the host entropy-codes in order
        devs = mesh.devices.ravel()
        pendings = {}
        for g, c in chunks.items():
            with jax.default_device(devs[g // k]):
                pendings[g] = api.compress_dispatch(c, gop_cfg,
                                                    reversible=reversible)
            _record_placement("encode_gops_distributed", g, pendings[g])
        payloads = [(g, api.compress_finish(p).to_bytes())
                    for g, p in pendings.items()]

    if jax.process_count() == 1:
        return [p for _, p in sorted(payloads)]
    return _allgather_indexed_bytes(payloads, G)


def _record_placement(path: str, gop: int, pending: dict) -> None:
    """Trace event naming the devices that hold one GOP's dispatched
    encode (its compacted code-block stacks)."""
    devs = (pending["pend_l"][1].devices() | pending["pend_c"][1].devices())
    trace.event("distributed.gop_devices", path=path, gop=gop,
                devices=sorted(d.id for d in devs))


def _allgather_indexed_bytes(payloads: List[Tuple[int, bytes]],
                             total: int) -> List[bytes]:
    """Cross-host gather of ``total`` index-tagged byte blobs: fixed-size
    frames (index + length prefix, padded to the global max) so ONE
    all-gather ships every stream to every process."""
    from jax.experimental import multihost_utils
    local_max = max((len(p) for _, p in payloads), default=0)
    gmax = int(multihost_utils.process_allgather(
        np.asarray([local_max], np.int64)).max())
    buf = np.zeros((len(payloads), gmax + 12), np.uint8)
    for row, (g, p) in enumerate(payloads):
        buf[row, :8] = np.frombuffer(
            np.asarray([g], np.int64).tobytes(), np.uint8)
        buf[row, 8:12] = np.frombuffer(
            np.asarray([len(p)], np.int32).tobytes(), np.uint8)
        buf[row, 12:12 + len(p)] = np.frombuffer(p, np.uint8)
    gathered = multihost_utils.process_allgather(buf)
    gathered = gathered.reshape(-1, gathered.shape[-1])
    out: List[Optional[bytes]] = [None] * total
    for row in gathered:
        g = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        n = int(np.frombuffer(row[8:12].tobytes(), np.int32)[0])
        out[g] = row[12:12 + n].tobytes()
    assert all(p is not None for p in out)
    return out  # type: ignore[return-value]


def _addressable_by_gop(arr) -> dict:
    """Split a leading-axis-sharded global array into its locally
    addressable per-index slices ({gop index: (…) device array})."""
    out = {}
    for s in arr.addressable_shards:
        g = s.index[0].start or 0
        for k in range(s.data.shape[0]):     # >1 GOP per device shard
            out[g + k] = s.data[k]
    return out


def compress_distributed(video: Video, cfg: CodecConfig,
                         mesh: Optional[Mesh] = None,
                         reversible: bool = False,
                         delta=None, lossless=None):
    """Halo-exact distributed encode: byte-identical to the sequential
    ``api.compress`` of the whole sequence.

    The device side runs ``analyze_sharded`` — the open-GOP MCTF whose
    ppermute halo exchanges reproduce the sequential transform's
    cross-GOP update coupling exactly (update.cpp shares the boundary
    even frame between adjacent GOPs) — then each HOST entropy-codes only
    the GOPs resident on its local devices through the very same
    ``api._dispatch_stream`` path the sequential encoder uses (per-frame
    encodes are stack-independent, so per-GOP stacks produce the same
    bytes), and the per-GOP fragments are all-gathered and reassembled
    into one sequential-layout :class:`VideoStream`.

    Contrast ``encode_gops_distributed``: that path encodes each GOP as
    an independent closed-GOP stream (separately decodable/shippable,
    byte-identical to ``api.compress_gops``); this one produces THE
    sequential whole-sequence stream.
    """
    from .. import api
    from ..codec.codestream import LevelSection, VideoStream
    from ..mctf.transform import LevelData, MCTFStream

    mesh = mesh or make_gop_mesh()
    video, cfg, true_dims, true_frames = api._pad_to_grid(video, cfg)
    cfg.validate()
    G = cfg.GOPs
    D = mesh.devices.size
    assert cfg.TRLs > 1, "distributed encode needs a temporal transform"
    assert G % D == 0, (G, D)
    k = G // D                          # GOPs per device chunk
    ccfg = cfg.replace(GOPs=k)          # one chunk's stream layout
    delta, lossless, coder = api._operating_point(cfg, reversible, delta,
                                                  lossless)

    gy, gu, gv = shard_video_gops(video, cfg, mesh)
    st = ptransform.analyze_sharded(jnp.asarray(gy), jnp.asarray(gu),
                                    jnp.asarray(gv), cfg, mesh)

    low_y = _addressable_by_gop(st.low_y)
    low_u = _addressable_by_gop(st.low_u)
    low_v = _addressable_by_gop(st.low_v)
    levs = [tuple(_addressable_by_gop(a) for a in
                  (lev.high_y, lev.high_u, lev.high_v, lev.mv, lev.is_B))
            for lev in st.levels]

    pendings = {}
    for c in sorted(low_y):
        # drop the duplicated right-boundary low frame everywhere but
        # the last chunk (the sequential low band has
        # G*(S/2^{T-1}) + 1 frames)
        trim = slice(None) if c == D - 1 else slice(None, -1)
        levels = tuple(LevelData(hy[c], hu[c], hv[c], mv[c], isb[c])
                       for (hy, hu, hv, mv, isb) in levs)
        sub = MCTFStream(low_y[c][trim], low_u[c][trim], low_v[c][trim],
                         levels)
        pendings[c] = api._dispatch_stream(sub, ccfg, reversible, delta,
                                           lossless, coder)
        _record_placement("compress_distributed", c, pendings[c])
    frags = {c: api.compress_finish(p) for c, p in sorted(pendings.items())}

    if jax.process_count() > 1:
        blobs = _allgather_indexed_bytes(
            [(c, f.to_bytes()) for c, f in frags.items()], D)
        frags = {c: VideoStream.from_bytes(b) for c, b in enumerate(blobs)}

    low = [fr for c in range(D) for fr in frags[c].low]
    levels_out: List[LevelSection] = []
    for t in range(cfg.TRLs - 1):
        high = [fr for c in range(D) for fr in frags[c].levels[t].high]
        motion = [m for c in range(D) for m in frags[c].levels[t].motion]
        ftypes = b"".join(bytes(frags[c].levels[t].frame_types)
                          for c in range(D))
        levels_out.append(LevelSection(high, motion, ftypes))
    return VideoStream(cfg, reversible, delta, low, levels_out,
                       true_dims=true_dims, true_frames=true_frames)


def measure_scaling(n_devices: int, reps: int = 2,
                    cfg: Optional[CodecConfig] = None) -> dict:
    """Scaling-efficiency harness: fps of the device encode step on ONE
    device vs ``n_devices`` (same per-GOP work), on whatever backend is
    active (a CPU mesh in tests, GPUs on a multi-GPU host).  Returns
    ``{fps_1, fps_n, efficiency}`` where efficiency =
    fps_n / (n * fps_1).

    The default config is deliberately non-toy (512x512, TRLs=3, real
    search): at the old 64x64 size XLA-CPU dispatch overhead swamped the
    compute and the ratio measured noise.  NOTE on CPU
    meshes: the N virtual devices share the host's physical cores, so
    fps_n is core-bound once N reaches the core count — efficiency there
    measures the sharded program's overhead (collectives, skew) only up
    to N <= cores."""
    import time
    from ..io import synthetic_video

    base = cfg or CodecConfig(pixels_in_x=512, pixels_in_y=512, TRLs=3,
                              block_size=32, search_range=4,
                              update_factor=0.25, SRLs=4)

    def run(n: int) -> float:
        c = base.replace(GOPs=n)
        vid = synthetic_video(c.pictures, c.pixels_in_y, c.pixels_in_x,
                              seed=0)
        m = pmesh.make_mesh(n)
        gy = pmesh.put_sharded(
            pmesh.shard_gops(vid.y.astype(np.int32), c.gop_size), m)
        gu = pmesh.put_sharded(
            pmesh.shard_gops(vid.u.astype(np.int32), c.gop_size), m)
        gv = pmesh.put_sharded(
            pmesh.shard_gops(vid.v.astype(np.int32), c.gop_size), m)
        out = ptransform.encode_step_sharded(
            jnp.asarray(gy), jnp.asarray(gu), jnp.asarray(gv), c, m)
        jax.block_until_ready(out)          # compile
        t0 = time.time()
        for _ in range(reps):
            out = ptransform.encode_step_sharded(
                jnp.asarray(gy), jnp.asarray(gu), jnp.asarray(gv), c, m)
            jax.block_until_ready(out)
        dt = (time.time() - t0) / reps
        return vid.frames / dt

    fps_1 = run(1)
    fps_n = run(n_devices)
    return {"n_devices": n_devices, "fps_1": fps_1, "fps_n": fps_n,
            "efficiency": fps_n / (n_devices * fps_1)}
