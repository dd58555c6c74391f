"""Multi-host distribution: two real OS processes joined through
``jax.distributed`` (localhost coordinator, CPU backend), GOPs split by
owning process, per-GOP byte streams gathered across hosts."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from qsvc_tpu.parallel import distributed as pdist

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject markers)

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=2, process_id=int(sys.argv[2]))
import numpy as np
sys.path.insert(0, %(repo)r)
from qsvc_tpu.config import CodecConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu import api
from qsvc_tpu.parallel import distributed as pdist

assert jax.process_count() == 2
assert len(jax.devices()) == 4          # 2 local x 2 processes

cfg = CodecConfig(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=4,
                  block_size=16, search_range=2, update_factor=0.25,
                  quantization_texture=0, SRLs=2)
vid = synthetic_video(cfg.pictures, 32, 32, seed=17)
mesh = pdist.make_gop_mesh(4)
streams = pdist.encode_gops_distributed(vid, cfg, mesh, reversible=True)
assert len(streams) == 4 and all(isinstance(s, bytes) and s
                                 for s in streams)
rec = api.expand_gops([api.VideoStream.from_bytes(s) for s in streams])
assert rec.y.shape == vid.y.shape
import hashlib
print("HASH", hashlib.sha256(b"".join(streams)).hexdigest(), flush=True)
print("PSNR", float(np.abs(rec.y.astype(int) - vid.y.astype(int)).mean()),
      flush=True)

# halo-exact open-GOP path: per-host entropy coding + fragment gather
# must reproduce the sequential whole-sequence stream on BOTH hosts
vs_d = pdist.compress_distributed(vid, cfg, mesh, reversible=True)
print("DHASH", hashlib.sha256(vs_d.to_bytes()).hexdigest(), flush=True)
"""


@pytest.mark.skipif(jax.process_count() > 1,
                    reason="already inside a distributed run")
def test_two_process_gop_encode(tmp_path):
    """Spawns 2 coordinator-joined processes; both must produce the SAME
    ordered stream list (the allgather is consistent) and a decodable
    sequence."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % {"repo": repo})
    coord = "localhost:19717"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = repo
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    h = [l.split()[1] for o in outs for l in o.splitlines()
         if l.startswith("HASH")]
    assert len(h) == 2 and h[0] == h[1], h
    dh = [l.split()[1] for o in outs for l in o.splitlines()
          if l.startswith("DHASH")]
    assert len(dh) == 2 and dh[0] == dh[1], dh
    # ... and the cross-host open-GOP stream must equal the byte stream
    # the sequential single-process encoder produces for the same input
    import hashlib
    from qsvc_tpu.config import CodecConfig
    from qsvc_tpu.io import synthetic_video
    from qsvc_tpu import api
    cfg = CodecConfig(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=4,
                      block_size=16, search_range=2, update_factor=0.25,
                      quantization_texture=0, SRLs=2)
    vid = synthetic_video(cfg.pictures, 32, 32, seed=17)
    seq = api.compress(vid, cfg, reversible=True).to_bytes()
    assert dh[0] == hashlib.sha256(seq).hexdigest()


def test_encode_gops_distributed_single_process():
    """Single-process degradation: same API, local mesh."""
    from qsvc_tpu.config import CodecConfig
    from qsvc_tpu.io import synthetic_video
    from qsvc_tpu import api
    n = min(len(jax.devices()), 4)
    if n < 2:
        pytest.skip("needs >= 2 devices")
    cfg = CodecConfig(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=n,
                      block_size=16, search_range=2, update_factor=0.25,
                      quantization_texture=0, SRLs=2)
    vid = synthetic_video(cfg.pictures, 32, 32, seed=17)
    mesh = pdist.make_gop_mesh(n)
    streams = pdist.encode_gops_distributed(vid, cfg, mesh, reversible=True)
    assert len(streams) == n
    rec = api.expand_gops([api.VideoStream.from_bytes(s) for s in streams])
    assert rec.y.shape == vid.y.shape


def test_distributed_semantics_match_local_paths():
    """Both distributed semantics are byte-identical to their local
    equivalents:

    * ``compress_distributed`` (halo-exact open-GOP, ppermute-coupled
      update) == sequential whole-sequence ``api.compress``;
    * ``encode_gops_distributed`` (closed-GOP, independently decodable
      per-GOP streams) == ``api.compress_gops``.
    """
    from qsvc_tpu.config import CodecConfig
    from qsvc_tpu.io import synthetic_video
    from qsvc_tpu import api
    n = min(len(jax.devices()), 4)
    if n < 2:
        pytest.skip("needs >= 2 devices")
    cfg = CodecConfig(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=n,
                      block_size=16, search_range=2, update_factor=0.25,
                      quantization_texture=0, SRLs=2)
    vid = synthetic_video(cfg.pictures, 32, 32, seed=31)
    mesh = pdist.make_gop_mesh(n)

    vs_dist = pdist.compress_distributed(vid, cfg, mesh, reversible=True)
    vs_seq = api.compress(vid, cfg, reversible=True)
    assert vs_dist.to_bytes() == vs_seq.to_bytes()

    blobs = pdist.encode_gops_distributed(vid, cfg, mesh, reversible=True)
    gops = api.compress_gops(vid, cfg, reversible=True)
    assert blobs == [s.to_bytes() for s in gops]


def test_scaling_harness_reports_efficiency():
    """Efficiency floor on the CPU mesh at n == physical core count.

    Methodology: virtual devices share the
    host cores, so n must not exceed them for the ratio to measure the
    sharded program's overhead (collectives, skew) rather than core
    scarcity; 128x128 keeps XLA-CPU compile time testable while staying
    far from the dispatch-overhead regime that made the old 64x64 toy
    number noise.  The floor is deliberately low: XLA-CPU splits each
    device's intra-op work across
    the SAME shared thread pool, so some cross-device interference is
    inherent to the emulation."""
    import os
    n = min(len(jax.devices()), os.cpu_count() or 1, 4)
    if n < 2:
        pytest.skip("needs >= 2 devices and >= 2 cores")
    cfg = pdist.CodecConfig(pixels_in_x=128, pixels_in_y=128, TRLs=2,
                            block_size=16, search_range=2,
                            update_factor=0.25, SRLs=3)
    r = pdist.measure_scaling(n, reps=2, cfg=cfg)
    assert r["fps_1"] > 0 and r["fps_n"] > 0
    # a quiet CPU host measured 0.712 at n=2.  The floor
    # sits well below that because in-suite timing shares the host with
    # whatever pytest ran before; it still catches a broken halo path,
    # which serializes the devices (efficiency ~0.5/n).
    assert r["efficiency"] >= 0.5, r


def test_distributed_multiple_gops_per_device():
    """G = 2*D — two GOPs per device: a device chunk is just a longer
    open-GOP sequence, so both distributed semantics must stay
    byte-identical to their local equivalents (lifting the r3 'one GOP
    per device' restriction)."""
    from qsvc_tpu.config import CodecConfig
    from qsvc_tpu.io import synthetic_video
    from qsvc_tpu import api
    d = min(len(jax.devices()), 2)
    if d < 2:
        pytest.skip("needs >= 2 devices")
    cfg = CodecConfig(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=2 * d,
                      block_size=16, search_range=2, update_factor=0.25,
                      quantization_texture=0, SRLs=2)
    vid = synthetic_video(cfg.pictures, 32, 32, seed=13)
    mesh = pdist.make_gop_mesh(d)

    vs_dist = pdist.compress_distributed(vid, cfg, mesh, reversible=True)
    vs_seq = api.compress(vid, cfg, reversible=True)
    assert vs_dist.to_bytes() == vs_seq.to_bytes()

    blobs = pdist.encode_gops_distributed(vid, cfg, mesh, reversible=True)
    gops = api.compress_gops(vid, cfg, reversible=True)
    assert blobs == [s.to_bytes() for s in gops]
