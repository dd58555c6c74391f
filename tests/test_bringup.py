"""Device bring-up guarantees that hold on any host: where the compile
cache lives, how the native coder's build is keyed, that the smoke test
refuses to run without a GPU, that no backend switch or kernel for
another accelerator remains, and that distributed GOPs run on the devices
that own them."""

import ast
import os
import subprocess
import sys

import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins; without it the cache is the fixed
    ``<checkout>/.jax_cache``, not keyed by the host CPU."""
    env = _clean_env(**({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
                        if from_env else {}))
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, qsvc_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120, check=True).stdout.strip().splitlines()[-1]
    want = str(tmp_path) if from_env else os.path.join(REPO, ".jax_cache")
    assert out == want


def test_chip_smoke_refuses_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_clean_env(), cwd=str(tmp_path), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def _backend_specific(path):
    """Imports of a Pallas dialect other than the GPU ones, and calls
    that branch on the backend, in one source file."""
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.ImportFrom) and node.module:
            mods = [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        else:
            mods = []
        for m in mods:
            if (m.startswith("jax.experimental.pallas.")
                    and m.split(".")[3] not in ("triton", "mosaic_gpu")):
                yield m
        if isinstance(node, ast.Attribute) and node.attr == "default_backend":
            yield "default_backend"


def test_no_backend_switch_or_foreign_kernels():
    """One implementation per stage: no module picks a path by backend,
    and none imports a Pallas dialect the GPU cannot lower."""
    files = [os.path.join(REPO, f) for f in
             ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for top in ("qsvc_tpu", "tests", "tools"):
        for root, _, names in os.walk(os.path.join(REPO, top)):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
    hits = {f: list(_backend_specific(f)) for f in files
            if os.path.exists(f)}
    assert not {f: h for f, h in hits.items() if h}


@pytest.mark.parametrize("change", ["source", "flags"])
def test_native_build_key(tmp_path, monkeypatch, change):
    """The native library's path is keyed by source and flags: a library
    built from other source or with other flags is never loaded."""
    from qsvc_tpu.codec import fast
    src = tmp_path / "ebcot.cpp"
    src.write_text("int x;\n")
    monkeypatch.setattr(fast, "_src_path", lambda: str(src))
    flags = ["-O3"]
    before = fast._so_path(flags)
    assert before == fast._so_path(list(flags))          # deterministic
    if change == "source":
        src.write_text("int y;\n")
    else:
        flags = flags + ["-mbmi2"]
    after = fast._so_path(flags)
    assert after != before
    assert os.path.dirname(after) == os.path.dirname(before)


def test_encode_gops_distributed_places_gops_on_owning_devices():
    from qsvc_tpu.config import CodecConfig
    from qsvc_tpu.io import synthetic_video
    from qsvc_tpu.parallel import distributed as pdist
    from qsvc_tpu.utils import trace
    n = 4
    assert len(jax.devices()) >= n
    cfg = CodecConfig(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=2 * n,
                      block_size=16, search_range=2, update_factor=0.25,
                      quantization_texture=0, SRLs=2)
    vid = synthetic_video(cfg.pictures, 32, 32, seed=3)
    mesh = pdist.make_gop_mesh(n)
    log = trace.RunLog()
    prev = trace.set_run_log(log)
    try:
        blobs = pdist.encode_gops_distributed(vid, cfg, mesh,
                                              reversible=True)
    finally:
        trace.set_run_log(prev)
    ids = [d.id for d in mesh.devices.ravel()]
    got = {r["gop"]: r["devices"] for r in log.records
           if r["stage"] == "distributed.gop_devices"
           and r["path"] == "encode_gops_distributed"}
    assert got == {g: [ids[g // 2]] for g in range(cfg.GOPs)}
    assert len(blobs) == cfg.GOPs and all(blobs)


def test_encode_gops_distributed_alternative_texture_backend():
    """A host texture codec (here zlib) is honoured per GOP, as in
    ``api.compress_gops``: same bytes, and those are not the internal
    coder's."""
    from qsvc_tpu import api
    from qsvc_tpu.config import CodecConfig
    from qsvc_tpu.io import synthetic_video
    from qsvc_tpu.parallel import distributed as pdist
    n = 2
    assert len(jax.devices()) >= n
    cfg = CodecConfig(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=n,
                      block_size=16, search_range=2, update_factor=0.25,
                      quantization_texture=0, SRLs=2,
                      texture_backend="zlib")
    vid = synthetic_video(cfg.pictures, 32, 32, seed=5)
    mesh = pdist.make_gop_mesh(n)
    blobs = pdist.encode_gops_distributed(vid, cfg, mesh, reversible=True)
    gops = api.compress_gops(vid, cfg, reversible=True)
    assert blobs == [s.to_bytes() for s in gops]
    internal = api.compress_gops(vid, cfg.replace(texture_backend="internal"),
                                 reversible=True)
    assert blobs != [s.to_bytes() for s in internal]
