"""Host CPU identity, for artefacts that hold machine code.

XLA:CPU persistent-cache entries are AOT machine code for the host that
compiled them.  Loading one on a host with a different CPU can crash
(observed: a full-suite segfault in
``compilation_cache.get_executable_and_time`` deserializing entries a
different machine — avx512 feature set — had written into
``tests/.jax_cache`` on a shared filesystem).  The test suite therefore
keys its XLA:CPU compile cache with :func:`machine_cache_dir`; the
program's own cache follows ``JAX_COMPILATION_CACHE_DIR`` or the fixed
default set in the package ``__init__``, independent of the host.

The native entropy coder (``native/ebcot.cpp``) reads
:func:`cpu_identity` to choose its one ISA-specific flag (``-mbmi2``)."""

from __future__ import annotations

import hashlib
import os
import platform


def cpu_identity() -> str:
    """The first processor block's vendor, model, stepping and ISA flags.

    Hashes the model identity as well as the flags: XLA:CPU bakes
    model-derived tuning pseudo-features (e.g. +prefer-no-gather) into AOT
    entries, so two hosts with identical flag sets but a different
    model/stepping still produce incompatible entries (observed: a
    foreign-entry load warning under a flags-only key)."""
    ident = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features", "vendor_id",
                                    "cpu family", "model", "stepping")):
                    ident.append(line.strip())
                if line.strip() == "" and ident:
                    break               # first processor block only
    except OSError:
        pass
    return "\n".join(ident)


def host_fingerprint() -> str:
    """Architecture plus a short hash of :func:`cpu_identity`."""
    key = platform.machine()
    ident = cpu_identity()
    if ident:
        key += "-" + hashlib.sha1(ident.encode()).hexdigest()[:12]
    return key


def machine_cache_dir(base: str) -> str:
    path = os.path.join(base, host_fingerprint())
    os.makedirs(path, exist_ok=True)
    return path


def configure(jax, base: str) -> None:
    """Point jax's persistent compile cache at the machine-keyed subdir
    of ``base``."""
    jax.config.update("jax_compilation_cache_dir", machine_cache_dir(base))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
