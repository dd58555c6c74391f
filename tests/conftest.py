"""Test configuration: force the CPU backend with 8 virtual devices so
multi-device sharding tests run on any host.  The GPU path is checked by
``chip_smoke.py`` on a machine with a card (see README "Tests").

``jax.config.update`` (not only ``JAX_PLATFORMS``) pins the platform, so
the suite stays on the CPU even where jax was imported before pytest
started; it works because no backend has initialized yet.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# persistent compilation cache: the larger programs take seconds to tens
# of seconds to compile on XLA:CPU; cache them across test runs.  The dir
# is keyed by the host's CPU fingerprint — XLA:CPU cache entries are
# machine code, and loading another machine's entries segfaults
# (utils/cachedir.py has the incident note).
import sys  # noqa: E402
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from qsvc_tpu.utils import cachedir  # noqa: E402

if os.environ.get("QSVC_TEST_NO_COMPILE_CACHE"):
    # escape hatch: fully disable the persistent cache (overrides the
    # package-level default dir, which would otherwise kick in)
    jax.config.update("jax_compilation_cache_dir", None)
else:
    cachedir.configure(jax, os.path.join(os.path.dirname(__file__),
                                         ".jax_cache"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bounded_live_executables():
    """Drop jit caches after every test module.

    Root-caused incident (round 5): every XLA:CPU executable holds
    several mmap regions forever (pjit caches pin them); across the
    full suite the process crossed ``vm.max_map_count`` (measured
    63,885 maps of the 65,530 default just before a deterministic
    SIGSEGV inside XLA compile/serialize at test #288 — mmap failure
    surfaces as a segfault, not an error).  Clearing per module keeps
    the live-executable population bounded; the persistent compile
    cache makes the cross-module recompiles cheap loads."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
