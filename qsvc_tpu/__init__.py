"""qsvc_tpu — a scalable video codec framework in JAX.

A from-scratch JAX/XLA re-creation of the capabilities of QSVC/MCJ2K
(t+2D MCTF wavelet video coding with JPEG2000-style EBCOT entropy coding and
quality/spatial/temporal scalable extraction).  See SURVEY.md for the map
from reference components to this package.
"""

__version__ = "0.2.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache: the 1080p encode programs take tens of
# seconds to compile, and a warm cache cuts a restart's warmup to loads.
# ``JAX_COMPILATION_CACHE_DIR`` (read by jax itself) wins; otherwise the
# cache lives at a fixed path inside the checkout, so every process of one
# checkout shares it.
if _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))

from .config import CodecConfig, gop_size  # noqa: F401
