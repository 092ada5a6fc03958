"""The one place that knows which platform the program runs on.

The package runs on an NVIDIA GPU, where the hand-written kernels run
compiled, and on the CPU, where the same entry points run the plain XLA
formulations (the tests' platform). Any other backend is an error:
nothing falls back quietly to a slower path.
"""

import jax

from .errors import SdpRuntimeError

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """``"gpu"`` or ``"cpu"``: the default JAX backend; raises on any
    other."""
    name = jax.default_backend()
    if name not in PLATFORMS:
        raise SdpRuntimeError(
            f"unsupported JAX backend {name!r}: this package runs on "
            f"{' or '.join(PLATFORMS)}")
    return name


def use_gpu_kernels() -> bool:
    """True when the hand-written kernels run compiled (on the GPU)."""
    return platform() == "gpu"


def use_compile_cache(default_dir: str) -> str:
    """Keep JAX's persistent compile cache in ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else in ``default_dir``; returns the directory.

    For scripts (``bench.py``, ``chip_smoke.py``); the library itself
    sets no cache. Call before the first compilation.
    """
    import os

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_dir
    jax.config.update("jax_compilation_cache_dir", path)
    return path
