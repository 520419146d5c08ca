"""Test config: force an 8-virtual-device CPU platform BEFORE jax import.

Multi-device sharding paths are exercised on a host-platform mesh
(xla_force_host_platform_device_count=8); __graft_entry__.dryrun_multichip
rehearses the same code in a fresh process.

On-card tier: tests marked `gpu` (tests/test_gpu.py) run only where JAX
finds a GPU; they decide so inside a fixture, never at import, and skip
here with a reason.  On the card they run with

    YRT_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu.py

(`YRT_GPU_TESTS` keeps this file from forcing the CPU platform).
`python chip_smoke.py` drives the same checks end to end.
"""
import os
import sys

_GPU_TIER = bool(os.environ.get("YRT_GPU_TESTS"))
if not _GPU_TIER:
    os.environ["JAX_PLATFORMS"] = "cpu"
# Silence XLA:CPU AOT-loader warnings emitted on every persistent-cache
# hit (the compile/host feature lists differ only in the XLA pseudo-
# features +prefer-no-{scatter,gather}).
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
flags = os.environ.get("XLA_FLAGS", "")
if not _GPU_TIER and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Keep big numpy buffers in the heap arena (utils/hostmem.py docstring).
from yulio_raytracer.utils import hostmem  # noqa: E402

hostmem.tune_malloc()

import jax  # noqa: E402

# Persistent compile cache: the suite is compile-dominated, so warm runs
# reload XLA:CPU results from disk instead of re-jitting every render
# graph — the same mechanism the CLI/session use.  JAX_COMPILATION_CACHE_DIR
# wins when set; otherwise the checkout's own .jax_cache.
from yulio_raytracer.utils import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
if not _GPU_TIER:
    # XLA:CPU's own caches too; on the GPU, XLA's shared kernel cache
    # fails a RET_CHECK (kernel_reuse_cache.cc) when reloaded
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")
