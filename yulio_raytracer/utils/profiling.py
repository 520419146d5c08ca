"""Profiling / tracing hooks — the aux observability subsystem.

The reference exposes per-frame fps/ms/mrps prints
(integratorrenderer.cpp:101-111) plus Embree's BENCHMARK_BUILD build
metrics (`-rtcore benchmark=1`, scripts/benchmark.py:245).  Here:

* `FrameStats` (renderer.py) carries rays + seconds per frame;
* `trace(dir)` wraps `jax.profiler.trace` — a real XLA device trace
  (HLO-op timeline, kernel durations) viewable in
  TensorBoard/Perfetto;
* `annotate(name)` labels a region inside a trace (TraceAnnotation);
* `CommitStats` records scene-commit metrics (the BENCHMARK_BUILD
  analog): BVH build seconds, node count, leaf size, packing seconds.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA device trace into log_dir (TensorBoard format)."""
    import jax
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Label a host region inside an active trace."""
    import jax
    return jax.profiler.TraceAnnotation(name)


@dataclass
class CommitStats:
    """Scene-commit metrics (Embree BENCHMARK_BUILD analog)."""
    triangles: int = 0
    bvh_nodes: int = 0
    leaf_size: int = 0
    bvh_seconds: float = 0.0
    total_seconds: float = 0.0


def committed_stats(builder, **commit_kw) -> tuple:
    """Commit a SceneBuilder while measuring build metrics.
    Returns (scene, CommitStats)."""
    t0 = time.perf_counter()
    scene = builder.commit(**commit_kw)
    total = time.perf_counter() - t0
    return scene, CommitStats(
        triangles=scene.num_triangles,
        bvh_nodes=(0 if scene.bvh is None
                   else int(scene.bvh['lo'].shape[0])),
        leaf_size=scene.leaf_size,
        total_seconds=total,
    )
