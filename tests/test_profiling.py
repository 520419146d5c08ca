"""Observability hooks: XLA device tracing + commit metrics (the
reference's fps/mrps prints + Embree BENCHMARK_BUILD analog)."""
import os
import subprocess
import sys

from yulio_raytracer.utils import profiling
from yulio_raytracer.io import builtin_scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TRACE_DRIVER = """
import glob, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from yulio_raytracer.utils import profiling
out = sys.argv[1]
with profiling.trace(out):
    with profiling.annotate("tiny-matmul"):
        x = jnp.ones((128, 128))
        jax.block_until_ready(x @ x)
# jax.profiler.trace writes plugins/profile/<run>/*.xplane.pb
found = glob.glob(os.path.join(out, '**', '*.xplane.pb'), recursive=True)
sys.exit(0 if found else 1)
"""


def test_trace_writes_profile(tmp_path):
    """Runs in a fresh subprocess: the xplane dump serializes the whole
    process's accumulated XLA state, so tracing inside the long-lived
    suite process takes 30-90 s and depends on test order."""
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, '-c', _TRACE_DRIVER,
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, \
        f"no trace artifact written\n{r.stdout}\n{r.stderr}"


def test_commit_stats():
    sb = builtin_scenes.cornell_box()
    scene, st = profiling.committed_stats(sb)
    assert st.triangles == scene.num_triangles
    assert st.total_seconds > 0
    # every scene with triangles gets a BVH (scene.BRUTE_FORCE_MAX_TRIS)
    assert st.bvh_nodes == scene.bvh['lo'].shape[0] > 0
    sb2 = builtin_scenes.cornell_box()
    scene2, st2 = profiling.committed_stats(sb2, force_bvh=True,
                                            leaf_size=8)
    assert st2.bvh_nodes > 1
    assert st2.leaf_size == 8
