"""Two-process jax.distributed bring-up: the multi-HOST analog of the
reference's network device (`-connect host1 host2`,
devices/renderer/renderer.cpp:948-956) — two coordinator-joined
processes form one global CPU mesh and the production sharded render
step executes collectives across them."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys
sys.path.insert(0, %(repo)r)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from yulio_raytracer.parallel import sharding

pid = int(sys.argv[1])
sharding.init_distributed(%(coord)r, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()

from yulio_raytracer.io import builtin_scenes
from yulio_raytracer.integrator import pathtracer as pt

scene = builtin_scenes.cornell_box(with_boxes=False).commit()
cam = builtin_scenes.cornell_camera(16, 16)
mesh = sharding.make_mesh(4)
film = sharding.render_frame_sharded(scene, cam, pt.PTParams(max_depth=2),
                                     16, 16, spp=1, mesh=mesh, seed=3)
from jax.experimental import multihost_utils
import numpy as np
rgb = np.asarray(multihost_utils.process_allgather(
    film.rgb_sum, tiled=True))
if pid == 0:
    np.savez(%(out)r, rgb=rgb)
print("proc", pid, "ok", rgb.shape)
"""


def test_import_does_not_initialize_backend():
    """jax.distributed.initialize() must run before ANY backend touch,
    so importing the package (the full integrator/sharding chain) must
    not create device values at module scope — a module-level jnp
    constant broke multi-host bring-up once already (ops/intersect.py
    INF)."""
    script = (
        "import os\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=2'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from jax._src import xla_bridge\n"
        "from yulio_raytracer.parallel import sharding\n"
        "from yulio_raytracer.api import output, session, cli\n"
        "assert not xla_bridge._backends, "
        "'package import initialized the XLA backend'\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "dist.npz")
    script = CHILD % dict(repo=REPO, coord="127.0.0.1:%d" % port, out=out)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    rgb = np.load(out)["rgb"]

    # reference: the same step on this process's local (8-device) mesh —
    # sharded renders agree across device counts to float association
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.parallel import sharding

    scene = builtin_scenes.cornell_box(with_boxes=False).commit()
    cam = builtin_scenes.cornell_camera(16, 16)
    film = sharding.render_frame_sharded(scene, cam,
                                         pt.PTParams(max_depth=2),
                                         16, 16, spp=1,
                                         mesh=sharding.make_mesh(4),
                                         seed=3)
    ref = np.asarray(film.rgb_sum)
    np.testing.assert_allclose(rgb, ref, rtol=3e-6, atol=3e-7)
