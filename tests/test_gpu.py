"""On-card tier: runs the COMPILED GPU traversal kernel on a real GPU.

The default suite runs on the CPU and checks the kernel in the Pallas
interpreter (tests/test_traverse_kernel.py).  These tests compile it for
the card; every test here asks for the `gpu` fixture, which skips with a
reason when JAX's backend is not a GPU.  They decide inside the fixture,
never at import, so collection looks the same everywhere.

    YRT_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu.py

`python chip_smoke.py` runs the same checks at production size.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from yulio_raytracer.geometry import mesh, bvh, primitives
from yulio_raytracer.ops import intersect, traverse
from yulio_raytracer.ops import traverse_triton as ttk

pytestmark = pytest.mark.gpu


@pytest.fixture(scope='module')
def gpu():
    if jax.default_backend() != 'gpu':
        pytest.skip('on-card tier: JAX backend is %r, not a GPU'
                    % jax.default_backend())


@pytest.fixture(scope='module')
def built(gpu):
    packed = mesh.pack_meshes([
        primitives.tessellate_sphere([0, 0, 0], 1.0, 12, 16),
        primitives.quad([-5, -1.2, -5], [5, -1.2, -5], [5, -1.2, 5],
                        [-5, -1.2, 5]),
        primitives.single_triangle([2, 0, 0], [3, 0, 0], [2, 1, 0],
                                   cull=mesh.CULL_BACK)], pad_multiple=64)
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=8)
    host = {k: getattr(packed, k) for k in bvh._PER_TRIANGLE_KEYS
            if getattr(packed, k) is not None}
    host = bvh.permute_geom(host, tree.order)
    geom = {k: jnp.asarray(v) for k, v in host.items()}
    return geom, bvh.to_device(tree)


def _rays(n=5000, seed=0):
    rs = np.random.RandomState(seed)
    org = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tf = np.where(np.arange(n) % 11 == 0, -1.0, np.inf).astype(np.float32)
    return (jnp.asarray(org), jnp.asarray(d), jnp.zeros((n,)),
            jnp.asarray(tf))


@pytest.mark.parametrize('block', [32, 64, 128])
def test_kernel_matches_xla_compiled(built, block):
    geom, tree = built
    o, d, tn, tf = _rays()
    ref = traverse.intersect_bvh(geom, tree, o, d, tn, tf, leaf_size=8)
    got = jax.jit(lambda *a: ttk.intersect_bvh(geom, tree, *a,
                                               block=block))(o, d, tn, tf)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    hit = np.asarray(ref.tri) >= 0
    np.testing.assert_allclose(np.asarray(got.t)[hit],
                               np.asarray(ref.t)[hit], rtol=1e-5)
    tf2 = jnp.where(tf > 0, 3.0, tf)
    occ = ttk.occluded_bvh(geom, tree, o, d, tn, tf2, block=block)
    occ_ref = traverse.occluded_bvh(geom, tree, o, d, tn, tf2, leaf_size=8)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))


def test_kernel_matches_brute_compiled(built):
    geom, tree = built
    o, d, tn, tf = _rays(seed=1)
    got = ttk.intersect_bvh(geom, tree, o, d, tn, tf)
    ref = intersect.intersect_brute(geom, o, d, tn, tf)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))


def test_renderer_selects_kernel_on_gpu(gpu):
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    scene = builtin_scenes.sphere_glass().commit()
    assert scene.bvh is not None
    assert pt.traversal_kind(scene) == 'kernel'


def test_cornell_golden_on_gpu(gpu):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'scripts'))
    import make_goldens as mg
    for name in ('cornell_64', 'sponza_64'):
        img = mg.render_config(name)
        ref = np.load(mg.golden_path(name))['img']
        assert mg.psnr(img, ref) >= 40.0, name
