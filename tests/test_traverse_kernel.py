"""The GPU traversal kernel (ops/traverse_triton.py) on the CPU, through
the Pallas interpreter: the same kernel the card compiles, checked
against the XLA traversal (ops/traverse.py) and brute force
(ops/intersect.py).  Also the ray-sort helpers it runs behind
(ops/raysort.py) and the renderer's choice of traversal."""
import inspect

import numpy as np
import pytest
import jax.numpy as jnp

from yulio_raytracer.geometry import mesh, bvh, primitives
from yulio_raytracer.ops import intersect, raysort, traverse
from yulio_raytracer.ops import traverse_triton as ttk
from yulio_raytracer.integrator import pathtracer as pt


def _scene(leaf):
    packed = mesh.pack_meshes([
        primitives.tessellate_sphere([0, 0, 0], 1.0, 12, 16),
        primitives.tessellate_sphere([1.6, 0.4, -0.5], 0.5, 8, 10),
        primitives.quad([-5, -1.2, -5], [5, -1.2, -5], [5, -1.2, 5],
                        [-5, -1.2, 5]),
        primitives.single_triangle([2, 0, 0], [3, 0, 0], [2, 1, 0],
                                   cull=mesh.CULL_BACK)], pad_multiple=64)
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=leaf)
    host = {k: getattr(packed, k) for k in bvh._PER_TRIANGLE_KEYS
            if getattr(packed, k) is not None}
    host = bvh.permute_geom(host, tree.order)
    geom = {k: jnp.asarray(v) for k, v in host.items()}
    return geom, bvh.to_device(tree)


def _rays(n=1000, seed=0):
    """n rays (not a block multiple) from a box around the scene; every
    7th lane is dead (tfar < tnear)."""
    rs = np.random.RandomState(seed)
    org = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = np.arange(n) % 7 == 0
    return (jnp.asarray(org), jnp.asarray(d), jnp.zeros((n,)),
            jnp.asarray(np.where(dead, -1.0, np.inf).astype(np.float32)),
            dead)


@pytest.mark.parametrize('leaf', [4, 8, 32])
def test_kernel_closest_matches_xla_and_brute(leaf):
    geom, tree = _scene(leaf)
    o, d, tn, tf, dead = _rays(seed=leaf)
    got = ttk.intersect_bvh(geom, tree, o, d, tn, tf, interpret=True)
    ref = traverse.intersect_bvh(geom, tree, o, d, tn, tf, leaf_size=leaf)
    brute = intersect.intersect_brute(geom, o, d, tn, tf)
    tri = np.asarray(got.tri)
    assert got.t.shape == (1000,)
    np.testing.assert_array_equal(tri, np.asarray(ref.tri))
    np.testing.assert_array_equal(tri, np.asarray(brute.tri))
    assert (tri[dead] == -1).all() and (tri >= 0).sum() > 100
    hit = tri >= 0
    for a, b in ((got.t, ref.t), (got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(np.asarray(a)[hit], np.asarray(b)[hit],
                                   rtol=1e-5, atol=1e-6)
    assert np.isinf(np.asarray(got.t)[~hit]).all()


@pytest.mark.parametrize('leaf', [4, 8, 32])
def test_kernel_any_hit_matches_xla_and_brute(leaf):
    geom, tree = _scene(leaf)
    o, d, tn, tf, dead = _rays(seed=10 + leaf)
    tf = jnp.where(tf > 0, 2.5, tf)
    got = np.asarray(ttk.occluded_bvh(geom, tree, o, d, tn, tf,
                                      interpret=True))
    ref = traverse.occluded_bvh(geom, tree, o, d, tn, tf, leaf_size=leaf)
    brute = intersect.occluded_brute(geom, o, d, tn, tf)
    assert got.dtype == bool and got.shape == (1000,)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, np.asarray(brute))
    assert not got[dead].any() and 0 < got.sum() < got.size


@pytest.mark.parametrize('block', [32, 64, 128])
def test_kernel_sorted_wrappers_match_unsorted(block):
    geom, tree = _scene(8)
    o, d, tn, tf, _ = _rays(n=777, seed=3)
    lo, hi = (-5.0, -1.2, -5.0), (5.0, 1.2, 5.0)
    a = ttk.intersect_bvh(geom, tree, o, d, tn, tf, interpret=True,
                          block=block)
    b = ttk.intersect_bvh_sorted(geom, tree, o, d, tn, tf, lo, hi,
                                 interpret=True, block=block)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    tf2 = jnp.where(tf > 0, 2.0, tf)
    perm = raysort.hitpoint_sort_perm(o, lo, hi)
    oa = ttk.occluded_bvh(geom, tree, o, d, tn, tf2, interpret=True,
                          block=block)
    ob = ttk.occluded_bvh_sorted(geom, tree, o, d, tn, tf2, lo, hi,
                                 perm=perm, interpret=True, block=block)
    np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))


def test_ray_sort_key_layout():
    """Octant in bits 15-17, a 15-bit origin Morton code below."""
    org = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 1.0]])
    k = np.asarray(raysort.ray_sort_key(org, d, (0, 0, 0), (1, 1, 1)))
    assert k[0] == 0
    assert k[1] >> 15 == 7 and k[1] & 0x7FFF == 0x7FFF
    assert k[2] >> 15 == 2 and k[2] & 0x7FFF == 0b001001001001001
    assert (k < (1 << 18)).all()


def test_sorted_call_round_trip_and_dead_last():
    rs = np.random.RandomState(5)
    n = 300
    o = jnp.asarray(rs.rand(n, 3).astype(np.float32))
    d = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    tn = jnp.zeros((n,))
    tf = jnp.asarray(np.where(np.arange(n) % 3 == 0, -1.0, 1.0), jnp.float32)
    seen = {}

    def fn(o_s, d_s, tn_s, tf_s):
        seen['tf'] = np.asarray(tf_s)
        return o_s[:, 0] * 2.0, tf_s
    a, b = raysort.sorted_call(fn, 2, o, d, tn, tf, (0, 0, 0), (1, 1, 1))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(o[:, 0] * 2.0))
    np.testing.assert_array_equal(np.asarray(b), np.asarray(tf))
    n_dead = int((np.asarray(tf) <= 0).sum())
    assert (seen['tf'][-n_dead:] <= 0).all()
    assert (seen['tf'][:-n_dead] > 0).all()


def test_hitpoint_sort_perm_and_tile_perm():
    rs = np.random.RandomState(6)
    n = 64
    p = jnp.asarray(rs.rand(n, 3).astype(np.float32))
    live = jnp.asarray(np.arange(n) % 4 != 0)
    perm = np.asarray(raysort.hitpoint_sort_perm(p, (0, 0, 0), (1, 1, 1),
                                                 live=live))
    assert sorted(perm.tolist()) == list(range(n))
    assert not np.asarray(live)[perm[-16:]].any()
    key = np.asarray(raysort.ray_sort_key(p, jnp.ones_like(p), (0, 0, 0),
                                          (1, 1, 1))) & 0x7FFF
    live_perm = perm[:48]
    assert (np.diff(key[live_perm].astype(np.int64)) >= 0).all()
    t = np.asarray(raysort.tile_perm(jnp.asarray(perm), 3, n))
    assert t.shape == (3 * n,)
    for s in range(3):
        np.testing.assert_array_equal(t[s * n:(s + 1) * n], perm + s * n)


@pytest.mark.parametrize('platform,motion,bvh_on,want', [
    ('gpu', False, True, 'kernel'),
    ('cpu', False, True, 'bvh'),
    ('gpu', True, True, 'bvh'),
    ('gpu', False, False, 'woop'),
    ('gpu', True, False, 'brute'),
])
def test_traversal_kind(platform, motion, bvh_on, want):
    """One traversal family per scene kind; the kernel only where it is
    compiled for the card."""
    import types
    geom = {'woop': None}
    if motion:
        geom['mv0'] = None
    scene = types.SimpleNamespace(bvh={} if bvh_on else None, geom=geom)
    assert pt.traversal_kind(scene, motion, platform) == want


def test_renderer_never_interprets_the_kernel(monkeypatch):
    """Off the GPU the renderer runs the XLA traversal: the kernel (which
    would need interpret mode here) is never entered, and no renderer
    path asks for interpret mode at all."""
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer import renderer

    def boom(*a, **k):
        raise AssertionError('GPU kernel called off the GPU')
    monkeypatch.setattr(ttk, '_call', boom)
    scene = builtin_scenes.cornell_box().commit(force_bvh=True)
    cam = builtin_scenes.cornell_camera(16, 16)
    film, _ = renderer.render_frame(scene, cam, pt.PTParams(max_depth=3),
                                    16, 16, spp=1, seed=0)
    assert np.isfinite(np.asarray(film.rgb_sum)).all()
    for mod in (pt, renderer):
        assert 'interpret=' not in inspect.getsource(mod)
