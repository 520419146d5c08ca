import numpy as np
import jax.numpy as jnp

from yulio_raytracer.geometry import mesh, primitives
from yulio_raytracer.ops import intersect


def _scene(seed=0):
    rs = np.random.RandomState(seed)
    meshes = [primitives.tessellate_sphere(rs.randn(3) * 3, 1.5, 10, 14)]
    for i in range(4):
        nv = rs.randint(8, 30)
        pos = (rs.randn(nv, 3) * 2 + rs.randn(3) * 5).astype(np.float32)
        tri = rs.randint(0, nv, (rs.randint(5, 25), 3)).astype(np.int32)
        meshes.append(mesh.HostMesh(pos, tri, cull=int(rs.rand() < 0.4)))
    return mesh.pack_meshes(meshes, pad_multiple=64)


def test_woop_matches_moller_trumbore():
    packed = _scene()
    geom = mesh.to_device(packed)    # includes 'woop'
    rs = np.random.RandomState(1)
    R = 512
    org = jnp.asarray(rs.randn(R, 3).astype(np.float32) * 6)
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tn = jnp.full((R,), 1e-4)
    tf = jnp.full((R,), jnp.inf)

    h_mt = intersect.intersect_brute(geom, org, d, tn, tf, block=64)
    h_wp = intersect.intersect_woop(geom, org, d, tn, tf, block=64)
    t_mt = np.asarray(h_mt.t)
    t_wp = np.asarray(h_wp.t)
    # identical hit sets, distances match to f32 tolerance
    assert (np.isfinite(t_mt) == np.isfinite(t_wp)).mean() > 0.999
    both = np.isfinite(t_mt) & np.isfinite(t_wp)
    np.testing.assert_allclose(t_mt[both], t_wp[both], rtol=5e-4, atol=1e-4)
    same_tri = (np.asarray(h_mt.tri)[both] == np.asarray(h_wp.tri)[both])
    assert same_tri.mean() > 0.99
    # barycentrics agree
    np.testing.assert_allclose(np.asarray(h_wp.u)[both][same_tri],
                               np.asarray(h_mt.u)[both][same_tri],
                               atol=5e-3)

    o_mt = intersect.occluded_brute(geom, org, d, tn, tf, block=64)
    o_wp = intersect.occluded_woop(geom, org, d, tn, tf, block=64)
    assert (np.asarray(o_mt) == np.asarray(o_wp)).mean() > 0.999


def test_woop_respects_culling():
    m = primitives.single_triangle([0, 0, 0], [1, 0, 0], [0, 1, 0],
                                   cull=mesh.CULL_BACK)
    geom = mesh.to_device(mesh.pack_meshes([m], pad_multiple=8))
    tn = jnp.zeros((1,))
    tf = jnp.full((1,), jnp.inf)
    down = jnp.asarray([[0.0, 0.0, -1.0]])
    up = jnp.asarray([[0.0, 0.0, 1.0]])
    assert bool(intersect.intersect_woop(
        geom, jnp.asarray([[0.2, 0.2, 1.0]]), down, tn, tf, block=8).valid[0])
    assert not bool(intersect.intersect_woop(
        geom, jnp.asarray([[0.2, 0.2, -1.0]]), up, tn, tf, block=8).valid[0])
