import numpy as np
import jax.numpy as jnp

from yulio_raytracer.geometry import mesh, primitives
from yulio_raytracer.ops import intersect


def _oracle_mt(v0, e1, e2, cull, org, dirn, tnear, tfar):
    """Brute-force numpy closest-hit oracle."""
    R, T = len(org), len(v0)
    tbest = np.full(R, np.inf)
    tri = np.full(R, -1, np.int64)
    ub = np.zeros(R)
    vb = np.zeros(R)
    for j in range(T):
        pvec = np.cross(dirn, e2[j])
        det = pvec @ e1[j]
        ng = np.cross(e1[j], e2[j])
        cull_ok = (dirn @ ng < 0) if cull[j] == 1 else np.ones(R, bool)
        with np.errstate(divide='ignore', invalid='ignore'):
            inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
            tvec = org - v0[j]
            u = np.sum(tvec * pvec, axis=1) * inv
            qvec = np.cross(tvec, e1[j])
            v = (dirn * qvec).sum(1) * inv
            t = (qvec @ e2[j]) * inv
        ok = ((np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > tnear) & (t < tfar) & cull_ok)
        better = ok & (t < tbest)
        tbest = np.where(better, t, tbest)
        tri = np.where(better, j, tri)
        ub = np.where(better, u, ub)
        vb = np.where(better, v, vb)
    return tbest, tri, ub, vb


def _random_scene(num_meshes=5, seed=0):
    rs = np.random.RandomState(seed)
    meshes = []
    for i in range(num_meshes):
        nv = rs.randint(6, 30)
        pos = rs.randn(nv, 3).astype(np.float32) * 2
        nt = rs.randint(4, 24)
        tri = rs.randint(0, nv, (nt, 3)).astype(np.int32)
        meshes.append(mesh.HostMesh(pos, tri, material=i,
                                    cull=int(rs.rand() < 0.5)))
    return meshes


def test_brute_matches_oracle_random():
    meshes = _random_scene()
    packed = mesh.pack_meshes(meshes, pad_multiple=64)
    geom = mesh.to_device(packed)
    rs = np.random.RandomState(1)
    R = 256
    org = rs.randn(R, 3).astype(np.float32) * 4
    dirn = rs.randn(R, 3).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    tnear = np.full(R, 1e-4, np.float32)
    tfar = np.full(R, np.inf, np.float32)

    hit = intersect.intersect_brute(geom, jnp.asarray(org), jnp.asarray(dirn),
                                    jnp.asarray(tnear), jnp.asarray(tfar),
                                    block=64)
    t0, tri0, u0, v0 = _oracle_mt(packed.v0, packed.e1, packed.e2, packed.cull,
                                  org, dirn, tnear, tfar)
    t = np.asarray(hit.t)
    tri = np.asarray(hit.tri)
    # distances must agree (tri index may differ on exact ties)
    np.testing.assert_allclose(np.where(np.isfinite(t), t, 0),
                               np.where(np.isfinite(t0), t0, 0),
                               rtol=2e-4, atol=1e-5)
    assert (np.isfinite(t) == np.isfinite(t0)).all()
    same = tri == tri0
    assert same.mean() > 0.99  # ties are rare
    np.testing.assert_allclose(np.asarray(hit.u)[same],
                               u0[same], rtol=1e-2, atol=2e-3)


def test_occluded_matches_intersect():
    meshes = _random_scene(3, seed=3)
    packed = mesh.pack_meshes(meshes, pad_multiple=64)
    geom = mesh.to_device(packed)
    rs = np.random.RandomState(4)
    R = 128
    org = rs.randn(R, 3).astype(np.float32) * 4
    dirn = rs.randn(R, 3).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    tnear = jnp.full((R,), 1e-4)
    tfar = jnp.full((R,), jnp.inf)
    hit = intersect.intersect_brute(geom, jnp.asarray(org), jnp.asarray(dirn),
                                    tnear, tfar, block=64)
    occ = intersect.occluded_brute(geom, jnp.asarray(org), jnp.asarray(dirn),
                                   tnear, tfar, block=64)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(hit.valid))


def test_backface_culling():
    # single CCW triangle in z=0 plane, normal +z
    m = primitives.single_triangle([0, 0, 0], [1, 0, 0], [0, 1, 0],
                                   cull=mesh.CULL_BACK)
    geom = mesh.to_device(mesh.pack_meshes([m], pad_multiple=8))
    org_front = jnp.asarray([[0.2, 0.2, 1.0]])   # above, looking down -z
    org_back = jnp.asarray([[0.2, 0.2, -1.0]])   # below, looking up +z
    down = jnp.asarray([[0.0, 0.0, -1.0]])
    up = jnp.asarray([[0.0, 0.0, 1.0]])
    tn = jnp.zeros((1,))
    tf = jnp.full((1,), jnp.inf)
    hit_front = intersect.intersect_brute(geom, org_front, down, tn, tf, block=8)
    hit_back = intersect.intersect_brute(geom, org_back, up, tn, tf, block=8)
    assert bool(hit_front.valid[0])       # front face visible
    assert not bool(hit_back.valid[0])    # back face culled
    # without culling both hit
    m2 = primitives.single_triangle([0, 0, 0], [1, 0, 0], [0, 1, 0])
    geom2 = mesh.to_device(mesh.pack_meshes([m2], pad_multiple=8))
    assert bool(intersect.intersect_brute(geom2, org_back, up, tn, tf,
                                          block=8).valid[0])


def test_post_intersect_interpolation():
    # unit right triangle with distinct per-vertex normals and uvs
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tri = np.array([[0, 1, 2]], np.int32)
    nrm = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    m = mesh.HostMesh(pos, tri, nrm, uv, material=7)
    geom = mesh.to_device(mesh.pack_meshes([m], pad_multiple=8))
    org = jnp.asarray([[0.25, 0.25, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(geom, org, d, jnp.zeros((1,)),
                                    jnp.full((1,), jnp.inf), block=8)
    dg = intersect.post_intersect(geom, org, d, hit)
    np.testing.assert_allclose(np.asarray(dg['P'][0]), [0.25, 0.25, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(dg['st'][0]), [0.25, 0.25],
                               atol=1e-6)
    expected_ns = 0.5 * nrm[0] + 0.25 * nrm[1] + 0.25 * nrm[2]
    expected_ns /= np.linalg.norm(expected_ns)
    np.testing.assert_allclose(np.asarray(dg['Ns'][0]), expected_ns, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dg['Ng'][0]), [0, 0, 1], atol=1e-6)
    assert int(dg['mat_id'][0]) == 7


def test_sphere_tessellation_hits_like_sphere():
    m = primitives.tessellate_sphere([0, 0, 0], 1.0, 32, 64)
    geom = mesh.to_device(mesh.pack_meshes([m]))
    rs = np.random.RandomState(5)
    R = 64
    d = rs.randn(R, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = -3.0 * d  # aim at center from distance 3
    hit = intersect.intersect_brute(geom, jnp.asarray(org, jnp.float32),
                                    jnp.asarray(d, jnp.float32),
                                    jnp.zeros((R,)), jnp.full((R,), jnp.inf))
    assert bool(hit.valid.all())
    np.testing.assert_allclose(np.asarray(hit.t), 2.0, atol=0.01)
