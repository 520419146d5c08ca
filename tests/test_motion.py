"""Motion blur (the sphere_motion golden-scene feature)."""
import os
import numpy as np
import jax.numpy as jnp
import pytest

from yulio_raytracer.geometry.mesh import HostMesh
from yulio_raytracer.scene import SceneBuilder
from yulio_raytracer.shading import materials as gmat
from yulio_raytracer.lights import lights as gl
from yulio_raytracer.ops import intersect
from yulio_raytracer.integrator import pathtracer as pt
from yulio_raytracer.io import builtin_scenes
from yulio_raytracer import renderer
from yulio_raytracer.film import accum


def _moving_quad(material=0, speed=(2.0, 0.0, 0.0)):
    pos = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                     np.float32)
    tri = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    mot = np.tile(np.asarray(speed, np.float32), (4, 1))
    return HostMesh(pos, tri, motions=mot, material=material)


def test_intersect_with_time():
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {}))
    sb.add_mesh(_moving_quad(m))
    scene = sb.commit()
    assert 'mv0' in scene.geom
    org = jnp.asarray([[0.0, 3.0, 0.0], [2.0, 3.0, 0.0]])
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (2, 1))
    tn = jnp.zeros((2,))
    tf = jnp.full((2,), jnp.inf)
    # t=0: quad at origin — first ray hits, second misses
    h0 = intersect.intersect_brute(scene.geom, org, d, tn, tf,
                                   time=jnp.zeros((2,)))
    assert bool(h0.valid[0]) and not bool(h0.valid[1])
    # t=1: quad moved +2 in x — reversed
    h1 = intersect.intersect_brute(scene.geom, org, d, tn, tf,
                                   time=jnp.ones((2,)))
    assert not bool(h1.valid[0]) and bool(h1.valid[1])


def test_motion_blur_render_smears():
    sb = SceneBuilder()
    # black quad against the white dome: hits ~0, misses ~1, so motion
    # blur shows as intermediate pixel values
    m = sb.add_material(gmat.make_material('matte', {'reflectance': 0.0}))
    sb.add_mesh(_moving_quad(m, speed=(3.0, 0.0, 0.0)))
    sb.add_light(gl.ambient((1.0, 1.0, 1.0)))
    scene = sb.commit()
    from yulio_raytracer.cameras import cameras as cam
    camera = cam.Pinhole(cam.look_at((1.5, 6, 0.01), (1.5, 0, 0), (0, 0, 1)),
                         angle=60.0)
    film, _ = renderer.render_frame(scene, camera, pt.PTParams(max_depth=2),
                                    32, 32, spp=16, seed=0)
    img = np.asarray(accum.resolve(film)).mean(axis=-1)
    # the quad sweeps x in [-1, 4]: center pixels are partially covered
    # over time -> intermediate brightness (blur), not binary
    mid = img[16, :]
    assert ((mid > 0.1) & (mid < 0.9)).any(), mid


def test_reference_sphere_motion_scene_loads():
    ref = "/root/reference/models/sphere_motion.xml"
    if not os.path.exists(ref):
        pytest.skip("reference models not present")
    from yulio_raytracer.io import xml_scene
    sb = SceneBuilder()
    xml_scene.load_xml(ref, sb)
    assert any(m.motions is not None for m in sb.meshes)
    sb.add_light(gl.ambient((1.0, 1.0, 1.0)))
    scene = sb.commit()
    assert 'mv0' in scene.geom


def _motion_scene():
    from yulio_raytracer.geometry import primitives
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {}))
    sb.add_mesh(_moving_quad(m, speed=(2.0, 0.0, 0.0)))
    sph = primitives.tessellate_sphere([0, 2, 0], 0.6, 10, 12, material=m)
    sph.motions = np.tile(np.asarray([0.0, -1.5, 0.0], np.float32),
                          (len(sph.positions), 1))
    sb.add_mesh(sph)
    return sb.commit(force_bvh=True, leaf_size=8)


def _motion_rays(r=200, seed=9):
    rs = np.random.RandomState(seed)
    org = jnp.asarray(rs.randn(r, 3).astype(np.float32) * 2
                      + np.asarray([0, 3, 0], np.float32))
    d = rs.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, jnp.asarray(d), jnp.full((r,), 1e-4), rs


def test_motion_packet_matches_brute():
    """Motion blur under the accelerated path: union-bounds BVH + the
    time-aware XLA traversal (ops/traverse.py) must match the dense
    time-aware intersector (the -accel bvh4mb regime of
    sphere_motion.ecs), at per-ray random times."""
    from yulio_raytracer.ops import traverse
    scene = _motion_scene()
    assert scene.bvh is not None and 'mv0' in scene.geom
    assert pt.traversal_kind(scene, motion=True, platform='gpu') == 'bvh'
    org, d, tn, rs = _motion_rays()
    r = org.shape[0]
    tf = jnp.full((r,), jnp.inf)
    time = jnp.asarray(rs.rand(r).astype(np.float32))

    hit = traverse.intersect_bvh(scene.geom, scene.bvh, org, d, tn, tf,
                                 leaf_size=scene.leaf_size, time=time)
    ref = intersect.intersect_brute(scene.geom, org, d, tn, tf, block=64,
                                    time=time)
    t1, t0 = np.asarray(hit.t), np.asarray(ref.t)
    assert (np.isfinite(t1) == np.isfinite(t0)).all()
    both = np.isfinite(t1)
    assert both.any()
    np.testing.assert_allclose(t1[both], t0[both], rtol=1e-4, atol=1e-5)
    assert (np.asarray(hit.tri)[both] == np.asarray(ref.tri)[both]).mean() \
        > 0.999
    occ = traverse.occluded_bvh(scene.geom, scene.bvh, org, d, tn,
                                jnp.full((r,), 4.0),
                                leaf_size=scene.leaf_size, time=time)
    occ_ref = intersect.occluded_brute(scene.geom, org, d, tn,
                                       jnp.full((r,), 4.0), time=time)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))


@pytest.mark.parametrize('t', [0.0, 0.5, 1.0])
def test_motion_traversal_matches_brute_at_time(t):
    """The XLA motion traversal against the time-aware brute force with
    every ray at one time: the endpoints of the motion and its middle."""
    from yulio_raytracer.ops import traverse
    scene = _motion_scene()
    org, d, tn, _ = _motion_rays(256, seed=int(t * 10) + 1)
    r = org.shape[0]
    tf = jnp.where(jnp.arange(r) % 9 == 0, -1.0, jnp.inf)   # dead lanes
    time = jnp.full((r,), t, jnp.float32)
    hit = traverse.intersect_bvh(scene.geom, scene.bvh, org, d, tn, tf,
                                 leaf_size=scene.leaf_size, time=time)
    ref = intersect.intersect_brute(scene.geom, org, d, tn, tf, time=time)
    np.testing.assert_array_equal(np.asarray(hit.tri), np.asarray(ref.tri))
    both = np.asarray(ref.tri) >= 0
    assert both.any() and not np.asarray(hit.tri)[::9].max() >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[both],
                               np.asarray(ref.t)[both], rtol=1e-5)
    tf2 = jnp.where(jnp.arange(r) % 9 == 0, -1.0, 3.0)
    occ = traverse.occluded_bvh(scene.geom, scene.bvh, org, d, tn, tf2,
                                leaf_size=scene.leaf_size, time=time)
    occ_ref = intersect.occluded_brute(scene.geom, org, d, tn, tf2,
                                       time=time)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))
