"""Render-level light checks (each light type driving actual NEE)."""
import numpy as np
import jax.numpy as jnp

from yulio_raytracer.scene import SceneBuilder
from yulio_raytracer.geometry.mesh import HostMesh
from yulio_raytracer.shading import materials as gmat
from yulio_raytracer.lights import lights as gl
from yulio_raytracer.integrator import pathtracer as pt


def _floor_scene(light, albedo=0.5):
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {'reflectance': albedo}))
    pos = np.asarray([[-100, 0, -100], [100, 0, -100], [100, 0, 100],
                      [-100, 0, 100]], np.float32)
    tri = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    sb.add_mesh(HostMesh(pos, tri,
                         np.tile([[0., 1., 0.]], (4, 1)).astype(np.float32)))
    sb.add_light(light)
    return sb.commit()


def _shade_points(n=256):
    rs = np.random.RandomState(0)
    org = np.zeros((n, 3), np.float32)
    org[:, 0] = rs.uniform(-2, 2, n)
    org[:, 2] = rs.uniform(-2, 2, n)
    org[:, 1] = 5.0
    d = np.tile([[0.0, -1.0, 0.0]], (n, 1)).astype(np.float32)
    return jnp.asarray(org), jnp.asarray(d)


def _ids(n):
    return jnp.arange(n, dtype=jnp.uint32), jnp.zeros((n,), jnp.uint32)


def test_directional_light_analytic():
    """L = E * rho/pi * cos(theta) for a directional light."""
    d_light = np.asarray([-1.0, -1.0, 0.0])
    scene = _floor_scene(gl.directional(d_light, (2.0, 2.0, 2.0)))
    org, d = _shade_points()
    pid, sid = _ids(256)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    cos = 1.0 / np.sqrt(2.0)
    np.testing.assert_allclose(np.asarray(L)[:, 0],
                               2.0 * 0.5 / np.pi * cos, rtol=1e-3)


def test_spot_light_cone():
    """Inside the inner cone: full point-light falloff; outside: zero."""
    scene = _floor_scene(gl.spot((0, 4, 0), (0, -1, 0), (40.0,) * 3,
                                 20.0, 30.0))
    n = 2
    org = jnp.asarray([[0.0, 1.0, 0.0],     # directly under: inside cone
                       [10.0, 1.0, 0.0]])   # far off-axis: outside
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (n, 1))
    pid, sid = _ids(n)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    l = np.asarray(L)
    expect_center = 40.0 * 0.5 / np.pi / 16.0   # I*rho/pi*cos(0)/d^2
    np.testing.assert_allclose(l[0, 0], expect_center, rtol=1e-3)
    assert l[1, 0] == 0.0


def test_distant_light_soft():
    """Distant light with a half-angle produces energy ~ a directional
    light of the same integrated radiance."""
    scene = _floor_scene(gl.distant((0, -1, 0), (5.0,) * 3, 5.0))
    org, d = _shade_points(1024)
    pid, sid = _ids(1024)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    mean = float(np.asarray(L)[:, 0].mean())
    # E = L * solid angle = 5 * 2pi(1-cos 5deg); direct = E*rho/pi*cos(~1)
    omega = 2 * np.pi * (1 - np.cos(np.deg2rad(5.0)))
    expect = 5.0 * omega * 0.5 / np.pi
    np.testing.assert_allclose(mean, expect, rtol=0.05)


def test_hdri_light_render():
    """Half-bright/half-dark lat-long environment: floor lit by the bright
    hemisphere only; misses sample the map exactly."""
    img = np.zeros((16, 32, 3), np.float32)
    img[:8] = 2.0          # top half of the map (theta < pi/2) bright
    scene = _floor_scene(gl.hdri(img))
    org, d = _shade_points(2048)
    pid, sid = _ids(2048)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    mean = float(np.asarray(L)[:, 0].mean())
    # uniform hemisphere L=2: direct = rho * L = 1.0
    np.testing.assert_allclose(mean, 1.0, rtol=0.1)
    # escaped rays (looking up) return the map radiance
    up = -d
    L2, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, up, 0, pid, sid)
    np.testing.assert_allclose(np.asarray(L2)[:, 0], 2.0, atol=1e-4)


def test_many_lights_dim_layout():
    """>= 6 lights widen the per-bounce RNG dim layout
    (pathtracer._dim_layout) so shadow-jitter dims cannot collide with
    light-sample dims: with the fixed legacy layout, light 5's shadow
    jitter reused light 0's sample scalar.  The render must stay finite,
    deterministic, and additive-ish over independent lights."""
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {'reflectance': 0.5}))
    pos = np.asarray([[-100, 0, -100], [100, 0, -100], [100, 0, 100],
                      [-100, 0, 100]], np.float32)
    tri = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    sb.add_mesh(HostMesh(pos, tri,
                         np.tile([[0., 1., 0.]], (4, 1)).astype(np.float32),
                         material=m))
    for i in range(8):
        sb.add_light(gl.point((np.cos(i), 3.0, np.sin(i)), (2.0, 2.0, 2.0)))
    scene = sb.commit()
    dim_light, stride = pt._dim_layout(8)
    assert dim_light == 3 + 8 and stride == dim_light + 8

    org, d = _shade_points(128)
    pid, sid = _ids(128)
    params = pt.PTParams(max_depth=2, t_max_shadow_ray=50.0)
    rgb, _ = pt.trace(scene, params, org, d, 1, pid, sid)
    rgb2, _ = pt.trace(scene, params, org, d, 1, pid, sid)
    assert np.isfinite(np.asarray(rgb)).all()
    assert np.asarray(rgb).max() > 0.0
    np.testing.assert_array_equal(np.asarray(rgb), np.asarray(rgb2))
