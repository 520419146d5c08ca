import numpy as np
import jax.numpy as jnp

from yulio_raytracer.core import math as vm


def test_normalize_and_dot():
    v = jnp.array([[3.0, 0.0, 4.0], [0.0, 2.0, 0.0]])
    n = vm.normalize(v)
    np.testing.assert_allclose(vm.length(n), [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(vm.dot(n[0], n[0]), 1.0, atol=1e-6)


def test_frame_orthonormal():
    rs = np.random.RandomState(0)
    n = vm.normalize(jnp.asarray(rs.randn(64, 3), jnp.float32))
    dx, dy, dz = vm.frame(n)
    np.testing.assert_allclose(vm.dot(dx, dy), 0.0, atol=1e-5)
    np.testing.assert_allclose(vm.dot(dx, dz), 0.0, atol=1e-5)
    np.testing.assert_allclose(vm.length(dx), 1.0, atol=1e-5)
    # right-handed: dx x dy == dz
    np.testing.assert_allclose(np.asarray(vm.cross(dx, dy)), np.asarray(dz),
                               atol=1e-5)


def test_reflect_refract():
    n = jnp.array([0.0, 0.0, 1.0])
    v = vm.normalize(jnp.array([1.0, 0.0, 1.0]))  # points away from surface
    r = vm.reflect(v, n)
    np.testing.assert_allclose(np.asarray(r),
                               np.asarray(vm.normalize(jnp.array([-1.0, 0.0, 1.0]))),
                               atol=1e-6)
    # refraction straight through at eta=1
    d, valid, cos_t = vm.refract(v, n, jnp.array(1.0), vm.dot(v, n))
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(d), np.asarray(-v), atol=1e-6)
    # total internal reflection: eta > 1 at grazing angle
    v2 = vm.normalize(jnp.array([100.0, 0.0, 1.0]))
    _, valid2, _ = vm.refract(v2, n, jnp.array(1.8), vm.dot(v2, n))
    assert not bool(valid2)


def test_affine_roundtrip():
    rs = np.random.RandomState(1)
    # well-conditioned: random rotation * diagonal scale
    q, _ = np.linalg.qr(rs.randn(3, 3))
    l = (q @ np.diag([1.5, 0.8, 2.0])).astype(np.float32)
    p = rs.randn(3).astype(np.float32)
    a = jnp.concatenate([jnp.asarray(l), jnp.asarray(p)[None]], axis=0)
    x = jnp.asarray(rs.randn(16, 3), jnp.float32)
    y = vm.xfm_point(a, x)
    x2 = vm.xfm_point(vm.affine_inverse(a), y)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-4)


def test_affine_rotate_about_center():
    center = jnp.array([1.0, 2.0, 3.0])
    axis = jnp.array([0.0, 1.0, 0.0])
    rot = vm.affine_rotate(center, axis, jnp.float32(np.pi / 2))
    # center is fixed
    np.testing.assert_allclose(np.asarray(vm.xfm_point(rot, center)),
                               np.asarray(center), atol=1e-5)
    # +x offset maps to -z offset for +90deg about +y (right-handed)
    p = center + jnp.array([1.0, 0.0, 0.0])
    q = vm.xfm_point(rot, p)
    np.testing.assert_allclose(np.asarray(q - center), [0.0, 0.0, -1.0],
                               atol=1e-5)


def test_rotation_composition_matches_numpy():
    rs = np.random.RandomState(2)
    a = vm.affine_rotate(jnp.zeros(3), jnp.array([0.3, 0.8, -0.5]), 0.7)
    b = vm.affine_rotate(jnp.zeros(3), jnp.array([1.0, 0.0, 0.2]), -1.1)
    x = jnp.asarray(rs.randn(8, 3), jnp.float32)
    # compose(a, b)(x) == a(b(x))
    y1 = vm.xfm_point(vm.affine_compose(a, b), x)
    y2 = vm.xfm_point(a, vm.xfm_point(b, x))
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=1e-5)


def test_ray_sphere_tfar_inside():
    org = jnp.array([0.0, 0.0, 0.0])
    d = jnp.array([1.0, 0.0, 0.0])
    hit, tfar = vm.ray_sphere_tfar(org, d, jnp.array([1.0, 0.0, 0.0]), 3.0)
    assert bool(hit)
    np.testing.assert_allclose(float(tfar), 4.0, atol=1e-5)


def test_smoothstep():
    np.testing.assert_allclose(float(vm.smoothstep(0.0, 1.0, 0.5)), 0.5)
    np.testing.assert_allclose(float(vm.smoothstep(0.0, 1.0, 0.0)), 0.0)
    np.testing.assert_allclose(float(vm.smoothstep(0.0, 1.0, 1.0)), 1.0)
