import numpy as np
import jax.numpy as jnp

from yulio_raytracer.cameras import cameras as cam
from yulio_raytracer.core import math as vm


def _center_pixel():
    return jnp.asarray([[0.5, 0.5]]), jnp.asarray([[0.5, 0.5]])


def test_pinhole_center_ray():
    l2w = cam.look_at((0, 0, 0), (0, 0, 10), (0, 1, 0))
    c = cam.Pinhole(l2w, angle=90.0, aspect=1.0)
    pix, s = _center_pixel()
    org, d = c.ray(pix, s)
    np.testing.assert_allclose(np.asarray(org[0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(d[0]), [0, 0, 1], atol=1e-6)
    # corner ray at 90 deg fov: 45 deg off-axis horizontally
    org2, d2 = c.ray(jnp.asarray([[1.0, 0.5]]), s)
    ang = np.degrees(np.arccos(float(vm.dot(d2[0], jnp.asarray([0., 0., 1.])))))
    np.testing.assert_allclose(ang, 45.0, atol=0.1)


def test_pinhole_image_orientation():
    """pixel.y=0 is the TOP of the image (dir = ... + (1-py)*vy)."""
    l2w = cam.look_at((0, 0, 0), (0, 0, 10), (0, 1, 0))
    c = cam.Pinhole(l2w, angle=90.0, aspect=1.0)
    _, d_top = c.ray(jnp.asarray([[0.5, 0.0]]), jnp.asarray([[0.5, 0.5]]))
    _, d_bot = c.ray(jnp.asarray([[0.5, 1.0]]), jnp.asarray([[0.5, 0.5]]))
    assert float(d_top[0, 1]) > 0.0   # top of image looks up
    assert float(d_bot[0, 1]) < 0.0


def test_dof_converges_at_focal_plane():
    l2w = cam.look_at((0, 0, 0), (0, 0, 10), (0, 1, 0))
    c = cam.DepthOfField(l2w, angle=60.0, aspect=1.0, lens_radius=0.5,
                         focal_distance=5.0)
    pix = jnp.tile(jnp.asarray([[0.3, 0.7]]), (64, 1))
    rs = np.random.RandomState(0)
    s = jnp.asarray(rs.rand(64, 2), jnp.float32)
    org, d = c.ray(pix, s)
    # all rays from the lens plane pass (approx) through one focal point
    t = (5.0 - np.asarray(org)[:, 2]) / np.asarray(d)[:, 2]
    pts = np.asarray(org) + t[:, None] * np.asarray(d)
    assert pts.std(axis=0).max() < 1e-3
    # lens origins are spread
    assert np.asarray(org)[:, 0].std() > 0.05


def test_stereo_cube_eyes_separated():
    l2w = cam.look_at((0, 0, 0), (0, 0, -1), (0, 1, 0))
    left = cam.StereoCube(l2w, cube_face_index=0, eye_separation=2.0,
                          zero_parallax=60.0)
    right = cam.StereoCube(l2w, cube_face_index=6, eye_separation=2.0,
                           zero_parallax=60.0)
    pix, s = _center_pixel()
    ol, dl = left.ray(pix, s)
    orr, drr = right.ray(pix, s)
    sep = np.linalg.norm(np.asarray(ol[0]) - np.asarray(orr[0]))
    np.testing.assert_allclose(sep, 2.0, atol=1e-5)
    # center rays parallel (no toe-in)
    np.testing.assert_allclose(np.asarray(dl[0]), np.asarray(drr[0]),
                               atol=1e-5)


def test_stereo_cube_faces_cover_sphere():
    l2w = cam.look_at((0, 0, 0), (0, 0, -1), (0, 1, 0))
    rig = cam.make_stereo_rig(l2w, eye_separation=0.0)  # mono rig
    rs = np.random.RandomState(1)
    pix = jnp.asarray(rs.rand(256, 2), jnp.float32)
    s = jnp.asarray(rs.rand(256, 2), jnp.float32)
    dirs = []
    for c in rig[:6]:
        _, d = c.ray(pix, s)
        dirs.append(np.asarray(d))
    alld = np.concatenate(dirs)
    # with zero eye separation all origins are the camera position
    # and the 6 faces cover all octants
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                inside = (np.sign(alld[:, 0]) == sx) & \
                         (np.sign(alld[:, 1]) == sy) & \
                         (np.sign(alld[:, 2]) == sz)
                assert inside.any()


def test_stereo_vertical_falloff():
    """Looking straight up, the eye offset must fall to ~0 (no stereo at
    the poles, StereoCubeCamera.h:128-144)."""
    l2w = cam.look_at((0, 0, 0), (0, 0, -1), (0, 1, 0))
    left = cam.StereoCube(l2w, cube_face_index=4, eye_separation=2.0)
    # center of the up face = straight up = 90 deg vertical
    pix, s = _center_pixel()
    ol, _ = left.ray(pix, s)
    assert np.linalg.norm(np.asarray(ol[0])) < 0.05


def test_toe_in_converges():
    l2w = cam.look_at((0, 0, 0), (0, 0, -1), (0, 1, 0))
    zp = 20.0
    le = cam.StereoCube(l2w, 0, eye_separation=2.0, zero_parallax=zp,
                        toe_in=True)
    ri = cam.StereoCube(l2w, 6, eye_separation=2.0, zero_parallax=zp,
                        toe_in=True)
    pix, s = _center_pixel()
    ol, dl = le.ray(pix, s)
    orr, drr = ri.ray(pix, s)
    # center rays intersect near the zero-parallax plane z = -zp
    tl = (-zp - float(ol[0, 2])) / float(dl[0, 2])
    pl = np.asarray(ol[0]) + tl * np.asarray(dl[0])
    tr = (-zp - float(orr[0, 2])) / float(drr[0, 2])
    pr = np.asarray(orr[0]) + tr * np.asarray(drr[0])
    assert np.linalg.norm(pl - pr) < 0.15
