import numpy as np
import jax.numpy as jnp

from yulio_raytracer.core import rng, math as vm
from yulio_raytracer.sampling import shapesampler as ss
from yulio_raytracer.sampling import patterns, distribution


def _uv(n, seed=0):
    rs = np.random.RandomState(seed)
    return jnp.asarray(rs.rand(n), jnp.float32), jnp.asarray(rs.rand(n), jnp.float32)


def test_rng_deterministic_and_uniform():
    pid = jnp.arange(1 << 14, dtype=jnp.uint32)
    u = rng.uniform1(jnp.uint32(7), pid, jnp.uint32(3), jnp.uint32(1))
    u2 = rng.uniform1(jnp.uint32(7), pid, jnp.uint32(3), jnp.uint32(1))
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))
    m = float(jnp.mean(u))
    v = float(jnp.var(u))
    assert abs(m - 0.5) < 0.01
    assert abs(v - 1.0 / 12.0) < 0.005
    # different dims decorrelated
    w = rng.uniform1(jnp.uint32(7), pid, jnp.uint32(3), jnp.uint32(2))
    corr = np.corrcoef(np.asarray(u), np.asarray(w))[0, 1]
    assert abs(corr) < 0.02


def test_cosine_hemisphere_moments():
    u, v = _uv(1 << 16)
    d, pdf = ss.cosine_sample_hemisphere(u, v)
    z = np.asarray(d[..., 2])
    assert (z >= 0).all()
    # E[cos theta] for cosine-weighted = 2/3
    assert abs(z.mean() - 2.0 / 3.0) < 0.01
    np.testing.assert_allclose(np.asarray(pdf), z / np.pi, atol=1e-5)
    # pdf function matches
    n = jnp.array([0.0, 0.0, 1.0])
    np.testing.assert_allclose(np.asarray(ss.cosine_hemisphere_pdf(d, n)),
                               np.asarray(pdf), atol=1e-5)


def test_power_cosine_matches_pdf_fn():
    u, v = _uv(4096, 3)
    exp = 20.0
    d, pdf = ss.power_cosine_sample_hemisphere(u, v, exp)
    n = jnp.array([0.0, 0.0, 1.0])
    np.testing.assert_allclose(np.asarray(ss.power_cosine_hemisphere_pdf(d, n, exp)),
                               np.asarray(pdf), rtol=1e-4, atol=1e-5)


def test_uniform_sphere_mean_zero():
    u, v = _uv(1 << 16, 5)
    d, pdf = ss.uniform_sample_sphere(u, v)
    m = np.asarray(d).mean(axis=0)
    assert np.abs(m).max() < 0.02
    np.testing.assert_allclose(np.asarray(pdf), 1.0 / (4 * np.pi))


def test_triangle_sampling_inside():
    u, v = _uv(4096, 6)
    a = jnp.array([0.0, 0.0, 0.0])
    b = jnp.array([1.0, 0.0, 0.0])
    c = jnp.array([0.0, 1.0, 0.0])
    p = np.asarray(ss.uniform_sample_triangle(u, v, a, b, c))
    assert (p[:, 0] >= -1e-6).all() and (p[:, 1] >= -1e-6).all()
    assert (p[:, 0] + p[:, 1] <= 1 + 1e-5).all()
    # area-uniform: mean = centroid
    np.testing.assert_allclose(p.mean(axis=0), [1/3, 1/3, 0.0], atol=0.02)


def test_pixel_pattern_stratified():
    spp = 16
    pid = jnp.zeros((spp,), jnp.uint32)
    sid = jnp.arange(spp, dtype=jnp.uint32)
    s = np.asarray(patterns.pixel_sample(jnp.uint32(0), pid, sid, spp))
    assert s.shape == (spp, 2)
    assert (s >= 0).all() and (s < 1).all()
    # stratification: each of the 4x4 strata hit exactly once
    cells = set(zip((s[:, 0] * 4).astype(int), (s[:, 1] * 4).astype(int)))
    assert len(cells) == spp


def test_distribution1d_importance():
    f = np.array([1.0, 3.0, 0.0, 4.0])
    dist = distribution.build_1d(f)
    u = jnp.asarray(np.linspace(0, 0.999999, 20000), jnp.float32)
    x, pdf, idx = distribution.sample_1d(dist, u)
    counts = np.bincount(np.asarray(idx), minlength=4) / 20000.0
    np.testing.assert_allclose(counts, f / f.sum(), atol=0.01)
    # pdf values: f[i]/sum*N
    np.testing.assert_allclose(
        np.asarray(pdf), (f / f.sum() * 4)[np.asarray(idx)], rtol=1e-5)


def test_distribution2d_importance():
    rs = np.random.RandomState(7)
    f = rs.rand(8, 16).astype(np.float64) ** 2
    dist = distribution.build_2d(f)
    uv = jnp.asarray(rs.rand(1 << 15, 2), jnp.float32)
    xy, pdf = distribution.sample_2d(dist, uv)
    xy = np.asarray(xy)
    # empirical histogram matches f
    hist = np.histogram2d(xy[:, 1], xy[:, 0],
                          bins=[8, 16], range=[[0, 8], [0, 16]])[0]
    hist /= hist.sum()
    np.testing.assert_allclose(hist, f / f.sum(), atol=0.01)
    # pdf consistency with pdf_2d (pdf_2d takes normalized [0,1)^2 coords)
    xy_norm = jnp.asarray(xy) / jnp.array([16.0, 8.0])
    np.testing.assert_allclose(np.asarray(pdf),
                               np.asarray(distribution.pdf_2d(dist, xy_norm)),
                               rtol=1e-4)
    # uniform map -> pdf == 1 (reference distribution1d.cpp normalization)
    dist_u = distribution.build_2d(np.ones((4, 4)))
    _, pdf_u = distribution.sample_2d(dist_u, uv)
    np.testing.assert_allclose(np.asarray(pdf_u), 1.0, rtol=1e-5)


def test_bspline_pixel_filter_moments():
    """Sum-of-4-uniforms B-spline variate: mean 0.5, var 4/12, support
    within (0.5-2, 0.5+2)."""
    spp = 4
    n = 1 << 15
    pid = jnp.arange(n, dtype=jnp.uint32)
    sid = jnp.zeros((n,), jnp.uint32)
    s = np.asarray(patterns.pixel_sample_bspline(jnp.uint32(1), pid, sid,
                                                 spp))
    assert s.shape == (n, 2)
    np.testing.assert_allclose(s.mean(axis=0), 0.5, atol=0.02)
    np.testing.assert_allclose(s.var(axis=0), 4.0 / 12.0, atol=0.01)
    assert s.min() > -1.5 and s.max() < 2.5
