"""1D / 2D discrete importance-sampling distributions (CDF inversion).

Vectorized counterpart of the reference's `samplers/distribution1d.cpp` /
`distribution2d.cpp` (used for HDRI env-map importance sampling —
`lights/hdrilight.cpp:55,92-99` — and pixel-filter importance sampling).
CDFs are built once at scene-commit time; sampling is a vectorized
`searchsorted` over ray batches (the scalar binary search of
distribution1d.cpp becomes one gather-heavy but fully parallel op).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class Distribution1D(NamedTuple):
    """cdf has N+1 entries, cdf[0]=0, cdf[N]=1; pdf[i] = f[i] * N / sum."""
    cdf: jnp.ndarray   # (N+1,)
    pdf: jnp.ndarray   # (N,)  density w.r.t. continuous position in [0, 1)

    @property
    def size(self) -> int:
        return self.pdf.shape[-1]


def build_1d(f: np.ndarray) -> Distribution1D:
    f = np.asarray(f, np.float64)
    n = f.shape[-1]
    total = f.sum(axis=-1, keepdims=True)
    total = np.where(total <= 0, 1.0, total)
    pdf = f / total * n
    cdf = np.concatenate([np.zeros(f.shape[:-1] + (1,)),
                          np.cumsum(f / total, axis=-1)], axis=-1)
    cdf[..., -1] = 1.0
    return Distribution1D(jnp.asarray(cdf, jnp.float32),
                          jnp.asarray(pdf, jnp.float32))


def sample_1d(dist: Distribution1D, u):
    """Sample continuous position x in [0, N) with its pdf (density in
    units of 1/N-bucket, matching distribution1d.cpp semantics).

    Returns (x, pdf, index).
    """
    n = dist.size
    idx = jnp.clip(jnp.searchsorted(dist.cdf, u, side='right') - 1, 0, n - 1)
    c0 = dist.cdf[idx]
    c1 = dist.cdf[idx + 1]
    frac = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-30), 0.0)
    x = (idx.astype(jnp.float32) + frac)
    return x, dist.pdf[idx], idx


def pdf_1d(dist: Distribution1D, p):
    """Density at normalized position p in [0, 1) — distribution1d.cpp:77-79
    (note the reference's asymmetry: sample() returns bucket coordinates in
    [0, N) while pdf() takes normalized coordinates)."""
    idx = jnp.clip((p * dist.size).astype(jnp.int32), 0, dist.size - 1)
    return dist.pdf[idx]


class Distribution2D(NamedTuple):
    """Row-conditional CDFs + marginal over rows, for (H, W) weights."""
    cond_cdf: jnp.ndarray   # (H, W+1)
    cond_pdf: jnp.ndarray   # (H, W)
    marg_cdf: jnp.ndarray   # (H+1,)
    marg_pdf: jnp.ndarray   # (H,)

    @property
    def shape(self):
        return self.cond_pdf.shape


def build_2d(f: np.ndarray) -> Distribution2D:
    f = np.asarray(f, np.float64)
    h, w = f.shape
    row_sum = f.sum(axis=1)
    marg = build_1d(row_sum)
    safe = np.where(row_sum[:, None] <= 0, 1.0, row_sum[:, None])
    cond_pdf = f / safe * w
    cond_cdf = np.concatenate([np.zeros((h, 1)),
                               np.cumsum(f / safe, axis=1)], axis=1)
    cond_cdf[:, -1] = 1.0
    return Distribution2D(jnp.asarray(cond_cdf, jnp.float32),
                          jnp.asarray(cond_pdf, jnp.float32),
                          marg.cdf, marg.pdf)


def sample_2d(dist: Distribution2D, uv):
    """uv: (..., 2) in [0,1)^2 -> ((..., 2) continuous (x, y) in bucket
    coordinates [0,W) x [0,H), joint pdf).

    pdf convention matches distribution2d.cpp:59-68: the product of the
    per-axis normalized step densities (== 1.0 everywhere for a uniform map);
    the density w.r.t. the unit square is this value, since both axes carry
    their `* size` normalization in Distribution1D::init.
    """
    h, w = dist.shape
    uy, ux = uv[..., 1], uv[..., 0]
    yi = jnp.clip(jnp.searchsorted(dist.marg_cdf, uy, side='right') - 1, 0, h - 1)
    c0 = dist.marg_cdf[yi]
    c1 = dist.marg_cdf[yi + 1]
    yfrac = jnp.where(c1 > c0, (uy - c0) / jnp.maximum(c1 - c0, 1e-30), 0.0)
    py = dist.marg_pdf[yi]

    row_cdf = dist.cond_cdf[yi]                       # (..., W+1) gather
    xi = jnp.clip(
        jnp.sum((row_cdf <= ux[..., None]).astype(jnp.int32), axis=-1) - 1,
        0, w - 1)
    d0 = jnp.take_along_axis(row_cdf, xi[..., None], axis=-1)[..., 0]
    d1 = jnp.take_along_axis(row_cdf, xi[..., None] + 1, axis=-1)[..., 0]
    xfrac = jnp.where(d1 > d0, (ux - d0) / jnp.maximum(d1 - d0, 1e-30), 0.0)
    px = jnp.take_along_axis(dist.cond_pdf[yi], xi[..., None], axis=-1)[..., 0]

    x = xi.astype(jnp.float32) + xfrac
    y = yi.astype(jnp.float32) + yfrac
    return jnp.stack([x, y], axis=-1), px * py


def pdf_2d(dist: Distribution2D, p):
    """Joint density at normalized position p in [0,1)^2
    (distribution2d.cpp:70-73)."""
    h, w = dist.shape
    xi = jnp.clip((p[..., 0] * w).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((p[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return dist.cond_pdf[yi, xi] * dist.marg_pdf[yi]
