"""Batched ray-triangle intersection: the replacement for Embree's
`rtcIntersect` / `rtcOccluded` (`pathtraceintegrator.cpp:72,160`).

Two execution strategies over the packed SoA triangle table:

* `intersect_brute` / `intersect_woop` — every ray against every
  triangle, tiled over the triangle axis inside a `lax.scan` with a
  running closest-hit reduction: dense work with no divergence, for
  scenes committed without a BVH and for triangle-sharded meshes.
* BVH traversal (ops/traverse.py, ops/traverse_triton.py) for every
  other scene — rays walk a flattened BVH and only leaf ranges go
  through the same triangle test.

Back-face culling reproduces the reference's Embree filter exactly
(`trianglemesh_normals.cpp:68-104`): a cull-enabled triangle rejects hits
with dot(cross(e1, e2), dir) >= 0 (including degenerate == 0).

The triangle test is watertight-enough Moller-Trumbore in f32 with the
epsilon conventions of the reference (hits strictly inside (tnear, tfar)).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# host-side constant (a jnp scalar here would initialize the XLA
# backend at import time, breaking jax.distributed.initialize ordering)
INF = np.float32(np.inf)

# Watertightness policy (RTC_SCENE_ROBUST parity, scene_flat.h:94): the
# barycentric accept test is inclusive by 32 f32-ulps-at-1.0 — the same
# 32-ulp convention the reference uses for ray-offset epsilons
# (pathtraceintegrator.cpp:32).  Rays aimed exactly along a shared edge /
# through a shared vertex can land epsilon-outside BOTH incident
# triangles in f32 (each triangle's test runs different arithmetic); the
# slop guarantees at least one accepts.  Cost: silhouettes fatten by
# ~4e-6 barycentric units (invisible), shared-edge rays may hit both
# triangles (closest-t picks one).  Validated by tests/test_watertight.py.
BARY_EPS = float(32 * np.finfo(np.float32).eps)  # 3.8e-6


class Hit(NamedTuple):
    """Closest-hit record for a ray batch (all (R,) arrays)."""
    t: jnp.ndarray        # f32, inf on miss
    tri: jnp.ndarray      # i32 triangle index, -1 on miss
    u: jnp.ndarray        # f32 barycentric of e1 vertex
    v: jnp.ndarray        # f32 barycentric of e2 vertex

    @property
    def valid(self):
        return self.tri >= 0


def _mt_block(v0, e1, e2, cull, tri_valid, org, dirn, tnear, tfar,
              motion=None, time=None):
    """Moller-Trumbore of R rays against a (Tc,) triangle block.

    org/dirn: (R, 3); v0/e1/e2: (Tc, 3). Returns (t, u, v, ok): (R, Tc).
    With motion=(mv0, me1, me2) and time (R,), vertices move linearly:
    v(t) = v + t * m (the bvh4mb motion-blur model).
    """
    # broadcast (R, 1, 3) x (1, Tc, 3)
    o = org[:, None, :]
    d = dirn[:, None, :]
    v0b = v0[None, :, :]
    e1b = e1[None, :, :]
    e2b = e2[None, :, :]
    if motion is not None:
        tb = time[:, None, None]
        v0b = v0b + tb * motion[0][None]
        e1b = e1b + tb * motion[1][None]
        e2b = e2b + tb * motion[2][None]

    pvec = jnp.cross(d, e2b)                       # (R, Tc, 3)
    det = jnp.sum(e1b * pvec, axis=-1)             # (R, Tc)
    # cull test: reject back faces for cull-enabled tris
    ng_dot_d = jnp.sum(jnp.cross(e1b, e2b) * d, axis=-1)
    cull_ok = jnp.where(cull[None, :] == 1, ng_dot_d < 0.0, True)

    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - v0b
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1b)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2b * qvec, axis=-1) * inv_det

    ok = ((jnp.abs(det) > 1e-12)
          & (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
          & (t > tnear[:, None]) & (t < tfar[:, None])
          & cull_ok & tri_valid[None, :])
    return t, u, v, ok


def _select_closest(t, u, v, ok, base_index):
    """Reduce a (R, Tc) candidate block to per-ray closest hits with
    reductions over the block (no per-row argmin gathers)."""
    tc = t.shape[-1]
    t = jnp.where(ok, t, INF)
    tmin = jnp.min(t, axis=-1)                          # (R,)
    # break exact-t ties by smallest triangle index
    tie = t == tmin[:, None]
    idx = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
    big = jnp.int32(2 ** 30)
    jsel = jnp.min(jnp.where(tie, idx, big), axis=-1)   # (R,)
    sel = (idx == jsel[:, None]) & tie
    usel = jnp.sum(jnp.where(sel, u, 0.0), axis=-1)
    vsel = jnp.sum(jnp.where(sel, v, 0.0), axis=-1)
    hit = jnp.isfinite(tmin)
    tri = jnp.where(hit, base_index + jnp.minimum(jsel, tc - 1), -1)
    return tmin, tri, usel, vsel


def _closest_in_block(v0, e1, e2, cull, tri_valid, org, dirn, tnear, tfar,
                      base_index, motion=None, time=None):
    t, u, v, ok = _mt_block(v0, e1, e2, cull, tri_valid, org, dirn,
                            tnear, tfar, motion, time)
    return _select_closest(t, u, v, ok, base_index)


def intersect_brute(geom, org, dirn, tnear, tfar,
                    block: int = 512, time=None) -> Hit:
    """Closest hit of each ray against ALL triangles (chunked scan)."""
    T = geom['v0'].shape[0]
    block = min(block, T)
    nblk = (T + block - 1) // block
    has_motion = 'mv0' in geom and time is not None

    def body(carry, blk):
        t0, tri0, u0, v0c = carry
        # the final block overlaps its predecessor when block does not
        # divide T — re-testing a few triangles is harmless for closest-hit
        base = jnp.minimum(blk * block, T - block)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, base, block, axis=0)
        motion = ((sl(geom['mv0']), sl(geom['me1']), sl(geom['me2']))
                  if has_motion else None)
        t1, tri1, u1, v1 = _closest_in_block(
            sl(geom['v0']), sl(geom['e1']), sl(geom['e2']),
            sl(geom['cull']), sl(geom['valid']),
            org, dirn, tnear, tfar, base, motion, time)
        better = t1 < t0
        return ((jnp.where(better, t1, t0),
                 jnp.where(better, tri1, tri0),
                 jnp.where(better, u1, u0),
                 jnp.where(better, v1, v0c)), None)

    r = org.shape[0]
    init = (jnp.full((r,), INF), jnp.full((r,), -1, jnp.int32),
            jnp.zeros((r,)), jnp.zeros((r,)))
    if nblk == 1:
        (t, tri, u, v), _ = body(init, jnp.int32(0))
    else:
        (t, tri, u, v), _ = jax.lax.scan(body, init,
                                         jnp.arange(nblk, dtype=jnp.int32))
    return Hit(t, tri, u, v)


def occluded_brute(geom, org, dirn, tnear, tfar, block: int = 512,
                   time=None):
    """Any-hit test (rtcOccluded): (R,) bool, honoring cull filters."""
    T = geom['v0'].shape[0]
    block = min(block, T)
    nblk = (T + block - 1) // block
    has_motion = 'mv0' in geom and time is not None

    def body(occ, blk):
        base = jnp.minimum(blk * block, T - block)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, base, block, axis=0)
        motion = ((sl(geom['mv0']), sl(geom['me1']), sl(geom['me2']))
                  if has_motion else None)
        _, _, _, ok = _mt_block(sl(geom['v0']), sl(geom['e1']),
                                sl(geom['e2']), sl(geom['cull']),
                                sl(geom['valid']), org, dirn, tnear, tfar,
                                motion, time)
        return occ | jnp.any(ok, axis=-1), None

    init = jnp.zeros((org.shape[0],), bool)
    if nblk == 1:
        occ, _ = body(init, jnp.int32(0))
    else:
        occ, _ = jax.lax.scan(body, init, jnp.arange(nblk, dtype=jnp.int32))
    return occ


def _woop_block(w4, ng, cull, tri_valid, org, dirn, tnear, tfar):
    """Woop triangle test: rays against a (4, 3*Tc) block of Woop
    matrices.  Two (R,4)x(4,3Tc) f32 matmuls at HIGHEST precision (no
    TF32 rounding), then elementwise work.  Returns (t, u, v, ok): (R, Tc).
    """
    r = org.shape[0]
    o4 = jnp.concatenate([org, jnp.ones((r, 1), org.dtype)], axis=-1)
    d4 = jnp.concatenate([dirn, jnp.zeros((r, 1), dirn.dtype)], axis=-1)
    ou = jnp.dot(o4, w4, precision=jax.lax.Precision.HIGHEST,
                 preferred_element_type=jnp.float32)
    du = jnp.dot(d4, w4, precision=jax.lax.Precision.HIGHEST,
                 preferred_element_type=jnp.float32)
    tc = w4.shape[1] // 3
    ou = ou.reshape(r, tc, 3)
    du = du.reshape(r, tc, 3)
    dz = du[..., 2]
    inv_dz = jnp.where(jnp.abs(dz) > 1e-12, 1.0 / dz, 0.0)
    t = -ou[..., 2] * inv_dz
    u = ou[..., 0] + t * du[..., 0]
    v = ou[..., 1] + t * du[..., 1]
    # cull: reject back faces (dot(ng, d) >= 0) for cull-enabled tris
    ng_dot_d = jnp.einsum('tk,rk->rt', ng, dirn,
                          precision=jax.lax.Precision.HIGHEST)
    cull_ok = jnp.where(cull[None, :] == 1, ng_dot_d < 0.0, True)
    ok = ((jnp.abs(dz) > 1e-12)
          & (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
          & (t > tnear[:, None]) & (t < tfar[:, None])
          & cull_ok & tri_valid[None, :])
    return t, u, v, ok


def intersect_woop(geom, org, dirn, tnear, tfar, block: int = 2048) -> Hit:
    """Closest hit via the Woop-matrix path (requires geom['woop'])."""
    T = geom['v0'].shape[0]
    block = min(block, T)
    nblk = (T + block - 1) // block

    def one_block(base):
        w4 = jax.lax.dynamic_slice(geom['woop'], (0, 3 * base),
                                   (4, 3 * block))
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, base, block, axis=0)
        t, u, v, ok = _woop_block(w4, sl(geom['ng']), sl(geom['cull']),
                                  sl(geom['valid']), org, dirn, tnear, tfar)
        return _select_closest(t, u, v, ok, base)

    def body(carry, blk):
        t0, tri0, u0, v0c = carry
        base = jnp.minimum(blk * block, T - block)
        t1, tri1, u1, v1 = one_block(base)
        better = t1 < t0
        return ((jnp.where(better, t1, t0), jnp.where(better, tri1, tri0),
                 jnp.where(better, u1, u0), jnp.where(better, v1, v0c)),
                None)

    r = org.shape[0]
    init = (jnp.full((r,), INF), jnp.full((r,), -1, jnp.int32),
            jnp.zeros((r,)), jnp.zeros((r,)))
    if nblk == 1:
        (t, tri, u, v), _ = body(init, jnp.int32(0))
    else:
        (t, tri, u, v), _ = jax.lax.scan(body, init,
                                         jnp.arange(nblk, dtype=jnp.int32))
    return Hit(t, tri, u, v)


def occluded_woop(geom, org, dirn, tnear, tfar, block: int = 2048):
    T = geom['v0'].shape[0]
    block = min(block, T)
    nblk = (T + block - 1) // block

    def body(occ, blk):
        base = jnp.minimum(blk * block, T - block)
        w4 = jax.lax.dynamic_slice(geom['woop'], (0, 3 * base),
                                   (4, 3 * block))
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, base, block, axis=0)
        _, _, _, ok = _woop_block(w4, sl(geom['ng']), sl(geom['cull']),
                                  sl(geom['valid']), org, dirn, tnear, tfar)
        return occ | jnp.any(ok, axis=-1), None

    init = jnp.zeros((org.shape[0],), bool)
    if nblk == 1:
        occ, _ = body(init, jnp.int32(0))
    else:
        occ, _ = jax.lax.scan(body, init, jnp.arange(nblk, dtype=jnp.int32))
    return occ


def post_intersect(geom, org, dirn, hit: Hit):
    """Shading-geometry interpolation — the analog of
    BackendScene::postIntersect + TriangleMesh*::postIntersect
    (`trianglemesh_normals.cpp:140-162`): P, Ng, interpolated Ns, st,
    and the 'error' scale used for epsilon offsets.

    Returns a dict of (R, ...) arrays; contents are undefined for misses
    (callers must mask by hit.valid).
    """
    idx = jnp.maximum(hit.tri, 0)
    p = org + hit.t[..., None] * dirn
    p = jnp.where(hit.valid[..., None], p, 0.0)

    if 'shade_tab' in geom:
        # one fused row gather of all shading attributes
        tab = geom['shade_tab'][idx]                    # (R, 28)
        ng = tab[:, 0:3]
        vn = tab[:, 3:12].reshape(-1, 3, 3)
        uvs = tab[:, 12:18].reshape(-1, 3, 2)
        mat_id = jnp.round(tab[:, 18]).astype(jnp.int32)
        light_id = jnp.round(tab[:, 19]).astype(jnp.int32)
        illum = jnp.round(tab[:, 20]).astype(jnp.int32)
        shadow = jnp.round(tab[:, 21]).astype(jnp.int32)
        tx = tab[:, 22:25]
        ty = tab[:, 25:28]
    else:
        ng = geom['ng'][idx]
        vn = geom['vn'][idx]
        uvs = geom['uv'][idx]
        mat_id = geom['mat_id'][idx]
        light_id = geom['light_id'][idx]
        illum = geom['illum_mask'][idx]
        shadow = geom['shadow_mask'][idx]
        tx = ty = None

    w = (1.0 - hit.u - hit.v)
    ns = (w[..., None] * vn[:, 0] + hit.u[..., None] * vn[:, 1]
          + hit.v[..., None] * vn[:, 2])
    nlen = jnp.sqrt(jnp.maximum(jnp.sum(ns * ns, axis=-1, keepdims=True),
                                1e-20))
    ns = ns / nlen
    st = (w[..., None] * uvs[:, 0] + hit.u[..., None] * uvs[:, 1]
          + hit.v[..., None] * uvs[:, 2])
    # error estimate: max |coordinate| used to scale intersection epsilon
    # (reference postIntersect sets dg.error = max(|P|, tfar))
    err = jnp.maximum(jnp.max(jnp.abs(p), axis=-1), jnp.abs(hit.t))
    out = {
        'P': p,
        'Ng': ng,
        'Ns': ns,
        'st': st,
        'error': jnp.where(hit.valid, err, 0.0),
        'mat_id': jnp.where(hit.valid, mat_id, 0),
        'light_id': jnp.where(hit.valid, light_id, -1),
        'illum_mask': jnp.where(hit.valid, illum, -1),
        'shadow_mask': jnp.where(hit.valid, shadow, -1),
    }
    if tx is not None:
        out['Tx'] = tx
        out['Ty'] = ty
    return out
