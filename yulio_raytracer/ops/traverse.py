"""Wavefront BVH traversal: whole ray batches walk a skip-pointer BVH in
lockstep inside one `lax.while_loop`.

This is the plain-XLA analog of Embree's per-ray BVH4 traversal
(`rtcIntersect` / `rtcOccluded`), and the reference that the GPU kernel
(ops/traverse_triton.py) is tested against.  Key differences, by design
(SURVEY.md section 7 "hard parts"):

* state per ray is one int32 node cursor — no stack, thanks to the DFS
  skip-pointer layout of geometry/bvh.py;
* every loop step does (a) a slab test of each ray against its current
  node and (b) a dense LEAF_SIZE-wide triangle test for rays sitting on a
  leaf.  Leaf tests for rays that are *not* on a leaf are masked out, which
  wastes lanes but keeps shapes static — the XLA way;
* rays that finish park at node == num_nodes and no-op until the whole
  batch drains;
* motion-blur scenes pass a per-ray `time`: the tree is built over the
  union of the t=0 and t=1 triangle boxes (exact for linear motion), and
  the leaf test moves the vertices to v + time * m, the same model as
  ops/intersect.intersect_brute(time=...).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import Hit, INF, BARY_EPS


def _slab_test(lo, hi, org, inv_dir, tnear, tfar):
    """Ray/AABB test. lo/hi: (R, 3) gathered node bounds."""
    t0 = (lo - org) * inv_dir
    t1 = (hi - org) * inv_dir
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tmin, axis=-1), tnear)
    far = jnp.minimum(jnp.min(tmax, axis=-1), tfar)
    return near <= far


def _leaf_tris(geom, start, leaf_size, time=None):
    """Gather a dense (R, L, 3) window of triangles beginning at start,
    moved to each ray's time when `time` is given."""
    T = geom['v0'].shape[0]
    idx = jnp.minimum(start[:, None] + jnp.arange(leaf_size, dtype=jnp.int32),
                      T - 1)                                   # (R, L)
    v0, e1, e2 = geom['v0'][idx], geom['e1'][idx], geom['e2'][idx]
    if time is not None:
        tb = time[:, None, None]
        v0 = v0 + tb * geom['mv0'][idx]
        e1 = e1 + tb * geom['me1'][idx]
        e2 = e2 + tb * geom['me2'][idx]
    return v0, e1, e2, geom['cull'][idx], geom['valid'][idx], idx


def _mt_leaf(v0, e1, e2, cull, tri_valid, org, dirn, tnear, tfar):
    """Moller-Trumbore of each ray against its own (L,) triangle window.
    org/dirn: (R, 3); v0/...: (R, L, 3).  Returns (t, u, v, ok): (R, L)."""
    o = org[:, None, :]
    d = dirn[:, None, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ng_dot_d = jnp.sum(jnp.cross(e1, e2) * d, axis=-1)
    cull_ok = jnp.where(cull == 1, ng_dot_d < 0.0, True)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = ((jnp.abs(det) > 1e-12)
          & (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
          & (t > tnear[:, None]) & (t < tfar[:, None])
          & cull_ok & tri_valid)
    return t, u, v, ok


def intersect_bvh(geom, bvh, org, dirn, tnear, tfar,
                  leaf_size: int = 64, time=None) -> Hit:
    """Closest hit via wavefront skip-pointer traversal.  Among hits at
    equal t, the first in traversal order (then lowest index) wins."""
    num_nodes = bvh['lo'].shape[0]
    r = org.shape[0]
    inv_dir = 1.0 / jnp.where(jnp.abs(dirn) > 1e-30, dirn,
                              jnp.where(dirn >= 0, 1e-30, -1e-30))

    def cond(state):
        node = state[0]
        return jnp.any(node < num_nodes)

    def body(state):
        node, t_best, tri_best, u_best, v_best = state
        active = node < num_nodes
        ni = jnp.minimum(node, num_nodes - 1)
        lo = bvh['lo'][ni]
        hi = bvh['hi'][ni]
        cnt = bvh['count'][ni]
        start = bvh['start'][ni]
        skip = bvh['skip'][ni]

        box_hit = _slab_test(lo, hi, org, inv_dir, tnear,
                             jnp.minimum(tfar, t_best)) & active
        is_leaf = cnt > 0
        do_leaf = box_hit & is_leaf

        v0, e1, e2, cull, tvalid, idx = _leaf_tris(geom, start, leaf_size,
                                                   time)
        # only the first cnt window entries belong to this leaf; extras are
        # real scene triangles too, so hits on them are still valid — but
        # masking them keeps traversal counts comparable with the oracle
        in_leaf = jnp.arange(leaf_size, dtype=jnp.int32)[None, :] < cnt[:, None]
        t, u, v, ok = _mt_leaf(v0, e1, e2, cull, tvalid & in_leaf,
                               org, dirn, tnear, jnp.minimum(tfar, t_best))
        ok = ok & do_leaf[:, None]
        # lane-reduction closest-hit select (no row gathers — see
        # ops/intersect._select_closest)
        t = jnp.where(ok, t, INF)
        t_new = jnp.min(t, axis=-1)
        tie = t == t_new[:, None]
        lane = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        lsel = jnp.min(jnp.where(tie, lane, jnp.int32(2 ** 30)), axis=-1)
        sel = (lane == lsel[:, None]) & tie
        better = t_new < t_best
        t_best = jnp.where(better, t_new, t_best)
        tri_best = jnp.where(better,
                             jnp.sum(jnp.where(sel, idx, 0), axis=-1),
                             tri_best)
        u_best = jnp.where(better, jnp.sum(jnp.where(sel, u, 0.0), axis=-1),
                           u_best)
        v_best = jnp.where(better, jnp.sum(jnp.where(sel, v, 0.0), axis=-1),
                           v_best)

        nxt = jnp.where(box_hit & ~is_leaf, ni + 1, skip)
        node = jnp.where(active, nxt, node)
        return node, t_best, tri_best, u_best, v_best

    init = (jnp.zeros((r,), jnp.int32), jnp.full((r,), INF),
            jnp.full((r,), -1, jnp.int32), jnp.zeros((r,)), jnp.zeros((r,)))
    _, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    return Hit(t, tri, u, v)


def occluded_bvh(geom, bvh, org, dirn, tnear, tfar,
                 leaf_size: int = 64, time=None):
    """Any-hit traversal with per-ray early exit."""
    num_nodes = bvh['lo'].shape[0]
    r = org.shape[0]
    inv_dir = 1.0 / jnp.where(jnp.abs(dirn) > 1e-30, dirn,
                              jnp.where(dirn >= 0, 1e-30, -1e-30))

    def cond(state):
        node, _ = state
        return jnp.any(node < num_nodes)

    def body(state):
        node, occ = state
        active = node < num_nodes
        ni = jnp.minimum(node, num_nodes - 1)
        box_hit = _slab_test(bvh['lo'][ni], bvh['hi'][ni], org, inv_dir,
                             tnear, tfar) & active
        cnt = bvh['count'][ni]
        is_leaf = cnt > 0
        do_leaf = box_hit & is_leaf

        v0, e1, e2, cull, tvalid, _ = _leaf_tris(geom, bvh['start'][ni],
                                                 leaf_size, time)
        in_leaf = jnp.arange(leaf_size, dtype=jnp.int32)[None, :] < cnt[:, None]
        _, _, _, ok = _mt_leaf(v0, e1, e2, cull, tvalid & in_leaf,
                               org, dirn, tnear, tfar)
        occ = occ | (jnp.any(ok, axis=-1) & do_leaf)

        nxt = jnp.where(box_hit & ~is_leaf, ni + 1, bvh['skip'][ni])
        # occluded rays park immediately
        nxt = jnp.where(occ, num_nodes, nxt)
        node = jnp.where(active, nxt, node)
        return node, occ

    init = (jnp.zeros((r,), jnp.int32), jnp.zeros((r,), bool))
    _, occ = jax.lax.while_loop(cond, body, init)
    return occ
