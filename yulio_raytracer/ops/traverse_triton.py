"""GPU BVH traversal kernel: Pallas through Triton.

The algorithm is that of ops/traverse.py — stackless skip-pointer
traversal over the same FlatBVH arrays (`lo`, `hi`, `count`, `start`,
`skip`) and the same per-triangle `v0/e1/e2/cull/valid`, with the same
Moller-Trumbore test, BARY_EPS and tie rule — written for one lane per
ray instead of one lockstep wavefront:

* one program handles `block` rays (32 by default: one warp); each lane
  carries its own node cursor and its own leaf cursor, and the program's
  loop ends when its own rays are done, not when the slowest ray of the
  whole batch is;
* node and triangle fields are fetched with per-lane indexed loads, and
  a lane visits a leaf's `count` triangles one per loop step, so no lane
  gathers a fixed leaf-size window;
* each step, a lane inside a leaf tests one triangle and every other
  live lane visits one node — the loop runs max(nodes + triangles) steps
  per warp, which keeps a warp's lanes busy even when only some of them
  are on leaves.

Closest-hit ties resolve as in ops/traverse.py: a triangle replaces the
best hit only at strictly smaller t, so the first hit in traversal order
(then the lowest index in its leaf) wins.

`interpret=True` runs the same kernel through the Pallas interpreter —
that is how the CPU tests check it; the renderer itself calls the kernel
only on a GPU (integrator/pathtracer.traversal_kind).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import Hit, INF, BARY_EPS
from . import raysort

BLOCK = 32        # rays per program; one warp per 32 rays


def _load(ref, idx, mask, other):
    return plgpu.load(ref.at[idx], mask=mask, other=other)


def _tri_flags(geom):
    """Per-triangle int32: 0 = never hit (padding/degenerate), 1 = two-
    sided, 2 = back-face culled (trianglemesh_normals.cpp:68-104)."""
    return jnp.where(geom['valid'], jnp.where(geom['cull'] == 1, 2, 1),
                     0).astype(jnp.int32)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tn_ref, tf_ref,
            lo_ref, hi_ref, start_ref, count_ref, skip_ref,
            v0_ref, e1_ref, e2_ref, flag_ref, *out_refs,
            num_nodes: int, any_hit: bool):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    inv = tuple(1.0 / jnp.where(jnp.abs(c) > 1e-30, c,
                                jnp.where(c >= 0, 1e-30, -1e-30))
                for c in d)
    tnear = tn_ref[...]
    tfar = tf_ref[...]
    zero_i = jnp.zeros_like(tnear, dtype=jnp.int32)

    def tri_test(cur, in_leaf, tmax):
        j = jnp.where(in_leaf, cur, 0)
        v0 = [_load(v0_ref, 3 * j + k, in_leaf, 0.0) for k in range(3)]
        e1 = [_load(e1_ref, 3 * j + k, in_leaf, 0.0) for k in range(3)]
        e2 = [_load(e2_ref, 3 * j + k, in_leaf, 0.0) for k in range(3)]
        flag = _load(flag_ref, j, in_leaf, 0)
        px = d[1] * e2[2] - d[2] * e2[1]
        py = d[2] * e2[0] - d[0] * e2[2]
        pz = d[0] * e2[1] - d[1] * e2[0]
        det = e1[0] * px + e1[1] * py + e1[2] * pz
        ngx = e1[1] * e2[2] - e1[2] * e2[1]
        ngy = e1[2] * e2[0] - e1[0] * e2[2]
        ngz = e1[0] * e2[1] - e1[1] * e2[0]
        ng_dot_d = ngx * d[0] + ngy * d[1] + ngz * d[2]
        cull_ok = (flag != 2) | (ng_dot_d < 0.0)
        nondeg = jnp.abs(det) > 1e-12
        inv_det = jnp.where(nondeg, 1.0 / jnp.where(nondeg, det, 1.0), 0.0)
        tx = o[0] - v0[0]
        ty = o[1] - v0[1]
        tz = o[2] - v0[2]
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1[2] - tz * e1[1]
        qy = tz * e1[0] - tx * e1[2]
        qz = tx * e1[1] - ty * e1[0]
        v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
        t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
        ok = (in_leaf & nondeg & (flag != 0) & cull_ok
              & (u >= -BARY_EPS) & (v >= -BARY_EPS)
              & (u + v <= 1.0 + BARY_EPS)
              & (t > tnear) & (t < tmax))
        return ok, t, u, v

    def node_step(node, cur, end, step, tmax):
        ni = jnp.where(step, node, 0)
        near = tnear
        far = tmax
        for k in range(3):
            lo = _load(lo_ref, 3 * ni + k, step, 0.0)
            hi = _load(hi_ref, 3 * ni + k, step, 0.0)
            t0 = (lo - o[k]) * inv[k]
            t1 = (hi - o[k]) * inv[k]
            near = jnp.maximum(near, jnp.minimum(t0, t1))
            far = jnp.minimum(far, jnp.maximum(t0, t1))
        box_hit = step & (near <= far)
        cnt = _load(count_ref, ni, step, 0)
        first = _load(start_ref, ni, step, 0)
        skp = _load(skip_ref, ni, step, num_nodes)
        is_leaf = cnt > 0
        enter = box_hit & is_leaf
        cur = jnp.where(enter, first, cur)
        end = jnp.where(enter, first + cnt, end)
        nxt = jnp.where(box_hit & ~is_leaf, ni + 1, skp)
        node = jnp.where(step, nxt, node)
        return node, cur, end

    def cond(carry):
        node, cur, end = carry[:3]
        live = (node < num_nodes) | (cur < end)
        return jnp.max(live.astype(jnp.int32)) > 0

    if any_hit:
        def body(carry):
            node, cur, end, occ = carry
            in_leaf = cur < end
            ok, _, _, _ = tri_test(cur, in_leaf, tfar)
            occ = occ | ok
            cur = jnp.where(in_leaf, cur + 1, cur)
            step = ~in_leaf & (node < num_nodes)
            node, cur, end = node_step(node, cur, end, step, tfar)
            # occluded rays park at once (rtcOccluded early exit)
            node = jnp.where(occ, num_nodes, node)
            end = jnp.where(occ, cur, end)
            return node, cur, end, occ

        init = (zero_i, zero_i, zero_i, jnp.zeros_like(tnear, dtype=bool))
        _, _, _, occ = jax.lax.while_loop(cond, body, init)
        out_refs[0][...] = occ.astype(jnp.int32)
        return

    def body(carry):
        node, cur, end, t_best, tri_best, u_best, v_best = carry
        in_leaf = cur < end
        ok, t, u, v = tri_test(cur, in_leaf, jnp.minimum(tfar, t_best))
        t_best = jnp.where(ok, t, t_best)
        tri_best = jnp.where(ok, cur, tri_best)
        u_best = jnp.where(ok, u, u_best)
        v_best = jnp.where(ok, v, v_best)
        cur = jnp.where(in_leaf, cur + 1, cur)
        step = ~in_leaf & (node < num_nodes)
        node, cur, end = node_step(node, cur, end, step,
                                   jnp.minimum(tfar, t_best))
        return node, cur, end, t_best, tri_best, u_best, v_best

    init = (zero_i, zero_i, zero_i, jnp.full_like(tnear, INF), zero_i - 1,
            jnp.zeros_like(tnear), jnp.zeros_like(tnear))
    _, _, _, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    t_ref, tri_ref, u_ref, v_ref = out_refs
    t_ref[...] = t
    tri_ref[...] = tri
    u_ref[...] = u
    v_ref[...] = v


def _call(geom, bvh, org, dirn, tnear, tfar, any_hit, interpret, block):
    r = org.shape[0]
    rp = -(-r // block) * block
    pad = rp - r

    def col(x):
        return jnp.pad(x.astype(jnp.float32), (0, pad))

    # padding lanes are dead: tfar < tnear fails every slab test
    rays = [col(org[:, k]) for k in range(3)] + \
        [col(dirn[:, k]) for k in range(3)] + \
        [col(tnear), jnp.pad(tfar.astype(jnp.float32), (0, pad),
                             constant_values=-1.0)]
    tables = [bvh['lo'].reshape(-1), bvh['hi'].reshape(-1), bvh['start'],
              bvh['count'], bvh['skip'], geom['v0'].reshape(-1),
              geom['e1'].reshape(-1), geom['e2'].reshape(-1),
              _tri_flags(geom)]
    num_nodes = bvh['lo'].shape[0]
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    in_specs = [ray_spec] * len(rays) + [
        pl.BlockSpec(a.shape, lambda i: (0,)) for a in tables]
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((rp,), jnp.int32)]
    else:
        out_shape = [jax.ShapeDtypeStruct((rp,), jnp.float32),
                     jax.ShapeDtypeStruct((rp,), jnp.int32),
                     jax.ShapeDtypeStruct((rp,), jnp.float32),
                     jax.ShapeDtypeStruct((rp,), jnp.float32)]
    outs = pl.pallas_call(
        partial(_kernel, num_nodes=num_nodes, any_hit=any_hit),
        out_shape=out_shape,
        grid=(rp // block,),
        in_specs=in_specs,
        out_specs=[ray_spec] * len(out_shape),
        compiler_params=plgpu.CompilerParams(num_warps=max(block // 32, 1),
                                             num_stages=1),
        interpret=interpret,
        name='bvh_any_hit' if any_hit else 'bvh_closest_hit',
    )(*rays, *tables)
    return [x[:r] for x in outs]


def intersect_bvh(geom, bvh, org, dirn, tnear, tfar,
                  interpret: bool = False, block: int = BLOCK) -> Hit:
    """Closest hit; same contract as ops/traverse.intersect_bvh.  block:
    rays per program, a power of two from 32 to 128."""
    t, tri, u, v = _call(geom, bvh, org, dirn, tnear, tfar, False,
                         interpret, block)
    return Hit(t, tri, u, v)


def occluded_bvh(geom, bvh, org, dirn, tnear, tfar,
                 interpret: bool = False, block: int = BLOCK):
    """Any-hit occlusion: (R,) bool; same contract as
    ops/traverse.occluded_bvh."""
    (occ,) = _call(geom, bvh, org, dirn, tnear, tfar, True, interpret,
                   block)
    return occ != 0


def intersect_bvh_sorted(geom, bvh, org, dirn, tnear, tfar, bbox_lo,
                         bbox_hi, interpret: bool = False,
                         block: int = BLOCK) -> Hit:
    """intersect_bvh on octant/Morton-sorted rays (ops/raysort.py), so a
    warp's lanes walk similar paths; results come back in input order."""
    def run(o, d, tn, tf):
        return tuple(intersect_bvh(geom, bvh, o, d, tn, tf, interpret,
                                   block))

    return Hit(*raysort.sorted_call(run, 4, org, dirn, tnear, tfar,
                                    bbox_lo, bbox_hi))


def occluded_bvh_sorted(geom, bvh, org, dirn, tnear, tfar, bbox_lo,
                        bbox_hi, perm=None, interpret: bool = False,
                        block: int = BLOCK):
    """occluded_bvh on sorted rays; `perm` reuses a precomputed order
    (raysort.hitpoint_sort_perm + tile_perm for NEE batches)."""
    def run(o, d, tn, tf):
        return occluded_bvh(geom, bvh, o, d, tn, tf, interpret, block)

    return raysort.sorted_call(run, 1, org, dirn, tnear, tfar, bbox_lo,
                               bbox_hi, perm=perm)
