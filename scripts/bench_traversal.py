"""Traversal benchmark: the GPU kernel (ops/traverse_triton.py) against
the plain-XLA traversal (ops/traverse.py), on three ray populations of
one scene, at one or more BVH leaf sizes.

Populations (all at --width^2 rays):
* camera  — primary rays in the renderer's tiled order, closest hit;
* bounce1 — cosine-scattered rays from the primary hits (dead lanes where
  the primary ray missed), closest hit, run the way the renderer runs
  bounce >= 1 (kernel: octant/Morton-sorted; XLA: as given);
* shadow  — rays from the primary hits to random points under the
  ceiling, any-hit, run the way the renderer runs NEE batches (kernel:
  hit-point sort; XLA: as given).

Agreement is measured on identical unsorted inputs: the share of rays
that hit something in either traversal whose triangle ids agree, the
largest |dt| / max(1, t) where they agree, and the share of shadow rays
with identical occlusion.

Usage (on a GPU):
    python scripts/bench_traversal.py --scene sponza_like --width 1536 \\
        --leaf 4 8 16 32 --out chiprun_out/traversal.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

T_TOL = 1e-5        # |dt| <= T_TOL * max(1, t) where triangle ids agree
MATCH_MIN = 0.9999  # share of rays that must agree


def populations(scene, camera, width: int, seed: int = 0):
    """{name: (org, dirn, tnear, tfar)} for camera, bounce1 and shadow.
    Primary hits come from the XLA reference traversal."""
    import jax
    import jax.numpy as jnp
    from yulio_raytracer import renderer
    from yulio_raytracer.ops import intersect as ops_i
    from yulio_raytracer.ops import traverse as ops_t

    n = width * width
    order = renderer._tile_order(width, width)
    px = jnp.asarray((order % width).astype(np.float32))
    py = jnp.asarray((order // width).astype(np.float32))
    uv = jnp.stack([(px + 0.5) / width, (py + 0.5) / width], axis=-1)
    org, dirn = camera.ray(uv, jnp.full((n, 2), 0.5))
    tn = jnp.zeros((n,))
    tf = jnp.full((n,), jnp.inf)

    @jax.jit
    def derived(org, dirn):
        hit = ops_t.intersect_bvh(scene.geom, scene.bvh, org, dirn, tn, tf,
                                  leaf_size=scene.leaf_size)
        live = hit.tri >= 0
        dg = ops_i.post_intersect(scene.geom, org, dirn, hit)
        p = dg['P']
        ns = dg['Ns']
        ns = jnp.where((jnp.sum(ns * dirn, -1) > 0)[:, None], -ns, ns)
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        u = jax.random.uniform(k1, (n, 2))
        r = jnp.sqrt(u[:, 0])
        phi = 2.0 * np.pi * u[:, 1]
        helper = jnp.where((jnp.abs(ns[:, 2]) < 0.9)[:, None],
                           jnp.asarray([0.0, 0.0, 1.0]),
                           jnp.asarray([1.0, 0.0, 0.0]))
        tx = jnp.cross(helper, ns)
        tx = tx / jnp.linalg.norm(tx, axis=-1, keepdims=True)
        ty = jnp.cross(ns, tx)
        d1 = ((r * jnp.cos(phi))[:, None] * tx
              + (r * jnp.sin(phi))[:, None] * ty
              + jnp.sqrt(jnp.maximum(1.0 - u[:, 0], 0.0))[:, None] * ns)
        eps = 1e-3 * jnp.maximum(1.0, jnp.max(jnp.abs(p), axis=-1))
        o1 = p + ns * eps[:, None]
        tf1 = jnp.where(live, jnp.inf, -1.0)
        lo = jnp.asarray(scene.bbox_lo)
        hi = jnp.asarray(scene.bbox_hi)
        q = jax.random.uniform(k2, (n, 3))
        target = lo + q * (hi - lo)
        target = target.at[:, 1].set(hi[1] - 0.05 * (hi[1] - lo[1]))
        ds = target - o1
        dist = jnp.linalg.norm(ds, axis=-1)
        ds = ds / jnp.maximum(dist, 1e-12)[:, None]
        tfs = jnp.where(live, dist * (1.0 - 1e-4), -1.0)
        return o1, d1, tf1, ds, tfs

    o1, d1, tf1, ds, tfs = derived(org, dirn)
    return {'camera': (org, dirn, tn, tf),
            'bounce1': (o1, d1, tn, tf1),
            'shadow': (o1, ds, tn, tfs)}


def _timed(fn, args, reps: int):
    """(median seconds, first-call seconds) of a jitted call."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), first, out


def closest_agreement(ref, got):
    """(matching share, mismatches, max |dt|/max(1,t) on matches)."""
    rt, rtri = np.asarray(ref.t), np.asarray(ref.tri)
    gt, gtri = np.asarray(got.t), np.asarray(got.tri)
    hit_any = (rtri >= 0) | (gtri >= 0)
    same = rtri == gtri
    n = int(hit_any.sum())
    mism = int((hit_any & ~same).sum())
    both = same & (rtri >= 0)
    dt = np.abs(rt[both] - gt[both]) / np.maximum(1.0, np.abs(rt[both]))
    return (1.0 - mism / max(n, 1), mism,
            float(dt.max()) if dt.size else 0.0)


def any_agreement(ref, got):
    """(matching share, mismatches) of occlusion."""
    a, b = np.asarray(ref), np.asarray(got)
    mism = int((a != b).sum())
    return 1.0 - mism / max(a.size, 1), mism


def compare(scene, pops, reps: int = 5, block: int | None = None,
            interpret: bool = False):
    """Kernel vs XLA on each population: times, agreement, pass/fail.
    interpret: run the kernel in the Pallas interpreter (CPU dry runs)."""
    import jax
    from yulio_raytracer.ops import raysort
    from yulio_raytracer.ops import traverse as ops_t
    from yulio_raytracer.ops import traverse_triton as ops_k

    g, b, L = scene.geom, scene.bvh, scene.leaf_size
    lo, hi = scene.bbox_lo, scene.bbox_hi
    kw = {'interpret': interpret}
    if block is not None:
        kw['block'] = block
    xla_c = jax.jit(lambda o, d, tn, tf: ops_t.intersect_bvh(
        g, b, o, d, tn, tf, leaf_size=L))
    xla_a = jax.jit(lambda o, d, tn, tf: ops_t.occluded_bvh(
        g, b, o, d, tn, tf, leaf_size=L))
    k_c = jax.jit(lambda o, d, tn, tf: ops_k.intersect_bvh(
        g, b, o, d, tn, tf, **kw))
    k_cs = jax.jit(lambda o, d, tn, tf: ops_k.intersect_bvh_sorted(
        g, b, o, d, tn, tf, lo, hi, **kw))
    k_a = jax.jit(lambda o, d, tn, tf: ops_k.occluded_bvh(
        g, b, o, d, tn, tf, **kw))

    @jax.jit
    def k_as(o, d, tn, tf):
        perm = raysort.hitpoint_sort_perm(o, lo, hi, live=tf > tn)
        return ops_k.occluded_bvh_sorted(g, b, o, d, tn, tf, lo, hi,
                                         perm=perm, **kw)

    rows = []
    for name, args in pops.items():
        any_hit = name == 'shadow'
        xla = xla_a if any_hit else xla_c
        plain = k_a if any_hit else k_c
        run = {'camera': k_c, 'bounce1': k_cs, 'shadow': k_as}[name]
        x_s, x_first, ref = _timed(xla, args, reps)
        k_s, k_first, got = _timed(plain, args, reps)
        row = dict(population=name, rays=int(args[0].shape[0]),
                   leaf=L, xla_s=x_s, xla_first_s=x_first,
                   kernel_s=k_s, kernel_first_s=k_first)
        if run is not plain:
            row['kernel_sorted_s'] = _timed(run, args, reps)[0]
        if any_hit:
            share, mism = any_agreement(ref, got)
            row.update(match=share, mismatches=mism,
                       ok=bool(share >= MATCH_MIN))
        else:
            share, mism, dt = closest_agreement(ref, got)
            row.update(match=share, mismatches=mism, max_rel_dt=dt,
                       ok=bool(share >= MATCH_MIN and dt <= T_TOL))
        row['speedup'] = x_s / row.get('kernel_sorted_s', k_s)
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--scene', default='sponza_like')
    ap.add_argument('--width', type=int, default=1536)
    ap.add_argument('--leaf', type=int, nargs='+', default=[8])
    ap.add_argument('--block', type=int, nargs='+', default=[None])
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--out', default=None)
    ap.add_argument('--interpret', action='store_true',
                    help='run the kernel in the Pallas interpreter')
    a = ap.parse_args()

    import jax
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.utils import compile_cache
    compile_cache.enable()
    dev = jax.devices()[0]
    print('# device: %s %s x%d' % (dev.platform, dev.device_kind,
                                   len(jax.devices())), flush=True)
    camera = getattr(builtin_scenes, a.scene + '_camera')(a.width, a.width)
    rows = []
    for leaf in a.leaf:
        t0 = time.perf_counter()
        scene = getattr(builtin_scenes, a.scene)().commit(leaf_size=leaf)
        print('# %s leaf %d: %d tris, %d nodes, commit %.1f s'
              % (a.scene, leaf, scene.num_triangles,
                 scene.bvh['lo'].shape[0], time.perf_counter() - t0),
              flush=True)
        pops = populations(scene, camera, a.width)
        for block in a.block:
            for row in compare(scene, pops, a.reps, block, a.interpret):
                row.update(scene=a.scene, block=block,
                           device=dev.device_kind)
                print(json.dumps(row), flush=True)
                rows.append(row)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, 'w') as f:
            json.dump(rows, f, indent=1)
    return 0 if all(r['ok'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
