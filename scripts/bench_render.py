"""End-to-end render benchmark: seconds per frame through
renderer.render_frame for a product of scenes, leaf sizes, tree
qualities, traversal families and BVH/no-BVH commits.

Variants of --traversal:
* kernel        — the renderer's own choice on a GPU (ops/traverse_triton);
* xla           — the plain-XLA skip-pointer traversal (ops/traverse.py);
* kernel-nosort — the kernel with bounce >= 1 and shadow rays run in the
                  order they arrive (no octant/Morton or hit-point sort).

--camera stereo renders face 1 of a StereoCube rig at the scene camera's
pose, the way output.render_stereo calls render_frame; pinhole renders the
scene's own camera.  One row per combination: the median of --reps timed
frames after one warm-up frame (its seconds, compilation included, are
first_s).

    python scripts/bench_render.py --scene sponza_like --size 1536 \\
        --depth 10 --leaf 4 8 16 32 --traversal kernel xla
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def _use_traversal(name):
    """Point the integrator at one traversal family; returns an undo."""
    import jax
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.ops import traverse_triton as ops_k
    saved = (pt.traversal_kind, ops_k.intersect_bvh_sorted,
             ops_k.occluded_bvh_sorted)
    if name == 'xla':
        def kind(scene, motion=False, platform=None):
            k = saved[0](scene, motion, platform)
            return 'bvh' if k == 'kernel' else k
        pt.traversal_kind = kind
    elif name == 'kernel-nosort':
        ops_k.intersect_bvh_sorted = (
            lambda g, b, o, d, tn, tf, lo, hi, **kw:
            ops_k.intersect_bvh(g, b, o, d, tn, tf))
        ops_k.occluded_bvh_sorted = (
            lambda g, b, o, d, tn, tf, lo, hi, perm=None, **kw:
            ops_k.occluded_bvh(g, b, o, d, tn, tf))
    elif name != 'kernel':
        raise ValueError(name)
    jax.clear_caches()

    def undo():
        (pt.traversal_kind, ops_k.intersect_bvh_sorted,
         ops_k.occluded_bvh_sorted) = saved
        jax.clear_caches()
    return undo


def camera_for(scene_name, size, kind):
    from yulio_raytracer.cameras import cameras as gcam
    from yulio_raytracer.io import builtin_scenes
    cam_fn = {'cornell_box': 'cornell_camera'}.get(scene_name,
                                                   scene_name + '_camera')
    pin = getattr(builtin_scenes, cam_fn)(size, size)
    if kind == 'pinhole':
        return pin
    pose = pin.local2world
    return gcam.make_stereo_rig(pose, origin=pose[3], scene_scale=0.05)[1]


def run(scene_name, size, depth, spp, leaf, quality, traversal, bvh,
        camera, reps):
    import jax
    from yulio_raytracer import renderer
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.io import builtin_scenes
    force = {'auto': None, 'on': True, 'off': False}[bvh]
    t0 = time.perf_counter()
    scene = getattr(builtin_scenes, scene_name)().commit(
        leaf_size=leaf, quality=quality, force_bvh=force)
    commit_s = time.perf_counter() - t0
    cam = camera_for(scene_name, size, camera)
    params = pt.PTParams(max_depth=depth)
    undo = _use_traversal(traversal)
    try:
        secs, rays = [], 0.0
        for seed in range(1 + reps):
            t0 = time.perf_counter()
            film, st = renderer.render_frame(scene, cam, params, size, size,
                                             spp, seed=seed,
                                             progress_cb=lambda f: None)
            jax.block_until_ready(film.rgb_sum)
            secs.append(time.perf_counter() - t0)
            rays = st.num_rays
    finally:
        undo()
    med = float(np.median(secs[1:]))
    return dict(scene=scene_name, tris=scene.num_triangles, size=size,
                depth=depth, spp=spp, leaf=leaf, quality=quality,
                traversal=traversal, bvh=scene.bvh is not None,
                camera=camera, frame_s=med, first_s=secs[0],
                frames_s=secs[1:], mrays_per_s=rays / med / 1e6,
                commit_s=commit_s)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--scene', nargs='+', default=['sponza_like'])
    ap.add_argument('--size', type=int, default=1536)
    ap.add_argument('--depth', type=int, default=10)
    ap.add_argument('--spp', type=int, default=1)
    ap.add_argument('--leaf', type=int, nargs='+', default=[8])
    ap.add_argument('--quality', nargs='+', default=['high'])
    ap.add_argument('--traversal', nargs='+', default=['kernel'])
    ap.add_argument('--bvh', nargs='+', default=['auto'],
                    choices=['auto', 'on', 'off'])
    ap.add_argument('--camera', default='stereo',
                    choices=['stereo', 'pinhole'])
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--out', default=None)
    a = ap.parse_args()

    import jax
    from yulio_raytracer.utils import compile_cache
    compile_cache.enable()
    dev = jax.devices()[0]
    print('# device: %s %s x%d' % (dev.platform, dev.device_kind,
                                   len(jax.devices())), flush=True)
    rows = []
    for combo in itertools.product(a.scene, a.leaf, a.quality,
                                   a.traversal, a.bvh):
        row = run(combo[0], a.size, a.depth, a.spp, *combo[1:],
                  a.camera, a.reps)
        row['device'] = dev.device_kind
        print(json.dumps(row), flush=True)
        rows.append(row)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, 'w') as f:
            json.dump(rows, f, indent=1)


if __name__ == '__main__':
    main()
