#!/usr/bin/env python3
"""Benchmark matrix harness — the `scripts/benchmark.py` equivalent.

The reference drives {OS} x {compiler} x {ISA} x {device} x {scenes} and
greps logs for build-time/memory/mrps (benchmark.py:243-361).  This
matrix is {intersector: dense (no BVH) | bvh} x {scenes}; results print as
a table and a JSON blob.  scripts/bench_render.py times the production
face shape.

Usage:
  python scripts/benchmark.py [--spp 16] [--size 512] [--frames 2]
                              [--scenes cornell,cornell_empty,sphere_glass]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '..', 'assets', 'scenes')


def _load_scene(name, force_bvh):
    from yulio_raytracer.io import builtin_scenes, ecs
    from yulio_raytracer.scene import SceneBuilder
    from yulio_raytracer.cameras import cameras as cam
    if name == 'cornell':
        sb = builtin_scenes.cornell_box()
        camera = lambda w, h: builtin_scenes.cornell_camera(w, h)
    elif name == 'cornell_empty':
        sb = builtin_scenes.cornell_box(with_boxes=False)
        camera = lambda w, h: builtin_scenes.cornell_camera(w, h)
    elif name == 'colonnade':
        sb = builtin_scenes.colonnade()
        camera = lambda w, h: builtin_scenes.colonnade_camera(w, h)
    elif name == 'sponza_like':
        sb = builtin_scenes.sponza_like()
        camera = lambda w, h: builtin_scenes.sponza_like_camera(w, h)
    elif name == 'sponza_big':
        # ~2.5x the sponza_like shell (588k tris): the multi-100k-tri
        # commit-latency regime
        sb = builtin_scenes.sponza_like(stories=3, cols_x=12, cols_z=6,
                                        clutter=140)
        camera = lambda w, h: builtin_scenes.sponza_like_camera(w, h)
    elif name == 'sphere_glass':
        settings = ecs.RenderSettings()
        sb = SceneBuilder()
        ecs.load_scene_file(os.path.join(ASSETS, 'sphere_glass.xml'),
                            settings, sb)
        from yulio_raytracer.lights import lights as gl
        sb.add_light(gl.ambient((1.0, 1.0, 1.0)))
        l2w = cam.look_at((300, 150, 300), (0, 80, 0), (0, 1, 0))
        camera = lambda w, h: cam.Pinhole(l2w, angle=50.0, aspect=w / h)
    else:
        raise ValueError(f"unknown scene {name}")
    t0 = time.perf_counter()
    scene = sb.commit(force_bvh=force_bvh)
    build_s = time.perf_counter() - t0
    return scene, camera, build_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--spp', type=int, default=16)
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--frames', type=int, default=2)
    ap.add_argument('--depth', type=int, default=4)
    ap.add_argument('--scenes', default='cornell,sphere_glass')
    ap.add_argument('--modes', default='dense')   # dense,bvh
    ap.add_argument('--out', default=None,
                    help='also write the JSON results to this file')
    args = ap.parse_args()

    import jax
    import jax.numpy as _jnp
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer import renderer

    from yulio_raytracer.utils import compile_cache
    compile_cache.enable()
    # initialize the backend so the first row's build_s times the
    # commit, not backend start-up
    jax.block_until_ready(_jnp.zeros(8) + 1.0)

    results = []
    for scene_name in args.scenes.split(','):
        for mode in args.modes.split(','):
            scene, camera_fn, build_s = _load_scene(scene_name,
                                                    mode == 'bvh')
            if mode == 'dense':
                # brute force is O(rays x tris) per bounce; gate by the
                # frame's camera-ray pair count so big scenes (colonnade
                # 87k, sponza 238k tris) don't eat the whole matrix's
                # wall time — the dense intersector is the small-scene
                # path by design
                pairs = (float(scene.num_triangles)
                         * args.size * args.size * args.spp)
                if pairs > 1e11:
                    print(f"{scene_name:16s} dense  skipped "
                          f"({pairs:.1e} pairs/frame)", flush=True)
                    continue
            camera = camera_fn(args.size, args.size)
            params = pt.PTParams(max_depth=args.depth)
            mrps_all = []
            secs = []
            for frame in range(args.frames):
                _, stats = renderer.render_frame(
                    scene, camera, params, args.size, args.size,
                    spp=args.spp, seed=frame)
                mrps_all.append(stats.mrps)
                secs.append(stats.seconds)
            row = {
                'scene': scene_name,
                'mode': mode,
                'tris': scene.num_triangles,
                'build_s': round(build_s, 3),
                'bvh_nodes': (0 if scene.bvh is None
                              else int(scene.bvh['lo'].shape[0])),
                'size': args.size,
                'spp': args.spp,
                'first_s': round(secs[0], 3),
                'steady_s': round(secs[-1], 3),
                'mrps': round(mrps_all[-1], 3),
            }
            results.append(row)
            print(f"{scene_name:16s} {mode:6s} tris={row['tris']:<8d} "
                  f"build={row['build_s']:.2f}s "
                  f"steady={row['steady_s']:.2f}s "
                  f"mrps={row['mrps']:.2f}", flush=True)
    blob = {
        'device': str(jax.devices()[0]),
        'config': {'size': args.size, 'spp': args.spp,
                   'depth': args.depth, 'frames': args.frames},
        'results': results,
    }
    print(json.dumps(blob))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(blob, f, indent=1)


if __name__ == '__main__':
    main()
