"""Benchmark driver: renders the benchmark scenes on the available device
and prints one JSON line per metric, each naming the device.

Metrics:
* <golden>_vs_cpu_psnr — hardware parity: the pinned CPU-oracle golden
  configs (scripts/make_goldens.py PARITY) re-rendered on this device;
  BASELINE.md:16 demands >= 40 dB.
* cornell_512_mrps — small-scene path (512x512, 32 spp, depth 4).
* sponza_like_1024_mrps — textured 238k-triangle interior, depth 4.
* stereo_face_1536_mrps — the production render configuration's load
  shape (YulioRT.h:38-41: 1536^2 StereoCube face, depth 10,
  tMaxShadowRay 120) on the colonnade scene, at reduced spp (the full
  256 spp face is the same compiled step run more times).
* colonnade_1024_mrps — 1024x1024, 8 spp, depth 4.

Mrays/s is measured the reference's way — rays traced / wall seconds,
steady state (integratorrenderer.cpp:101-111, scripts/benchmark.py:360).
Every Mrays/s metric is the MEDIAN of 3 timed frames (different seeds),
with "min"/"max"/"repeats", "compile_s" (the warm-up frame: compilation
plus one frame) and, for the deep configs, "live_fraction" = live lanes /
dispatched lanes across the wavefront.
"""
import json
import os
import sys

from yulio_raytracer.utils import hostmem

hostmem.tune_malloc()

ROOT = os.path.dirname(os.path.abspath(__file__))
PSNR_TARGET_DB = 40.0       # BASELINE.md:16 hardware-parity acceptance


def _timed_frames(scene, camera, params, w, h, spp, repeats: int = 3,
                  live_fraction: bool = False):
    """Warm-up (compile) + `repeats` timed frames with distinct seeds.
    Returns (median FrameStats, extras dict)."""
    import time
    from yulio_raytracer import renderer

    t0 = time.perf_counter()
    renderer.render_frame(scene, camera, params, w, h, spp=spp, seed=0)
    compile_s = time.perf_counter() - t0
    runs = []
    width = live = 0
    for seed in range(1, 1 + repeats):
        stats_list = [] if (live_fraction and seed == 1) else None
        _, st = renderer.render_frame(scene, camera, params, w, h,
                                      spp=spp, seed=seed,
                                      bounce_stats=stats_list)
        runs.append(st)
        if stats_list:
            width = sum(e['width'] for e in stats_list)
            live = sum(e['live'] for e in stats_list)
    runs.sort(key=lambda s: s.mrps)
    med = runs[len(runs) // 2]
    extras = {"min": round(runs[0].mrps, 3),
              "max": round(runs[-1].mrps, 3),
              "repeats": repeats,
              "compile_s": round(compile_s, 1),
              "frame_s": round(med.seconds, 3),
              "mray": round(med.num_rays / 1e6, 1)}
    if width:
        extras["live_fraction"] = round(live / width, 4)
    return med, extras


def bench_cornell():
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt

    scene = builtin_scenes.cornell_box().commit()
    camera = builtin_scenes.cornell_camera(512, 512)
    params = pt.PTParams(max_depth=4)
    stats, extras = _timed_frames(scene, camera, params, 512, 512, spp=32)
    return "cornell_512_mrps", stats, extras


def bench_colonnade():
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt

    scene = builtin_scenes.colonnade().commit()
    camera = builtin_scenes.colonnade_camera(1024, 1024)
    params = pt.PTParams(max_depth=4)
    stats, extras = _timed_frames(scene, camera, params, 1024, 1024,
                                  spp=8)
    return "colonnade_1024_mrps", stats, extras


def bench_stereo_face():
    """One production cube face: the REAL StereoCube camera (eye offset,
    falloff, head rotation — not a pinhole stand-in) at the YulioRT.h
    production config's load shape.  All 12 faces share one compiled
    graph (traced face index), so face 1 is representative."""
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.cameras import cameras as cam

    scene = builtin_scenes.colonnade().commit()
    l2w = cam.look_at((-9.0, 2.2, 0.0), (10.0, 1.6, 0.0), (0.0, 1.0, 0.0))
    rig = cam.make_stereo_rig(l2w, scene_scale=0.05)
    camera = rig[1]                    # right-face, left eye
    params = pt.PTParams(max_depth=10, t_max_shadow_ray=120.0)
    stats, extras = _timed_frames(scene, camera, params, 1536, 1536,
                                  spp=2, live_fraction=True)
    return "stereo_face_1536_mrps", stats, extras


def bench_sponza():
    """Texture-heavy Sponza-class regime (238k tris, 20 textures,
    1024x1024): texture-atlas gather cost at scale."""
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt

    scene = builtin_scenes.sponza_like().commit()
    camera = builtin_scenes.sponza_like_camera(1024, 1024)
    params = pt.PTParams(max_depth=4)
    stats, extras = _timed_frames(scene, camera, params, 1024, 1024,
                                  spp=8)
    return "sponza_like_1024_mrps", stats, extras


def main():
    import jax
    from yulio_raytracer.utils import compile_cache
    compile_cache.enable()
    sys.path.insert(0, os.path.join(ROOT, 'scripts'))
    import numpy as np
    import make_goldens as mg

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for name in mg.PARITY:
        psnr = mg.psnr(mg.render_config(name),
                       np.load(mg.golden_path(name))['img'])
        print(json.dumps({
            "metric": name + "_vs_cpu_psnr",
            "value": round(psnr, 2),
            "unit": "dB",
            "vs_baseline": round(psnr / PSNR_TARGET_DB, 4),
            "device": device,
        }), flush=True)
    for fn in (bench_cornell, bench_sponza, bench_stereo_face,
               bench_colonnade):
        metric, stats, extras = fn()
        print(json.dumps({
            "metric": metric,
            "value": round(stats.mrps, 3),
            "unit": "Mrays/s",
            **extras,
            "device": device,
        }), flush=True)


if __name__ == '__main__':
    main()
