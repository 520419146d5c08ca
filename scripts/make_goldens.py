"""Generate pinned CPU oracle renders for the on-device parity gates.

main() forces the CPU backend (run it as a fresh process).  Each golden
is the plain-XLA render of a small deterministic config; chip_smoke.py
and bench.py re-render the same CONFIGS on the GPU, where BVH scenes
take the traversal kernel, and gate the PSNR at >= 40 dB (BASELINE.md
hardware-parity acceptance).

Usage: python scripts/make_goldens.py [name ...]   (default: all)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), '..'))

import numpy as np  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'golden')

# name -> (scene thunk, camera thunk, max_depth, spp, commit kwargs[, res])
# Shared by chip_smoke.py and bench.py: the GPU side renders the
# IDENTICAL config.
CONFIGS = {
    'cornell_64': ('cornell_box', 'cornell_camera', 4, 32, {}),
    'sphere_glass_64': ('sphere_glass', 'sphere_glass_camera', 8, 32, {}),
    'colonnade_64': ('colonnade', 'colonnade_camera', 3, 8,
                     dict(leaf_size=32)),
    'sponza_64': ('sponza_like', 'sponza_like_camera', 2, 4,
                  dict(leaf_size=32)),
    'motion_64': ('motion_field', 'motion_field_camera', 2, 16, {}),
    # fast-tier dielectric golden for the default pytest run (the full
    # 64^2 spp-32 depth-8 render is ~190 s on this 1-core box and lives
    # behind -m slow; this 32^2 config pins the same refraction/Beer/
    # texture semantics in ~1/20 the work)
    'sphere_glass_32': ('sphere_glass', 'sphere_glass_camera', 6, 8,
                        {}, 32),
    # StereoCube ray-generation parity (traced face index, eye offset,
    # falloff, head rotation) — gates the stereo camera path on the GPU
    'stereo_64': ('cornell_box', 'cornell_stereo_camera', 2, 8, {}),
}
SEED = 42
RES = 64
# the on-device parity gates (chip_smoke.py phase 3)
PARITY = ('cornell_64', 'sphere_glass_64', 'stereo_64', 'motion_64',
          'colonnade_64', 'sponza_64')


def golden_path(name):
    return os.path.join(GOLDEN_DIR, name + '_cpu.npz')


def psnr(img, ref):
    """PSNR of img against ref, peak = ref's maximum (BASELINE.md)."""
    mse = float(((np.asarray(img) - ref) ** 2).mean())
    return 10.0 * np.log10(max(float(ref.max()), 1e-9) ** 2
                           / max(mse, 1e-20))


def render_config(name):
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer import renderer
    from yulio_raytracer.film import accum

    cfg = CONFIGS[name]
    scene_fn, cam_fn, depth, spp, ckw = cfg[:5]
    res = cfg[5] if len(cfg) > 5 else RES
    scene = getattr(builtin_scenes, scene_fn)().commit(**ckw)
    cam = getattr(builtin_scenes, cam_fn)(res, res)
    film, _ = renderer.render_frame(scene, cam, pt.PTParams(max_depth=depth),
                                    res, res, spp=spp, seed=SEED)
    return np.asarray(accum.resolve(film))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == 'cpu', jax.default_backend()
    names = sys.argv[1:] or list(CONFIGS)
    for name in names:
        import time
        t0 = time.perf_counter()
        img = render_config(name)
        path = golden_path(name)
        np.savez_compressed(path, img=img.astype(np.float32))
        print("%s: %.1fs mean=%.4f -> %s"
              % (name, time.perf_counter() - t0, img.mean(), path),
              flush=True)


if __name__ == '__main__':
    main()
