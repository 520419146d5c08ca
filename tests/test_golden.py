"""Pinned golden-image regression: the CPU render of the cornell golden
scene is deterministic per (seed, spp); any semantic change to sampling,
shading, lights or the integrator shows up here (SURVEY.md section 4:
golden scenes as visual regression)."""
import os

import numpy as np
import pytest

from yulio_raytracer.io import builtin_scenes
from yulio_raytracer.integrator import pathtracer as pt
from yulio_raytracer import renderer
from yulio_raytracer.film import accum

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'golden', 'cornell_64_cpu.npz')


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


def test_cornell_matches_pinned_golden():
    scene = builtin_scenes.cornell_box().commit()
    cam = builtin_scenes.cornell_camera(64, 64)
    film, _ = renderer.render_frame(scene, cam, pt.PTParams(max_depth=4),
                                    64, 64, spp=32, seed=42)
    img = np.asarray(accum.resolve(film))
    golden = np.load(GOLDEN)['img']
    # deterministic pipeline: tiny numeric drift at most
    assert _psnr(img, golden) > 60.0


def test_stereo_camera_matches_pinned_golden():
    """StereoCube ray-generation golden (traced face index, eye offset,
    vertical falloff, head rotation): pins the one-graph-for-12-faces
    camera path; chip_smoke.py renders the same config on the GPU."""
    scene = builtin_scenes.cornell_box().commit()
    cam = builtin_scenes.cornell_stereo_camera(64, 64)
    film, _ = renderer.render_frame(scene, cam, pt.PTParams(max_depth=2),
                                    64, 64, spp=8, seed=42)
    img = np.asarray(accum.resolve(film))
    golden = np.load(os.path.join(os.path.dirname(GOLDEN),
                                  'stereo_64_cpu.npz'))['img']
    assert _psnr(img, golden) > 60.0


def test_sphere_glass_matches_pinned_golden_fast():
    """Dielectric/medium golden (glass sphere + textured floor + dome):
    pins refraction, Beer-law media and texture filtering.  Fast tier:
    32^2 spp 8 depth 6 (~1/20 the full golden's work on this 1-core
    box); the full 64^2 config stays behind -m slow and doubles as
    chip_smoke.py's on-GPU dielectric parity gate."""
    scene = builtin_scenes.sphere_glass().commit()
    cam = builtin_scenes.sphere_glass_camera(32, 32)
    film, _ = renderer.render_frame(scene, cam, pt.PTParams(max_depth=6),
                                    32, 32, spp=8, seed=42)
    img = np.asarray(accum.resolve(film))
    golden = np.load(os.path.join(os.path.dirname(GOLDEN),
                                  'sphere_glass_32_cpu.npz'))['img']
    assert _psnr(img, golden) > 60.0


@pytest.mark.slow
def test_sphere_glass_matches_pinned_golden():
    """Full-size dielectric golden (the config chip_smoke.py renders on
    the GPU for the >= 40 dB hardware-parity gate)."""
    scene = builtin_scenes.sphere_glass().commit()
    cam = builtin_scenes.sphere_glass_camera(64, 64)
    film, _ = renderer.render_frame(scene, cam, pt.PTParams(max_depth=8),
                                    64, 64, spp=32, seed=42)
    img = np.asarray(accum.resolve(film))
    golden = np.load(os.path.join(os.path.dirname(GOLDEN),
                                  'sphere_glass_64_cpu.npz'))['img']
    assert _psnr(img, golden) > 60.0


def test_sample_major_batching_matches_per_sample():
    """The renderer's sample-major wavefront batching (duplicated pixel
    ids + scatter-add, renderer.py) must produce the same estimate as
    per-sample passes: every (pixel, sample) pair contributes exactly
    once.  Catches chunk-stride bugs (silent under-sampling)."""
    scene = builtin_scenes.cornell_box().commit(force_bvh=True)
    assert scene.bvh is not None
    cam = builtin_scenes.cornell_camera(32, 32)
    p = pt.PTParams(max_depth=3)
    npix = 32 * 32
    base, _ = renderer.render_frame(scene, cam, p, 32, 32, spp=4,
                                    seed=7, max_rays_per_pass=npix,
                                    spp_per_pass_cap=1)
    batched, _ = renderer.render_frame(scene, cam, p, 32, 32, spp=4,
                                       seed=7,
                                       max_rays_per_pass=4 * npix,
                                       spp_per_pass_cap=1)
    a = np.asarray(accum.resolve(base))
    b = np.asarray(accum.resolve(batched))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_different_seed_converges_to_same_image():
    """Two independent estimators agree within Monte-Carlo noise — the
    PSNR-style parity gate of BASELINE.md applied CPU-vs-CPU."""
    scene = builtin_scenes.cornell_box().commit()
    cam = builtin_scenes.cornell_camera(64, 64)
    p = pt.PTParams(max_depth=4)
    # spp 16 keeps the default run fast (measured 45.7 dB; the 30 dB
    # gate allows for MC-noise variance across environments)
    f1, _ = renderer.render_frame(scene, cam, p, 64, 64, spp=16, seed=1)
    f2, _ = renderer.render_frame(scene, cam, p, 64, 64, spp=16, seed=2)
    a = np.asarray(accum.resolve(f1))
    b = np.asarray(accum.resolve(f2))
    assert _psnr(a, b) > 30.0
