import numpy as np
import jax
import jax.numpy as jnp
import pytest

from yulio_raytracer.io import builtin_scenes
from yulio_raytracer.integrator import pathtracer as pt
from yulio_raytracer import renderer
from yulio_raytracer.parallel import sharding
from yulio_raytracer.film import accum


@pytest.fixture(scope='module')
def scene():
    return builtin_scenes.cornell_box(with_boxes=False).commit()


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_px_sharded_matches_single(scene):
    cam = builtin_scenes.cornell_camera(32, 32)
    params = pt.PTParams(max_depth=2)
    film_ref, _ = renderer.render_frame(scene, cam, params, 32, 32, spp=2,
                                        seed=3)
    mesh = sharding.make_mesh(8, tri_parallel=1)
    film_sh = sharding.render_frame_sharded(scene, cam, params, 32, 32,
                                            spp=2, mesh=mesh, seed=3)
    a = np.asarray(accum.resolve(film_ref))
    b = np.asarray(accum.resolve(film_sh))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_tri_sharded_matches_single(scene):
    cam = builtin_scenes.cornell_camera(32, 32)
    params = pt.PTParams(max_depth=2)
    # a sharded triangle axis tests each shard's triangles directly (no
    # BVH), so the single-device reference takes the same dense test
    dense = builtin_scenes.cornell_box(with_boxes=False).commit(
        force_bvh=False)
    film_ref, _ = renderer.render_frame(dense, cam, params, 32, 32, spp=2,
                                        seed=5)
    mesh = sharding.make_mesh(8, tri_parallel=4)   # 2-way px x 4-way tri
    film_sh = sharding.render_frame_sharded(scene, cam, params, 32, 32,
                                            spp=2, mesh=mesh, seed=5)
    a = np.asarray(accum.resolve(film_ref))
    b = np.asarray(accum.resolve(film_sh))
    # identical up to cross-shard closest-hit tie-breaks at triangle seams
    # (a handful of edge pixels may pick the coplanar neighbor)
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-4).mean() > 0.995, (d > 1e-4).sum()
    assert d.mean() < 1e-3


def test_sharded_accumulation(scene):
    cam = builtin_scenes.cornell_camera(32, 32)
    params = pt.PTParams(max_depth=2)
    mesh = sharding.make_mesh(8)
    f1 = sharding.render_frame_sharded(scene, cam, params, 32, 32, spp=2,
                                       mesh=mesh, seed=3)
    f2 = sharding.render_frame_sharded(scene, cam, params, 32, 32, spp=2,
                                       mesh=mesh, seed=3, film=f1,
                                       iteration=1)
    assert float(f2.weight[0, 0]) == 4.0
    # same estimator -> means agree within Monte-Carlo noise (2 spp)
    m1 = float(jnp.mean(accum.resolve(f1)))
    m2 = float(jnp.mean(accum.resolve(f2)))
    assert abs(m1 - m2) < 0.15 * max(m1, 1e-6)


def test_sharded_render_odd_size():
    """Pixel counts that don't divide the px axis pad instead of assert
    (a 1536^2 face on a 7-healthy-device mesh must render)."""
    from yulio_raytracer.parallel import sharding
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.film import accum
    import numpy as np

    scene = builtin_scenes.cornell_box(with_boxes=False).commit()
    params = pt.PTParams(max_depth=2)
    # 18x14 = 252 pixels, not divisible by 8 devices
    camera = builtin_scenes.cornell_camera(18, 14)
    mesh = sharding.make_mesh(8)
    film = sharding.render_frame_sharded(scene, camera, params, 18, 14,
                                         spp=1, mesh=mesh, seed=0)
    out = np.asarray(accum.resolve(film))
    assert out.shape == (14, 18, 3)
    assert np.isfinite(out).all()


def test_production_mesh_render_frame_bit_identical():
    """The PRODUCTION multi-chip path (renderer.render_frame(mesh=...),
    the -devices/-connect seam): bit-identical across runs on a fixed
    mesh, ulp-tight vs single-chip (XLA associates per-shard shapes
    differently), incl. odd frame sizes needing pixel padding, and
    progress/stop plumbed."""
    from yulio_raytracer import renderer as grenderer
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.parallel import sharding
    import numpy as np

    scene = builtin_scenes.cornell_box(with_boxes=False).commit()
    params = pt.PTParams(max_depth=2)
    mesh = sharding.make_mesh(8)
    for (w, h) in [(32, 32), (37, 13)]:
        cam = builtin_scenes.cornell_camera(w, h)
        fracs = []
        f1, _ = grenderer.render_frame(scene, cam, params, w, h, 2, seed=5)
        fn, _ = grenderer.render_frame(scene, cam, params, w, h, 2, seed=5,
                                       mesh=mesh,
                                       progress_cb=fracs.append)
        a, b = np.asarray(f1.rgb_sum), np.asarray(fn.rgb_sum)
        np.testing.assert_allclose(a, b, rtol=3e-6, atol=3e-7)
        fn2, _ = grenderer.render_frame(scene, cam, params, w, h, 2,
                                        seed=5, mesh=mesh)
        assert np.array_equal(b, np.asarray(fn2.rgb_sum)), (w, h)
        assert fracs and fracs[-1] == 1.0
    # stop flag short-circuits the pass loop
    stopped, _ = grenderer.render_frame(scene, cam, params, 37, 13, 2,
                                        seed=5, mesh=mesh,
                                        stop_flag=lambda: True)
    assert float(np.abs(np.asarray(stopped.rgb_sum)).sum()) == 0.0


def test_production_mesh_rejects_tri_axis():
    from yulio_raytracer import renderer as grenderer
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.parallel import sharding
    import pytest

    scene = builtin_scenes.cornell_box(with_boxes=False).commit()
    cam = builtin_scenes.cornell_camera(16, 16)
    mesh = sharding.make_mesh(8, tri_parallel=2)
    with pytest.raises(ValueError):
        grenderer.render_frame(scene, cam, pt.PTParams(max_depth=2),
                               16, 16, 1, mesh=mesh)
