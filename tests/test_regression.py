"""Random-scene fuzzing (the -regression mode as an actual test)."""
import numpy as np
import jax.numpy as jnp

from yulio_raytracer.utils import regression
from yulio_raytracer.integrator import pathtracer as pt
from yulio_raytracer.integrator import debugrenderer
from yulio_raytracer.cameras import cameras as cam
from yulio_raytracer import renderer
from yulio_raytracer.film import accum


def _camera():
    return cam.Pinhole(cam.look_at((0, 3, -12), (0, 0, 0), (0, 1, 0)),
                       angle=60.0, aspect=1.0)


def test_random_scenes_render_finite():
    for seed in range(4):
        sb = regression.create_random_scene(seed)
        scene = sb.commit()
        film, _ = renderer.render_frame(
            scene, _camera(), pt.PTParams(max_depth=3), 24, 24, spp=2,
            seed=seed)
        img = np.asarray(accum.resolve(film))
        assert np.isfinite(img).all(), f"non-finite output at seed {seed}"
        assert (img >= 0).all(), f"negative radiance at seed {seed}"


def test_random_scene_with_bvh_matches_brute():
    sb = regression.create_random_scene(11, num_shapes=6)
    scene_a = sb.commit(force_bvh=False)
    scene_b = sb.commit(force_bvh=True, leaf_size=16)
    p = pt.PTParams(max_depth=2)
    f1, _ = renderer.render_frame(scene_a, _camera(), p, 16, 16, spp=2,
                                  seed=0)
    f2, _ = renderer.render_frame(scene_b, _camera(), p, 16, 16, spp=2,
                                  seed=0)
    np.testing.assert_allclose(np.asarray(accum.resolve(f1)),
                               np.asarray(accum.resolve(f2)),
                               rtol=2e-3, atol=2e-3)


def test_debug_renderer():
    sb = regression.create_random_scene(3)
    scene = sb.commit()
    camera = _camera()
    n = 256
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing='ij')
    uv = jnp.asarray(np.stack([(xs.ravel() + 0.5) / 16,
                               (ys.ravel() + 0.5) / 16], -1), jnp.float32)
    org, d = camera.ray(uv, jnp.full((n, 2), 0.5))
    color, nrays = debugrenderer.trace(
        scene, debugrenderer.DebugParams(max_depth=2), org, d, 0,
        jnp.arange(n, dtype=jnp.uint32))
    c = np.asarray(color)
    assert set(np.unique(c)).issubset({0.0, 1.0})
    assert float(nrays) >= n


def test_spp_sweep_reuses_compiled_graph():
    """Dynamic spp (PARITY backlog item): the stratification
    grid is traced (patterns.grid_scalars), so an spp sweep reuses the
    compiled chunk instead of paying one compile per value.  Graph count
    is bounded by distinct (spp_per_pass, shapes) pairs: for this sweep
    the folded-samples shape is quantized to powers of two, so {4..64}
    costs at most 3 compiles and re-rendering any spp costs none.
    Determinism contract: per-(seed, spp) results stay bit-identical —
    each ray is keyed by absolute (pixel, sample) ids."""
    sb = regression.create_random_scene(5)
    scene = sb.commit(force_bvh=True)
    camera = _camera()
    base = renderer._render_chunk._cache_size()
    films = {}
    for spp in (4, 8, 16, 32, 64):
        film, _ = renderer.render_frame(scene, camera,
                                        pt.PTParams(max_depth=2),
                                        32, 32, spp=spp, seed=7)
        films[spp] = np.asarray(accum.resolve(film))
    compiles = renderer._render_chunk._cache_size() - base
    assert compiles <= 3, f"spp sweep compiled {compiles} distinct graphs"
    # re-running a swept spp is compile-free and bit-identical
    film, _ = renderer.render_frame(scene, camera, pt.PTParams(max_depth=2),
                                    32, 32, spp=16, seed=7)
    assert renderer._render_chunk._cache_size() - base == compiles
    np.testing.assert_array_equal(np.asarray(accum.resolve(film)),
                                  films[16])
