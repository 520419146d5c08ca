import numpy as np
import jax.numpy as jnp

from yulio_raytracer.film import accum, tonemap


def test_accumulate_and_resolve():
    film = accum.create(4, 4)
    rgb1 = jnp.ones((4, 4, 3)) * 2.0
    w1 = jnp.ones((4, 4))
    film = accum.accumulate(film, rgb1, w1)
    np.testing.assert_allclose(np.asarray(accum.resolve(film)), 2.0)
    # second iteration with different value: mean of both
    film = accum.accumulate(film, jnp.ones((4, 4, 3)) * 4.0, w1)
    np.testing.assert_allclose(np.asarray(accum.resolve(film)), 3.0)
    # reset semantics (accumulate=0)
    film = accum.accumulate(film, rgb1, w1, reset=True)
    np.testing.assert_allclose(np.asarray(accum.resolve(film)), 2.0)


def test_checkpoint_roundtrip():
    film = accum.create(2, 2)
    film = accum.accumulate(film, jnp.ones((2, 2, 3)), jnp.ones((2, 2)))
    d = accum.to_numpy_checkpoint(film)
    film2 = accum.from_numpy_checkpoint(d)
    np.testing.assert_allclose(np.asarray(accum.resolve(film2)),
                               np.asarray(accum.resolve(film)))


def test_tonemap_gamma():
    rgb = jnp.full((2, 2, 3), 0.25)
    out = tonemap.tonemap(rgb, gamma=2.0)
    np.testing.assert_allclose(np.asarray(out), 0.5, atol=1e-6)
    # identity when gamma == 1
    np.testing.assert_allclose(np.asarray(tonemap.tonemap(rgb, gamma=1.0)),
                               0.25)


def test_tonemap_vignetting_center_unchanged():
    rgb = jnp.ones((9, 9, 3))
    out = np.asarray(tonemap.tonemap(rgb, gamma=1.0, vignetting=True))
    # center pixel nearly unattenuated, corners darker
    assert out[4, 4, 0] > 0.99
    assert out[0, 0, 0] < out[4, 4, 0]


def test_to_srgb_u8():
    rgb = jnp.array([[[0.0, 0.5, 1.5]]])
    out = np.asarray(tonemap.to_srgb_u8(rgb))
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out[0, 0], [0, 128, 255])


def test_render_progressive_checkpoint_resume(tmp_path):
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer import renderer
    scene = builtin_scenes.cornell_box(with_boxes=False).commit()
    cam = builtin_scenes.cornell_camera(16, 16)
    params = pt.PTParams(max_depth=2)
    ckpt = str(tmp_path / "film.npz")
    # run 2 of 4 iterations, interrupt
    stop_after = [0]
    def stop():
        stop_after[0] += 1
        return stop_after[0] > 2
    film_a, done = renderer.render_progressive(
        scene, cam, params, 16, 16, 2, 4, checkpoint_path=ckpt,
        seed=5, stop_flag=stop)
    assert done == 2
    # resume completes the remaining iterations
    film_b, done_b = renderer.render_progressive(
        scene, cam, params, 16, 16, 2, 4, checkpoint_path=ckpt, seed=5)
    assert done_b == 4
    # equals an uninterrupted 4-iteration run exactly
    film_ref = None
    for it in range(4):
        film_ref, _ = renderer.render_frame(scene, cam, params, 16, 16, 2,
                                            film=film_ref, iteration=it,
                                            seed=5)
    np.testing.assert_allclose(np.asarray(film_b.rgb_sum),
                               np.asarray(film_ref.rgb_sum), atol=1e-5)
