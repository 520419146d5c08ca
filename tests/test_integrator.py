import numpy as np
import jax.numpy as jnp

from yulio_raytracer.scene import SceneBuilder
from yulio_raytracer.geometry.mesh import HostMesh
from yulio_raytracer.shading import materials as gmat
from yulio_raytracer.lights import lights as glights
from yulio_raytracer.integrator import pathtracer as pt
from yulio_raytracer.cameras import cameras as cam
from yulio_raytracer.io import builtin_scenes
from yulio_raytracer import renderer
from yulio_raytracer.film import accum


def _floor(material, size=1000.0, y=0.0):
    pos = np.asarray([[-size, y, -size], [size, y, -size],
                      [size, y, size], [-size, y, size]], np.float32)
    tri = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    nrm = np.tile([[0.0, 1.0, 0.0]], (4, 1)).astype(np.float32)
    return HostMesh(pos, tri, nrm, material=material)


def _down_rays(n, height=5.0):
    rs = np.random.RandomState(0)
    org = np.zeros((n, 3), np.float32)
    org[:, 0] = rs.uniform(-5, 5, n)
    org[:, 2] = rs.uniform(-5, 5, n)
    org[:, 1] = height
    d = np.tile([[0.0, -1.0, 0.0]], (n, 1)).astype(np.float32)
    return jnp.asarray(org), jnp.asarray(d)


def _ids(n):
    return (jnp.arange(n, dtype=jnp.uint32), jnp.zeros((n,), jnp.uint32))


def test_env_only():
    """No geometry: every ray escapes to the ambient light exactly."""
    sb = SceneBuilder()
    sb.add_light(glights.ambient((0.3, 0.6, 0.9)))
    scene = sb.commit()
    n = 64
    org, d = _down_rays(n, height=5.0)
    # point rays up so they never hit the (empty) scene
    pid, sid = _ids(n)
    L, nrays = pt.trace(scene, pt.PTParams(max_depth=2), org, -d,
                        0, pid, sid)
    np.testing.assert_allclose(np.asarray(L),
                               np.tile([[0.3, 0.6, 0.9]], (n, 1)), atol=1e-6)


def test_ambient_floor_analytic():
    """Matte floor under a uniform dome: NEE with cosine light sampling is
    zero-variance -> every sample == albedo * L exactly (depth 2: the GI
    bounce escapes but ignore_vl suppresses env double-count)."""
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte',
                                           {'reflectance': (0.6, 0.4, 0.2)}))
    sb.add_mesh(_floor(m))
    sb.add_light(glights.ambient((1.0, 1.0, 1.0)))
    scene = sb.commit()
    n = 256
    org, d = _down_rays(n)
    pid, sid = _ids(n)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    np.testing.assert_allclose(np.asarray(L),
                               np.tile([[0.6, 0.4, 0.2]], (n, 1)), atol=1e-3)


def test_point_light_inverse_square():
    """Point light: L = I * rho/pi * cos / d^2 analytically."""
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {'reflectance': 0.5}))
    sb.add_mesh(_floor(m))
    light_pos = np.asarray([0.0, 2.0, 0.0])
    sb.add_light(glights.point(light_pos, (10.0, 10.0, 10.0)))
    scene = sb.commit()
    n = 128
    org, d = _down_rays(n)
    pid, sid = _ids(n)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    hitp = np.array(org, copy=True)
    hitp[:, 1] = 0.0
    dvec = light_pos - hitp
    dist2 = (dvec ** 2).sum(1)
    cos = dvec[:, 1] / np.sqrt(dist2)
    expect = 10.0 * 0.5 / np.pi * cos / dist2
    np.testing.assert_allclose(np.asarray(L)[:, 0], expect, rtol=1e-3)


def test_mirror_reflects_environment():
    """Specular bounce keeps env visible (ignore_vl only set for diffuse)."""
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('mirror',
                                           {'reflectance': (0.8, 0.8, 0.8)}))
    sb.add_mesh(_floor(m))
    sb.add_light(glights.ambient((1.0, 1.0, 1.0)))
    scene = sb.commit()
    n = 64
    org, d = _down_rays(n)
    pid, sid = _ids(n)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=3), org, d, 0, pid, sid)
    np.testing.assert_allclose(np.asarray(L), 0.8, atol=1e-4)


def test_shadowing():
    """An occluder between the floor and a point light casts a shadow."""
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {'reflectance': 0.5}))
    sb.add_mesh(_floor(m))
    # small blocker quad right under the light
    blocker = _floor(m, size=0.5, y=1.0)
    sb.add_mesh(blocker)
    sb.add_light(glights.point((0.0, 2.0, 0.0), (10.0, 10.0, 10.0)))
    scene = sb.commit()
    org = jnp.asarray([[0.0, 5.0, 0.0], [3.0, 5.0, 0.0]])  # shadowed, lit
    # start rays off-axis so they don't hit the blocker
    org = jnp.asarray([[0.1, 0.5, 0.1], [3.0, 5.0, 0.0]])
    d = jnp.asarray([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    pid, sid = _ids(2)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    l = np.asarray(L)
    assert l[0, 0] == 0.0        # under the blocker: fully shadowed
    assert l[1, 0] > 0.0         # outside: lit


def test_tmax_shadow_ray_dome_trick():
    """With a finite tMaxShadowRay, occluders beyond the cap stop blocking
    (the Yulio fake-ambient trick, pathtraceintegrator.cpp:148-157)."""
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {'reflectance': 0.5}))
    sb.add_mesh(_floor(m, size=1000.0))            # floor at y=0
    sb.add_mesh(_floor(m, size=1000.0, y=50.0))    # "ceiling" far above
    sb.add_light(glights.ambient((1.0, 1.0, 1.0)))
    scene = sb.commit()
    n = 128
    org, d = _down_rays(n, height=5.0)
    pid, sid = _ids(n)
    # without cap: dome fully occluded by the ceiling -> only GI, which at
    # depth 2 is suppressed by ignore_vl -> nearly black
    L0, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, pid, sid)
    # with a 10-unit cap: shadow rays stop before the ceiling -> lit
    L1, _ = pt.trace(scene, pt.PTParams(max_depth=2, t_max_shadow_ray=10.0,
                                        t_max_shadow_jitter=0.0),
                     org, d, 0, pid, sid)
    assert float(jnp.mean(L0)) < 0.01
    assert float(jnp.mean(L1)) > 0.4


def test_glass_sphere_energy():
    """Rays through a glass slab keep carrying energy (refraction path)."""
    sb = SceneBuilder()
    g = sb.add_material(gmat.make_material('glass', {'etaInside': 1.5}))
    m = sb.add_material(gmat.make_material('matte', {'reflectance': 0.8}))
    # closed glass slab (two interfaces, so the eta^2 radiance-compression
    # factors of enter/exit cancel) above a white floor
    sb.add_mesh(_floor(g, size=2.0, y=2.0))
    sb.add_mesh(_floor(g, size=2.0, y=1.9))
    sb.add_mesh(_floor(m, size=50.0))
    sb.add_light(glights.ambient((1.0, 1.0, 1.0)))
    scene = sb.commit()
    n = 512
    org, d = _down_rays(n, height=5.0)
    org = org.at[:, 0].set(jnp.linspace(-1.5, 1.5, n))
    org = org.at[:, 2].set(0.0)
    pid, sid = _ids(n)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=6), org, d, 0, pid, sid)
    mean = float(jnp.mean(L))
    assert 0.3 < mean < 1.0  # light passes through, some fresnel loss


def test_cornell_box_smoke():
    """64x64 Cornell render: GI color bleeding + emissive light patch."""
    scene = builtin_scenes.cornell_box().commit()
    camera = builtin_scenes.cornell_camera(64, 64)
    film, stats = renderer.render_frame(
        scene, camera, pt.PTParams(max_depth=2), 64, 64, spp=8, seed=1)
    img = np.asarray(accum.resolve(film))
    assert np.isfinite(img).all()
    mean = img.mean()
    assert 0.05 < mean < 3.0
    # ceiling light visible: brightest few pixels should be >= emitter-ish
    assert img.max() > 5.0
    # left side of image (green wall at x=0 is on the RIGHT of the view
    # from -z looking at +z ... check color separation: one side redder,
    # other greener
    left = img[:, :16]
    right = img[:, -16:]
    red_bias_left = left[..., 0].mean() - left[..., 1].mean()
    red_bias_right = right[..., 0].mean() - right[..., 1].mean()
    assert red_bias_left != red_bias_right
    # determinism
    film2, _ = renderer.render_frame(
        scene, camera, pt.PTParams(max_depth=2), 64, 64, spp=8, seed=1)
    np.testing.assert_array_equal(np.asarray(film.rgb_sum),
                                  np.asarray(film2.rgb_sum))


def test_compacted_driver_matches_scan():
    """trace_compacted (host-driven per-bounce dispatch with live-ray
    compaction) is BIT-identical to the lax.scan
    trace(): compaction only ever drops dead lanes, whose L is already
    final, and per-lane math is order-independent.  Also checks the
    per-bounce stats stream (live counts must be non-increasing and the
    RR cliff at rr_depth must show)."""
    import numpy as np
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer import renderer

    scene = builtin_scenes.cornell_box().commit(force_bvh=True)
    cam = builtin_scenes.cornell_camera(32, 32)
    params = pt.PTParams(max_depth=8)
    film1, st1 = renderer.render_frame(scene, cam, params, 32, 32, spp=4,
                                       seed=3, compaction='off')
    stats = []
    film2, st2 = renderer.render_frame(scene, cam, params, 32, 32, spp=4,
                                       seed=3, compaction='auto',
                                       bounce_stats=stats)
    assert np.array_equal(np.asarray(film1.rgb_sum),
                          np.asarray(film2.rgb_sum))
    assert st1.num_rays == st2.num_rays
    lives = [s['live'] for s in stats]
    widths = [s['width'] for s in stats]
    assert lives == sorted(lives, reverse=True)
    assert widths == sorted(widths, reverse=True)
    assert all(w >= l for w, l in zip(widths[1:], lives[:-1])), \
        "a bounce ran narrower than its live count (lossy!)"
    # Russian roulette from rr_depth=5 must collapse the live set
    assert lives[-1] < lives[0] // 4


def test_compacted_driver_precomputed_sampler():
    """The precomputed-sampler tables ride the compacted state (per-ray
    set/sidx picks are gathered with the wavefront)."""
    import numpy as np
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer import renderer

    scene = builtin_scenes.cornell_box().commit(force_bvh=True)
    cam = builtin_scenes.cornell_camera(24, 24)
    params = pt.PTParams(max_depth=6)
    f1, _ = renderer.render_frame(scene, cam, params, 24, 24, spp=4,
                                  seed=5, sampler='precomputed',
                                  compaction='off')
    f2, _ = renderer.render_frame(scene, cam, params, 24, 24, spp=4,
                                  seed=5, sampler='precomputed',
                                  compaction='auto')
    assert np.array_equal(np.asarray(f1.rgb_sum), np.asarray(f2.rgb_sum))


def test_compaction_auto_gate():
    """'auto' compacts only past the Russian-roulette start
    (max_depth > rr_depth): shallow configs keep the scan form (no
    bounce_stats stream), 'on' forces the compacted driver, and both
    agree bit-exactly with 'off'."""
    import numpy as np
    import pytest
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer import renderer

    scene = builtin_scenes.cornell_box().commit(force_bvh=True)
    cam = builtin_scenes.cornell_camera(16, 16)
    params = pt.PTParams(max_depth=4)          # <= rr_depth (5)
    stats = []
    f_auto, _ = renderer.render_frame(scene, cam, params, 16, 16, spp=2,
                                      seed=7, compaction='auto',
                                      bounce_stats=stats)
    assert stats == [], "'auto' compacted a shallow (pre-RR) config"
    stats_on = []
    f_on, _ = renderer.render_frame(scene, cam, params, 16, 16, spp=2,
                                    seed=7, compaction='on',
                                    bounce_stats=stats_on)
    assert stats_on, "'on' did not force the compacted driver"
    np.testing.assert_array_equal(np.asarray(f_auto.rgb_sum),
                                  np.asarray(f_on.rgb_sum))
    with pytest.raises(ValueError):
        renderer.render_frame(scene, cam, params, 16, 16, spp=1,
                              seed=7, compaction='yes')


def test_pass_budget_watchdog_math():
    """Pass budgets come from device memory: the BVH path probes the
    bounce step's compiled footprint against free device memory and
    halves until it fits; backends without memory statistics take the
    frame's own width (capped at _MAX_PASS_RAYS); the dense path bounds
    rays x triangle-block temporaries."""
    import types
    from yulio_raytracer import renderer
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt

    scene = builtin_scenes.cornell_box().commit(force_bvh=True)
    p = pt.PTParams(max_depth=10)
    npix = 1536 * 1536
    # no memory statistics (the CPU): the frame's width, one pass
    b, cap = renderer._pass_budget(scene, p, 1, npix)
    assert (b, cap) == (npix, 1)
    b, cap = renderer._pass_budget(scene, p, 8, 8 * npix)
    assert (b, cap) == (8 * npix, 1)
    b, cap = renderer._pass_budget(scene, p, 1, 256 * npix)
    assert b == renderer._MAX_PASS_RAYS
    # with statistics: halve until bounce_bytes fits the memory share
    per_ray = 4096
    saved = (renderer._free_device_bytes, pt.bounce_bytes)
    try:
        renderer._budget_cache.clear()
        renderer._free_device_bytes = lambda: 3 << 30
        pt.bounce_bytes = lambda scene, params, w: w * per_ray
        b, cap = renderer._pass_budget(scene, p, 1, npix)
        assert cap == 1
        assert b * per_ray <= renderer._PASS_MEMORY_SHARE * (3 << 30)
        assert 2 * b * per_ray > renderer._PASS_MEMORY_SHARE * (3 << 30)
        # a device with room for the whole frame runs it in one pass
        renderer._free_device_bytes = lambda: 1 << 40
        assert renderer._pass_budget(scene, p, 1, npix)[0] == npix
        # never below _MIN_PASS_RAYS
        renderer._free_device_bytes = lambda: 1 << 20
        b = renderer._pass_budget(scene, p, 1, npix)[0]
        assert renderer._MIN_PASS_RAYS <= b < 2 * renderer._MIN_PASS_RAYS
    finally:
        renderer._free_device_bytes, pt.bounce_bytes = saved
        renderer._budget_cache.clear()
    # dense (no-BVH) path: rays x triangle-block temporaries bounded
    for tris in (128, 4992, 238208):
        fake = types.SimpleNamespace(bvh=None, num_triangles=tris)
        b, cap = renderer._pass_budget(fake, p, 1, npix)
        assert cap is None and b >= 1 << 14
        assert b * min(tris, 2048) <= 3 << 26 or b == 1 << 14


def test_bounce_memory_analysis():
    """bounce_bytes reads the compiled bounce step's memory analysis and
    grows with the wavefront width."""
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt

    scene = builtin_scenes.cornell_box().commit(force_bvh=True)
    p = pt.PTParams(max_depth=3)
    small = pt.bounce_bytes(scene, p, 256)
    big = pt.bounce_bytes(scene, p, 1024)
    assert 0 < small < big


def test_compact_widths_math():
    """Bucket widths: descending, include the full width, ceil(r/d) per
    divisor (no alignment: the GPU kernel takes any ray count)."""
    from yulio_raytracer.integrator.pathtracer import compact_widths

    r = 1 << 21
    ws = compact_widths(r, divisors=(1, 4, 16))
    assert ws == sorted(ws, reverse=True)
    assert ws[0] == r
    assert set(ws) == {r, r // 4, r // 16}
    assert compact_widths(1000, divisors=(1, 3, 16)) == [1000, 334, 63]
    assert compact_widths(7) == [7, 2, 1]


def test_prewarm_gating_small_wavefronts():
    """_prewarm_shrunk_widths must be a no-op for small wavefronts
    (tests/tiny renders must not spawn compile threads) and must not
    touch the scene before the gate."""
    import jax.numpy as jnp
    from yulio_raytracer.integrator import pathtracer as pt

    n_keys = len(pt._PREWARM_KEYS)
    state = {'org': jnp.zeros((1024, 3))}
    # scene=None would raise on any attribute access past the gate
    pt._prewarm_shrunk_widths(None, pt.PTParams(), state,
                              [1024], jnp.uint32(0), None, None)
    assert len(pt._PREWARM_KEYS) == n_keys
    # no shrunk widths -> no-op even for big wavefronts
    state = {'org': jnp.zeros((1 << 19, 3))}
    pt._prewarm_shrunk_widths(None, pt.PTParams(), state,
                              [1 << 19], jnp.uint32(0), None, None)
    assert len(pt._PREWARM_KEYS) == n_keys
