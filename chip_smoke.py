"""End-to-end smoke test of the renderer on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at
production size, in ONE process (a JAX process reserves most of the
card's memory, so this script starts no second one):

1. device   — fail unless JAX's first device is a GPU; print the card's
              name and power limit (nvidia-smi, a child process that
              stays off JAX) and whether Pillow is importable;
2. build    — build the native BVH builder from native/ sources;
3. parity   — render the pinned CPU-oracle goldens through
              renderer.render_frame; each PSNR must be >= 40 dB;
4. kernel   — the GPU traversal kernel against the plain-XLA traversal on
              sponza_like (1536^2 camera rays, a bounce-1 population and a
              shadow population): times, tolerance, mismatch counts;
5. cli      — api.cli main on assets/scenes/cornell_box.ecs, 512^2 16 spp;
6. session  — StartRT/WaitRT on assets/scenes/test_room.dae at 1536^2,
              depth 10, tMaxShadowRay 120, 1 spp: 12 faces, the stereo
              strip and the watermark; then one 1536^2 depth-10 StereoCube
              face of sponza_like through render_frame as render_stereo
              calls it.  Face and compile seconds and device memory.

    python chip_smoke.py           # phases 1-6 on one card
    python chip_smoke.py --four    # only the four-card path (see four())

The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises: the exit code is non-zero and no such line is
printed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, 'chiprun_out', 'smoke')
FACE = 1536          # production cube-face size (YulioRT.h ParamsRT.size)
DEPTH = 10           # production depth (YulioRT.h ParamsRT.depth)
PSNR_MIN = 40.0      # BASELINE.md hardware-parity acceptance
FOUR_REL_TOL = 1e-3  # --four: max |sharded - single| / peak


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def phase(name):
    log('\n== %s' % name)


# --------------------------------------------------------------- phases
def device_phase():
    phase('device')
    import jax
    devs = jax.devices()
    d = devs[0]
    check(d.platform == 'gpu',
          'no GPU: JAX found %s devices' % d.platform)
    log('device: %s %s, %d device(s)' % (d.platform, d.device_kind,
                                         len(devs)))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, 'nvidia-smi failed: %s' % smi.stderr)
    log('card: %s' % smi.stdout.strip().splitlines()[0])
    log('pillow importable: %s' % (importlib.util.find_spec('PIL')
                                   is not None))
    return d, len(devs)


def build_phase():
    phase('build')
    t0 = time.perf_counter()
    r = subprocess.run(['make', '-C', os.path.join(ROOT, 'native'),
                        'libyrt_native.so'], capture_output=True, text=True,
                       timeout=600)
    check(r.returncode == 0, 'native build failed: %s' % r.stderr[-2000:])
    from yulio_raytracer.geometry import bvh
    check(bvh._load_native() is not None, 'native BVH builder did not load')
    log('native BVH builder built and loaded in %.1f s'
        % (time.perf_counter() - t0))


def parity_phase():
    phase('parity')
    import numpy as np
    import make_goldens as mg
    for name in mg.PARITY:
        t0 = time.perf_counter()
        img = mg.render_config(name)
        ref = np.load(mg.golden_path(name))['img']
        check(img.shape == ref.shape, '%s: shape %s vs golden %s'
              % (name, img.shape, ref.shape))
        check(np.isfinite(img).all(), '%s: non-finite pixels' % name)
        p = mg.psnr(img, ref)
        log('%-16s PSNR %.2f dB (gate %.0f)  %.1f s'
            % (name, p, PSNR_MIN, time.perf_counter() - t0))
        check(p >= PSNR_MIN, '%s: PSNR %.2f < %.0f' % (name, p, PSNR_MIN))


def kernel_phase():
    phase('kernel')
    import bench_traversal as bt
    from yulio_raytracer.io import builtin_scenes
    scene = builtin_scenes.sponza_like().commit()
    log('sponza_like: %d tris, %d nodes, leaf %d'
        % (scene.num_triangles, scene.bvh['lo'].shape[0], scene.leaf_size))
    pops = bt.populations(scene, builtin_scenes.sponza_like_camera(
        FACE, FACE), FACE)
    log('tolerance: tri ids agree on >= %.4f of hit rays, |dt| <= %g * '
        'max(1, t); occlusion agrees on >= %.4f of shadow rays'
        % (bt.MATCH_MIN, bt.T_TOL, bt.MATCH_MIN))
    for row in bt.compare(scene, pops):
        log('%-8s %d rays  xla %.3f ms  kernel %.3f ms%s  mismatches %d '
            '(match %.6f)%s'
            % (row['population'], row['rays'], row['xla_s'] * 1e3,
               row['kernel_s'] * 1e3,
               ('  kernel sorted %.3f ms' % (row['kernel_sorted_s'] * 1e3)
                if 'kernel_sorted_s' in row else ''),
               row['mismatches'], row['match'],
               ('  max rel dt %.3g' % row['max_rel_dt']
                if 'max_rel_dt' in row else '')))
        check(row['ok'], 'kernel disagrees with XLA on %s: %r'
              % (row['population'], row))


class _Spy:
    """Records what output.py hands to render_frame and image.store."""

    def __init__(self):
        import numpy as np
        import jax
        from yulio_raytracer import renderer
        from yulio_raytracer.io import image
        self.faces, self.images = [], []
        self._rf, self._store = renderer.render_frame, image.store
        rf, store = self._rf, self._store

        def render_frame(scene, camera, params, width, height, spp,
                         **kw):
            t0 = time.perf_counter()
            film, stats = rf(scene, camera, params, width, height, spp,
                             **kw)
            jax.block_until_ready(film.rgb_sum)
            self.faces.append(dict(seconds=time.perf_counter() - t0,
                                   scene=scene, params=params,
                                   width=width))
            return film, stats

        def img_store(path, img, **kw):
            t0 = time.perf_counter()
            store(path, img, **kw)
            self.images.append((path, np.asarray(img),
                                time.perf_counter() - t0))

        renderer.render_frame, image.store = render_frame, img_store

    def close(self):
        from yulio_raytracer import renderer
        from yulio_raytracer.io import image
        renderer.render_frame, image.store = self._rf, self._store


def _check_image(name, img):
    import numpy as np
    a = np.asarray(img, np.float32)
    check(np.isfinite(a).all(), '%s: non-finite pixels' % name)
    check(a[..., :3].max() > 0, '%s: image is black' % name)
    return float(a[..., :3].mean())


def cli_phase():
    phase('cli')
    from yulio_raytracer.api import cli
    os.makedirs(OUT, exist_ok=True)
    out = os.path.join(OUT, 'cornell_512.png')
    spy = _Spy()
    cwd = os.getcwd()
    try:
        os.chdir(ROOT)
        t0 = time.perf_counter()
        rc = cli.main(['-c', 'assets/scenes/cornell_box.ecs', '-spp', '16',
                       '-size', '512', '512', '-o', out])
    finally:
        os.chdir(cwd)
        spy.close()
    check(rc == 0, 'cli returned %r' % rc)
    check(os.path.exists(out), 'cli wrote no %s' % out)
    (path, img, _), = spy.images
    check(img.shape[:2] == (512, 512), 'cli image shape %s' % (img.shape,))
    log('cli: %s, mean %.4f, %.1f s' % (os.path.relpath(path, ROOT),
                                        _check_image('cli', img),
                                        time.perf_counter() - t0))


def _memory(scene, params, npix):
    import jax
    from yulio_raytracer import renderer
    from yulio_raytracer.integrator import pathtracer
    width = min(renderer._pass_budget(scene, params, 1, npix)[0], npix)
    mem = pathtracer.bounce_memory(scene, params, width)
    peak = (jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use', 0)
    log('bounce step at %d rays: arguments %.1f MiB, outputs %.1f MiB, '
        'temporaries %.1f MiB, aliased %.1f MiB; device peak %.2f GiB'
        % (width, mem.argument_size_in_bytes / 2**20,
           mem.output_size_in_bytes / 2**20, mem.temp_size_in_bytes / 2**20,
           mem.alias_size_in_bytes / 2**20, peak / 2**30))


def _face_times(seconds):
    import numpy as np
    rest = seconds[1:] or seconds
    med = float(np.median(rest))
    return med, seconds[0] - med


def session_phase():
    phase('session')
    from yulio_raytracer.api import session
    from yulio_raytracer.film import stereo_strip
    os.makedirs(OUT, exist_ok=True)
    dae = os.path.join(OUT, 'test_room.dae')
    shutil.copy(os.path.join(ROOT, 'assets', 'scenes', 'test_room.dae'), dae)
    for f in os.listdir(OUT):
        if f.startswith('test_room_') and f.endswith('.jpg'):
            os.remove(os.path.join(OUT, f))
    p = session.ParamsRT(size=FACE, depth=DEPTH, t_max_shadow_ray=120.0,
                         spp=1, watermark=True)
    spy = _Spy()
    try:
        t0 = time.perf_counter()
        check(session.StartRT(dae, p), 'StartRT refused')
        session.WaitRT()
        total = time.perf_counter() - t0
    finally:
        spy.close()
    st = session.GetCurrentStatusRT()
    check(st.state == session.StateRT.Done and
          st.last_error == session.ErrorCodeRT.NoError,
          'session ended %r' % (st,))
    check(len(spy.faces) == 12, '%d faces rendered' % len(spy.faces))
    written = session._session.written_files
    check(len(written) == 1 and os.path.exists(written[0]),
          'strip not written: %r' % written)
    (path, strip, store_s), = spy.images
    check(strip.shape[:2] == (FACE, 12 * FACE),
          'strip shape %s' % (strip.shape,))
    mean = _check_image('strip', strip)
    # the watermark lands on face 0's corner: that block is not the
    # render underneath (apply_watermark blends it in)
    wm = stereo_strip.load_watermark()
    check(wm.shape == (100, 100, 4) and wm[..., 3].max() > 0,
          'watermark did not load')
    secs = [f['seconds'] for f in spy.faces]
    med, comp = _face_times(secs)
    scene = spy.faces[0]['scene']
    log('test_room.dae: %d tris, 12 faces %dx%d depth %d in %.1f s; face '
        '%.3f s (median), compile %.1f s; strip %s mean %.4f'
        % (scene.num_triangles, FACE, FACE, DEPTH, total, med, comp,
           os.path.relpath(written[0], ROOT), mean))
    log('face seconds: %s' % ', '.join('%.3f' % s for s in secs))
    log('strip JPEG encode + write: %.2f s' % store_s)
    _memory(scene, spy.faces[0]['params'], FACE * FACE)


def sponza_face(scene=None, mesh=None, reps=1):
    """One FACE^2 depth-DEPTH StereoCube face of sponza_like, rendered the
    way output.render_stereo calls render_frame.  Returns (film, seconds
    of each call; the first includes compilation)."""
    import jax
    from yulio_raytracer import renderer
    from yulio_raytracer.cameras import cameras as gcam
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.io import builtin_scenes
    if scene is None:
        scene = builtin_scenes.sponza_like().commit()
    pose = builtin_scenes.sponza_like_camera(FACE, FACE).local2world
    cam = gcam.make_stereo_rig(pose, origin=pose[3], scene_scale=0.05)[1]
    params = pt.PTParams(max_depth=DEPTH)
    secs, film = [], None
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        film, _ = renderer.render_frame(scene, cam, params, FACE, FACE, 1,
                                        seed=0, progress_cb=lambda f: None,
                                        mesh=mesh)
        jax.block_until_ready(film.rgb_sum)
        secs.append(time.perf_counter() - t0)
    return scene, params, film, secs


def sponza_phase():
    phase('sponza face')
    import numpy as np
    from yulio_raytracer.film import accum
    scene, params, film, secs = sponza_face(reps=2)
    img = np.asarray(accum.resolve(film))
    med, comp = _face_times(secs)
    log('sponza_like: %d tris, face %dx%d depth %d: %.3f s (median of %d), '
        'compile %.1f s, mean %.4f'
        % (scene.num_triangles, FACE, FACE, DEPTH, med, len(secs) - 1, comp,
           _check_image('sponza face', img)))
    log('face seconds: %s' % ', '.join('%.3f' % s for s in secs))
    _memory(scene, params, FACE * FACE)


def four():
    """The four-card paths: the sponza face with settings.devices=4 (the
    'px' mesh) against the same face on device 0, and
    render_frame_sharded with tri_parallel=2 against a single-device
    render of the same frame."""
    import numpy as np
    import jax
    from yulio_raytracer.api import output
    from yulio_raytracer.film import accum
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.io import ecs as gecs
    from yulio_raytracer.parallel import sharding
    from yulio_raytracer import renderer

    check(len(jax.devices()) >= 4, 'need 4 devices, found %d'
          % len(jax.devices()))

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))

    phase('four: px mesh')
    mesh = output.settings_mesh(gecs.RenderSettings(devices=4))
    check(mesh is not None and mesh.devices.size == 4, 'no 4-device mesh')
    scene, _, one, s1 = sponza_face(reps=1)
    _, _, four_, s4 = sponza_face(scene, mesh=mesh, reps=1)
    r = rel(accum.resolve(four_), accum.resolve(one))
    log('sponza face %d^2 depth %d: device 0 %.3f s (compile %.1f s), '
        '4 devices %.3f s (compile %.1f s), speedup %.2fx, max rel diff '
        '%.3g (gate %g)' % (FACE, DEPTH, s1[-1], s1[0] - s1[-1], s4[-1],
                            s4[0] - s4[-1], s1[-1] / s4[-1], r,
                            FOUR_REL_TOL))
    check(r <= FOUR_REL_TOL, 'px mesh face differs: %g' % r)

    phase('four: tri_parallel=2')
    # a sharded triangle axis tests each shard's triangles directly (no
    # BVH): the device-0 reference takes the same dense test
    cs = builtin_scenes.cornell_box().commit(force_bvh=False)
    cam = builtin_scenes.cornell_camera(512, 512)
    params = pt.PTParams(max_depth=4)
    tmesh = sharding.make_mesh(4, tri_parallel=2)
    times = {}
    for _ in range(2):
        t0 = time.perf_counter()
        ref, _ = renderer.render_frame(cs, cam, params, 512, 512, 4, seed=0)
        jax.block_until_ready(ref.rgb_sum)
        times['one'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = sharding.render_frame_sharded(cs, cam, params, 512, 512, 4,
                                            tmesh, seed=0)
        jax.block_until_ready(got.rgb_sum)
        times['tri'] = time.perf_counter() - t0
    r = rel(accum.resolve(got), accum.resolve(ref))
    log('cornell 512^2 depth 4 spp 4: device 0 %.3f s, px=2 x tri=2 mesh '
        '%.3f s, max rel diff %.3g (gate %g)'
        % (times['one'], times['tri'], r, FOUR_REL_TOL))
    check(r <= FOUR_REL_TOL, 'tri-parallel frame differs: %g' % r)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four-card path and its comparison')
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, 'scripts'))
    from yulio_raytracer.utils import compile_cache
    compile_cache.enable()
    t0 = time.perf_counter()
    dev, count = device_phase()
    if a.four:
        four()
    else:
        build_phase()
        parity_phase()
        kernel_phase()
        cli_phase()
        session_phase()
        sponza_phase()
    log('\nall phases passed in %.1f s' % (time.perf_counter() - t0))
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
