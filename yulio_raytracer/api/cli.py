"""Command-line renderer: `python -m yulio_raytracer.api.cli ...`.

Argv is the same token language as `.ecs` files (renderer.cpp:1406-1474):

  cli -c scene.ecs -o out.png                # golden-scene render
  cli -i scene.obj -vp .. -vi .. -spp 64 -o out.jpg
  cli scene.dae                              # Yulio FPR stereo pipeline
                                             # (renderer.cpp:1410-1436)
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np


_USAGE = """\
yulio-raytracer renderer (JAX path tracer)

usage: python -m yulio_raytracer.api.cli [flags | file.ecs | file.dae]

common flags (full set in io/ecs.py; argv and .ecs files share one
token language, recursively includable via -c):
  -c FILE.ecs            include a command file
  -i SCENE               load scene (.obj/.xml/.dae)
  -o OUT.png|jpg         render to file (mono)
  -stereo                12-face stereo cube-map pipeline
  -size W H  -spp N  -depth N  -gamma G
  -vp/-vi/-vu/-fov       camera
  -ambientlight R G B    dome light (plus point/spot/directional/
                         distant/triangle/quad/hdri light flags)
  -renderer pathtracer { spp = N depth = N ... }
  -devices N             fan out over N local devices (0 = all)
  -connect HOST[:PORT].. distributed TCP render servers
  -display [-viewer P]   progressive view (web viewer on port P)
  -regression            random-scene stress loop
"""


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or '-h' in argv or '-help' in argv or '--help' in argv:
        print(_USAGE)
        return 0
    if '-version' in argv or '--version' in argv:
        from .. import __version__
        print(f"yulio-raytracer {__version__}")
        return 0

    from ..utils import compile_cache, hostmem
    compile_cache.enable()
    # overlap slow host page faults with scene IO + first compile
    hostmem.prefault_async()

    from ..io import ecs as gecs
    from ..scene import SceneBuilder

    settings = gecs.RenderSettings()
    sb = SceneBuilder()

    # bare `file.dae` argument -> FPR pipeline with a renderer_settings
    # sidecar (renderer.cpp:1410-1436)
    if len(argv) == 1 and argv[0].lower().endswith('.dae'):
        return _fpr_pipeline(argv[0])

    regression_mode = '-regression' in argv
    ts = gecs.TokenStream.from_argv(argv)
    gecs.parse(ts, settings, sb, '.')

    if regression_mode:
        return _regression_loop(settings)

    if settings.stereo:
        # settings.scene_file = last -i path, argv or included .ecs alike
        return _stereo_from_settings(settings, sb, settings.scene_file)

    from . import output as goutput
    if settings.connect:
        return _connect_mode(settings, sb)
    if settings.display:
        return _display_mode(settings, sb)
    scene = sb.commit(accel=settings.accel)
    out = settings.out_file or 'out.png'
    t0 = time.time()
    img, stats = goutput.render_mono(scene, settings, out)
    if stats:
        # fps/ms/mrps line (integratorrenderer.cpp:101-111)
        dt = stats.seconds
        print(f"render  {1.0 / max(dt, 1e-9):.2f} fps, "
              f"{dt * 1000.0:.2f} ms, {stats.mrps:.3f} mrps")
    print(f"wrote {out} ({settings.width}x{settings.height}, "
          f"{settings.spp} spp) in {time.time() - t0:.1f}s")
    return 0


def _connect_mode(settings, sb):
    """-connect host[:port] ...: render through the distributed TCP
    device (the reference's network device front-end selection,
    renderer.cpp:948-956).  Every server renders its interleaved 4-row
    bands; the merged frame is tonemapped + written locally."""
    from ..film import tonemap
    from ..io import image as gimage
    from . import output as goutput

    if settings.num_frames > 1:
        raise ValueError(
            "-frames N accumulation is local-only; distributed renders "
            "render one frame per request")

    camera = goutput.mono_camera(settings)
    params = goutput.params_from_settings(settings)
    client = _make_client(settings)
    t0 = time.time()
    try:
        client.set_scene(sb)
        rgb_sum, weight = client.render(
            camera, params, settings.width, settings.height,
            settings.spp, seed=0, pixel_filter=settings.pixel_filter,
            backplate=settings.backplate)
    finally:
        client.close()
    img = tonemap.tonemap(rgb_sum / np.maximum(weight, 1e-20)[..., None],
                          gamma=settings.gamma,
                          vignetting=settings.vignetting)
    out = settings.out_file or 'out.png'
    gimage.store(out, np.asarray(img), jpeg_quality=settings.jpeg_quality)
    dt = time.time() - t0
    mrps = settings.width * settings.height * settings.spp / dt / 1e6
    print(f"render  {1.0 / max(dt, 1e-9):.2f} fps, {dt * 1000.0:.2f} ms, "
          f"{mrps:.3f} mrps ({len(settings.connect)} servers, "
          f"camera rays)")
    print(f"wrote {out} ({settings.width}x{settings.height}, "
          f"{settings.spp} spp)")
    return 0


def _display_mode(settings, sb):
    """-display: progressive refinement loop (glutdisplay.cpp analog),
    writing display.png each frame."""
    from . import output as goutput
    from . import display as gdisplay
    scene = sb.commit(accel=settings.accel)
    camera = goutput.mono_camera(settings)
    params = goutput.params_from_settings(settings)
    if settings.viewer_port:
        # -viewer: interactive web window (GLUTDisplay analog) with
        # mouse camera drag + the reference key bindings
        from . import viewer as gviewer
        import numpy as np
        l2w = np.asarray(camera.local2world)
        pos = l2w[3].astype(np.float64)
        fwd = l2w[2].astype(np.float64)
        up = l2w[1].astype(np.float64)
        ctl = gviewer.CameraController(
            pos=pos, lookat=pos + fwd * 10.0, up=up,
            angle=getattr(camera, 'angle', 64.0),
            aspect=settings.width / settings.height)
        from ..utils import regression as greg
        gviewer.interactive_loop(
            scene, ctl, params, settings.width, settings.height,
            spp_per_frame=settings.spp, port=settings.viewer_port,
            max_frames=settings.num_frames if settings.num_frames > 1
            else 0, gamma=settings.gamma,
            scene_factory=lambda i: greg.create_random_scene(i).commit())
        return 0
    gdisplay.display_loop(scene, camera, params, settings.width,
                          settings.height, spp_per_frame=settings.spp,
                          max_frames=settings.num_frames,
                          gamma=settings.gamma,
                          refine=bool(settings.accumulate),
                          out_path=settings.out_file or 'display.png')
    return 0


def _regression_loop(settings):
    """-regression: endless random-scene stress mode (regression.cpp)."""
    from ..utils import regression
    from . import output as goutput
    import itertools
    for seed in itertools.count():
        sb = regression.create_random_scene(seed)
        scene = sb.commit()
        camera = goutput.mono_camera(gecs_default_view(settings))
        params = goutput.params_from_settings(settings)
        from .. import renderer as grenderer
        film, stats = grenderer.render_frame(
            scene, camera, params, settings.width, settings.height,
            max(settings.spp, 1), seed=seed)
        import numpy as np
        from ..film import accum
        img = np.asarray(accum.resolve(film))
        ok = np.isfinite(img).all()
        print(f"regression scene {seed}: "
              f"{'ok' if ok else 'NON-FINITE OUTPUT'} "
              f"({stats.mrps:.2f} mrps)", flush=True)
        if not ok:
            return 1
    return 0


def gecs_default_view(settings):
    """Regression scenes use a fixed orbit camera."""
    from copy import copy
    s = copy(settings)
    s.cam_pos = (0.0, 3.0, -12.0)
    s.cam_look_at = (0.0, 0.0, 0.0)
    s.fov = 60.0
    return s


def _stereo_from_settings(settings, sb, scene_file):
    from ..cameras import cameras as gcam
    from . import output as goutput
    # stereo without collada cameras: one rig at the CLI camera
    l2w = gcam.look_at(settings.cam_pos, settings.cam_look_at,
                       settings.cam_up)
    rigs = [("view", gcam.make_stereo_rig(
        l2w, up=tuple(settings.cam_up),
        eye_separation=settings.eye_separation,
        zero_parallax=settings.zero_parallax,
        toe_in=settings.toe_in))]
    scene_file = scene_file or settings.scene_file
    base = (os.path.splitext(os.path.basename(scene_file))[0]
            if scene_file else 'stereo')
    client = None
    if settings.connect:
        # the network Device serves every output mode, stereo included
        # (renderer.cpp:948-956 device selection precedes outputMode)
        client = _make_client(settings)
    try:
        if client is not None:
            client.set_scene(sb)
        written, _ = goutput.render_stereo(sb, settings, rigs, base, '.',
                                           client=client,
                                           debug_faces=settings.debug)
    finally:
        if client is not None:
            client.close()
    for w in written:
        print(f"wrote {w}")
    return 0


def _make_client(settings):
    from ..parallel import network as gnet

    def addr(tok):
        host, _, port = tok.partition(':')
        return (host, int(port) if port else 8282)

    if settings.sampler != 'stateless':
        raise ValueError(
            "-sampler %s is not carried by the render protocol; "
            "distributed renders use the stateless sampler"
            % settings.sampler)
    return gnet.NetworkClient([addr(t) for t in settings.connect])


def _fpr_pipeline(dae_path: str):
    """Bare-DAE mode: read `renderer_settings` next to the file when
    present (renderer.cpp:1410-1436), then run the full stereo pipeline
    via the session API."""
    from .session import RenderSession, ParamsRT
    params = ParamsRT()
    sidecar = os.path.join(os.path.dirname(os.path.abspath(dae_path)),
                           'renderer_settings')
    if os.path.exists(sidecar):
        for line in open(sidecar):
            tok = line.split('#')[0].split()
            if len(tok) >= 2:
                key, val = tok[0], tok[1]
                if key in ('size', 'depth', 'spp', 'jpegQuality'):
                    setattr(params, {'jpegQuality': 'jpeg_quality'}.get(
                        key, key), int(val))
                elif key in ('tMaxShadowRay',):
                    params.t_max_shadow_ray = float(val)
                elif key in ('waterMark',):
                    params.watermark = val in ('1', 'true')
                elif key in ('devices',):
                    params.devices = int(val)
    session = RenderSession()
    if not session.start(dae_path, params):
        print(f"error: {session.last_error().name}", file=sys.stderr)
        return 1
    last = -1.0
    import time as _t
    while True:
        st = session.status()
        if st.progress != last:
            print(f"\r[{st.state.name}] {st.progress * 100:5.1f}%",
                  end='', flush=True)
            last = st.progress
        if st.state.name in ('Done', 'Stopped'):
            break
        _t.sleep(0.5)
    session.wait()
    print()
    for w in session.written_files:
        print(f"wrote {w}")
    return 0 if session.status().state.name == 'Done' else 1


if __name__ == '__main__':
    sys.exit(main())
