import os
import time

import numpy as np
import pytest

from yulio_raytracer.film import stereo_strip
from yulio_raytracer.io import collada, ecs
from yulio_raytracer.scene import SceneBuilder
from yulio_raytracer.api import session as rt

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'scenes')
DAE = os.path.join(ASSETS, 'test_room.dae')


def test_strip_order_and_eye_swap():
    faces = []
    for i in range(12):
        f = np.full((4, 4, 3), i, np.float32)
        faces.append(f)
    strip = stereo_strip.assemble_strip(faces)
    assert strip.shape == (4, 48, 3)
    # segment order left,right,up,down,back,front; first 6 segments use
    # the RIGHT eye (faces 6..11) because of the reference's quirk
    seg_vals = [strip[0, 4 * s, 0] for s in range(12)]
    assert seg_vals == [9, 7, 10, 11, 8, 6, 3, 1, 4, 5, 2, 0]


def test_watermark_side_faces_only():
    img = np.zeros((32, 32, 3), np.float32)
    wm = np.ones((8, 8, 4), np.float32) * 0.5
    out_front = stereo_strip.apply_watermark(img, wm, 0)
    out_top = stereo_strip.apply_watermark(img, wm, 4)
    assert out_front[16, 16, 0] > 0.0     # blended at center
    np.testing.assert_array_equal(out_top, img)  # top face untouched
    # alpha blend math: (1-a)*dst + a*src = 0.5*0 + 0.5*0.5
    np.testing.assert_allclose(out_front[16, 16, 0], 0.25, atol=1e-6)


def test_face_and_strip_filenames():
    assert stereo_strip.face_filename('scene', 'cam', 0) == \
        'scene_cam_front_image_left.jpg'
    assert stereo_strip.face_filename('scene', 'cam', 11) == \
        'scene_cam_bottom_image_right.jpg'
    assert stereo_strip.strip_filename('scene', 'cam') == 'scene_cam.jpg'


def test_collada_load():
    settings = ecs.RenderSettings()
    sb = SceneBuilder()
    result = collada.load_dae(DAE, settings, sb)
    # only the FPR-tagged camera survives, prefix stripped
    assert len(result.cameras) == 1
    assert result.cameras[0].name == 'Scene_1'
    # scene scale from the camera matrix decomposition (scale 2)
    np.testing.assert_allclose(result.scene_scale, 2.0, atol=1e-5)
    # Z_UP conversion: floor z=0 plane becomes y=0
    scene = sb.commit(view_pos=np.zeros(3))
    packed_y = np.asarray(scene.geom['v0'])[np.asarray(scene.geom['valid'])]
    assert abs(packed_y[:2, 1]).max() < 1e-5
    # materials: Uber (wall) + ThinDielectric (glassy panel)
    from yulio_raytracer.shading import lobes as lb
    types = np.asarray(scene.materials['lobe_type'])
    assert (types == lb.THIN_DIELECTRIC_TRANSMIT).any()
    assert (types == lb.MICROFACET_DIELECTRIC).any()   # Uber gloss lobe
    # billboard mesh flagged
    assert sb.has_billboards()


def test_billboard_faces_camera():
    settings = ecs.RenderSettings()
    sb = SceneBuilder()
    collada.load_dae(DAE, settings, sb)
    bb = [m for m in sb.meshes if m.face_camera][0]
    from yulio_raytracer.geometry import mesh as gmesh
    cam_pos = np.asarray([10.0, 0.0, 2.0])
    xfm = gmesh.billboard_transform(bb.orig_transform, cam_pos, (0, 1, 0))
    moved = bb.transformed(xfm)
    # the billboard plane normal should now point (horizontally) at the cam
    p0, p1, p2 = moved.positions[:3]
    n = np.cross(p1 - p0, p2 - p0)
    n /= np.linalg.norm(n)
    to_cam = cam_pos - xfm[3]
    to_cam[1] = 0
    to_cam /= np.linalg.norm(to_cam)
    assert abs(abs(float(n @ to_cam)) - 1.0) < 1e-4


def test_session_lifecycle(tmp_path):
    import shutil
    dae = str(tmp_path / "room.dae")
    shutil.copy(DAE, dae)
    s = rt.RenderSession()
    # missing file -> error
    assert not s.start(str(tmp_path / "nope.dae"))
    assert s.last_error() == rt.ErrorCodeRT.MissingColladaFile
    # tiny render completes
    p = rt.ParamsRT(size=16, depth=2, spp=2, watermark=True)
    assert s.start(dae, p)
    assert s.wait()
    st = s.status()
    assert st.state == rt.StateRT.Done
    assert st.progress == 1.0
    assert len(s.written_files) == 1
    assert os.path.exists(s.written_files[0])
    from PIL import Image
    with Image.open(s.written_files[0]) as im:
        assert im.size == (16 * 12, 16)
    # output name <scene>_<camera>.jpg
    assert os.path.basename(s.written_files[0]) == 'room_Scene_1.jpg'


def test_session_stop_discards(tmp_path):
    import shutil
    dae = str(tmp_path / "room.dae")
    shutil.copy(DAE, dae)
    s = rt.RenderSession()
    p = rt.ParamsRT(size=32, depth=3, spp=16)
    assert s.start(dae, p)
    time.sleep(0.2)
    assert s.stop(keep_results=False)
    st = s.status()
    assert st.state in (rt.StateRT.Stopped, rt.StateRT.Done)
    if st.state == rt.StateRT.Stopped:
        # partial outputs removed
        assert not [f for f in os.listdir(tmp_path) if f.endswith('.jpg')]


def test_face_retry_is_idempotent(tmp_path, monkeypatch):
    """A cube face that fails transiently retries once and produces the
    same strip as an untroubled run (SURVEY §5: per-face idempotent
    retry unit; the reference restarts at face granularity)."""
    from yulio_raytracer.api import output as goutput
    from yulio_raytracer import renderer as grenderer

    settings = ecs.RenderSettings(stereo=True, width=8, height=8,
                                  depth=2, spp=2, gamma=1.0)
    sb = SceneBuilder()
    result = collada.load_dae(DAE, settings, sb)
    rigs = collada.make_stereo_cameras(result)

    written, _ = goutput.render_stereo(sb, settings, rigs, 'clean',
                                       str(tmp_path))
    real = grenderer.render_frame
    calls = {'n': 0}

    def flaky(*a, **k):
        calls['n'] += 1
        if calls['n'] == 3:          # fail face 2's first attempt
            raise RuntimeError("injected transient fault")
        return real(*a, **k)

    monkeypatch.setattr(goutput.grenderer, 'render_frame', flaky)
    written2, _ = goutput.render_stereo(sb, settings, rigs, 'retried',
                                        str(tmp_path))
    assert len(written) == len(written2) == 1
    assert calls['n'] == 13          # 12 faces + 1 retry
    from PIL import Image
    a = np.asarray(Image.open(written[0]))
    b = np.asarray(Image.open(written2[0]))
    np.testing.assert_array_equal(a, b)


def test_watermark_png_resource_pipeline():
    """The watermark ships as a packaged PNG decoded through the image
    layer (renderer.cpp:48-97's FreeImage-from-memory resource path)."""
    import numpy as np
    from yulio_raytracer.film import stereo_strip
    wm = stereo_strip.load_watermark()
    assert wm.shape == (100, 100, 4)
    assert wm.dtype == np.float32
    assert float(wm[..., 3].max()) > 0.2      # has visible alpha
    assert float(wm[..., 3].min()) == 0.0     # and transparency


def test_debug_faces_written_with_reference_naming(tmp_path):
    """-debug writes every cube-face JPEG alongside the strip
    (renderer.cpp:657-660), using the reference per-face naming
    `<scene>_<camera>_<face>_image_<eye>.jpg` (renderer.cpp:587-620)."""
    from yulio_raytracer.api import output as goutput

    settings = ecs.RenderSettings(stereo=True, width=8, height=8,
                                  depth=2, spp=2, gamma=1.0)
    sb = SceneBuilder()
    result = collada.load_dae(DAE, settings, sb)
    rigs = collada.make_stereo_cameras(result)
    written, _ = goutput.render_stereo(sb, settings, rigs, 'dbg',
                                       str(tmp_path), debug_faces=True)
    assert len(written) == 1
    cam_name = rigs[0][0]
    for fi in range(12):
        fn = stereo_strip.face_filename('dbg', cam_name, fi)
        assert os.path.exists(os.path.join(str(tmp_path), fn)), fn


def test_debug_and_no_logging_flags_parse():
    """`-debug` sets the per-face toggle; `--no-logging` clears the
    console log toggle (renderer.cpp:989-991) rather than no-op'ing."""
    from yulio_raytracer.utils import logging as glog

    settings = ecs.RenderSettings()
    sb = SceneBuilder()
    ecs.parse(ecs.TokenStream.from_argv(['-debug']), settings, sb)
    assert settings.debug

    assert glog.log_display
    try:
        ecs.parse(ecs.TokenStream.from_argv(['--no-logging']),
                  settings, sb)
        assert not glog.log_display
    finally:
        glog.log_display = True
