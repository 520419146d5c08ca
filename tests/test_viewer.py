"""Interactive viewer: camera controller math (glutdisplay.cpp
clickFunc/motionFunc/keyboardFunc semantics) + the web server glue."""
import json
import urllib.request

import numpy as np

from yulio_raytracer.api import viewer as gv


def _ctl():
    return gv.CameraController(pos=np.array([0.0, 0.0, -10.0]),
                               lookat=np.zeros(3),
                               up=np.array([0.0, 1.0, 0.0]))


def test_rotate_preserves_distance_and_lookat():
    c = _ctl()
    c.rotate(40.0, 25.0)
    assert np.allclose(c.lookat, 0.0)
    assert np.isclose(np.linalg.norm(c.pos - c.lookat), 10.0, atol=1e-9)
    # 40 px * 0.05 deg/px yaw moves the eye measurably
    assert np.linalg.norm(c.pos - [0, 0, -10]) > 1e-3


def test_pan_moves_eye_and_lookat_together():
    c = _ctl()
    before = c.lookat - c.pos
    c.pan(100.0, -50.0)
    assert np.allclose(c.lookat - c.pos, before)
    assert not np.allclose(c.lookat, 0.0)


def test_dolly_moves_along_view():
    c = _ctl()
    c.dolly(100.0, 0.0)                     # dx>0 -> toward look-at
    d = np.linalg.norm(c.lookat - c.pos)
    assert d < 10.0
    view = (c.lookat - c.pos) / d
    assert np.allclose(view, [0, 0, 1], atol=1e-12)


def test_keys_update_state():
    c = _ctl()
    assert c.key(' ') == 'pause'
    assert c.key('r') == 'refine'
    assert c.key('t') == 'regression'
    assert c.key('q') == 'quit'
    assert c.key('c') == 'camera-line'
    c.key('L')
    assert c.radius == 1.0
    c.key('l')
    assert c.radius == 0.0
    c.key('Home')
    assert np.isclose(c.speed, 1.2)
    p0 = c.pos.copy()
    c.key('ArrowUp')                        # forward by speed
    assert np.isclose(np.linalg.norm(c.pos - p0), c.speed)
    la0 = c.lookat.copy()
    c.key('ArrowLeft')                      # yaw: eye fixed, lookat spins
    assert np.allclose(c.pos, p0 + (c.lookat - la0) * 0 + (c.pos - p0))
    assert not np.allclose(c.lookat, la0)


def test_camera_line_format():
    c = _ctl()
    line = c.camera_line()
    assert line.startswith('-vp ') and '-vi ' in line and '-vu ' in line


def test_recenter_shifts_parallel_to_view_plane():
    c = _ctl()
    c.recenter(np.array([3.0, 2.0, 0.0]))
    assert np.allclose(c.lookat, [3, 2, 0])
    # eye slides in the view plane: z unchanged
    assert np.isclose(c.pos[2], -10.0)


def test_dof_camera_when_radius_set():
    c = _ctl()
    assert type(c.camera()).__name__ == 'Pinhole'
    c.key('L')
    assert type(c.camera()).__name__ == 'DepthOfField'


def test_server_roundtrip():
    srv = gv.ViewerServer(port=0)
    try:
        base = 'http://127.0.0.1:%d' % srv.port
        page = urllib.request.urlopen(base + '/', timeout=5).read()
        assert b'canvas' in page or b'img' in page
        # event POST -> drain
        req = urllib.request.Request(
            base + '/event',
            data=json.dumps({'type': 'rotate', 'dx': 3, 'dy': 4}).encode(),
            method='POST')
        urllib.request.urlopen(req, timeout=5).read()
        evs = srv.drain_events()
        assert evs == [{'type': 'rotate', 'dx': 3, 'dy': 4}]
        # frame publish -> long-poll pickup
        srv.submit_frame(np.zeros((4, 4, 3), np.uint8), hud='1.0 fps')
        j = json.loads(urllib.request.urlopen(
            base + '/frame?since=-1', timeout=5).read())
        assert j['i'] == 1 and j['hud'] == '1.0 fps' and len(j['jpg']) > 0
        # malformed event is rejected without killing the server
        req = urllib.request.Request(base + '/event', data=b'{oops',
                                     method='POST')
        try:
            urllib.request.urlopen(req, timeout=5)
        except urllib.error.HTTPError as e:
            assert e.code == 400
        assert srv.drain_events() == []
    finally:
        srv.close()


def test_interactive_loop_renders_and_quits():
    """Drive one frame through the real render path (tiny cornell) and
    stop via the 'q' key event."""
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt

    scene = builtin_scenes.cornell_box().commit()
    cam = builtin_scenes.cornell_camera(16, 16)
    l2w = np.asarray(cam.local2world)
    ctl = gv.CameraController(pos=l2w[3], lookat=l2w[3] + l2w[2], up=l2w[1],
                              angle=37.0, aspect=1.0)
    srv = gv.ViewerServer(port=0)
    frames = []
    orig_submit = srv.submit_frame

    def capture(img, hud=''):
        frames.append(img)
        orig_submit(img, hud)
        if len(frames) == 1:     # after first frame: rotate, then quit
            with srv._lock:
                srv._events.extend([
                    {'type': 'rotate', 'dx': 10, 'dy': 0},
                    {'type': 'key', 'k': 'q'},
                ])
    srv.submit_frame = capture
    film = gv.interactive_loop(scene, ctl, pt.PTParams(max_depth=2),
                               16, 16, spp_per_frame=1, server=srv,
                               max_frames=5)
    srv.close()
    assert 1 <= len(frames) <= 3
    assert frames[0].shape == (16, 16, 3)
    assert frames[0].max() > 0          # something rendered
