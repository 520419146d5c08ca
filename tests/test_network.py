"""Distributed TCP rendering: N local servers, one client (the reference's
multi-node testability pattern — run rt_server locally N times and
-connect localhost:p1 localhost:p2, SURVEY.md section 4)."""
import threading

import numpy as np
import pytest

from yulio_raytracer.parallel import network
from yulio_raytracer.io import builtin_scenes
from yulio_raytracer.integrator import pathtracer as pt
from yulio_raytracer import renderer
from yulio_raytracer.film import accum


def test_active_rows_partition():
    h = 64
    n = 3
    all_rows = np.concatenate([network.active_rows(h, i, n)
                               for i in range(n)])
    assert sorted(all_rows.tolist()) == list(range(h))
    # 4-row bands: rows 0-3 on server 0, 4-7 on server 1, ...
    assert set(network.active_rows(h, 0, n)[:4]) == {0, 1, 2, 3}
    assert set(network.active_rows(h, 1, n)[:4]) == {4, 5, 6, 7}


def test_two_server_render_matches_local():
    ports = [19471, 19472]
    servers = [network.RenderServer(p, single_connection=True)
               for p in ports]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()

    sb = builtin_scenes.cornell_box(with_boxes=False)
    camera = builtin_scenes.cornell_camera(32, 32)
    params = pt.PTParams(max_depth=2)

    client = network.NetworkClient([('127.0.0.1', p) for p in ports])
    client.set_scene(sb)
    img, weight = client.render(camera, params, 32, 32, spp=2, seed=3)
    client.close()
    for s in servers:
        s.stop()

    assert (weight == 2.0).all()
    # the merged distributed render is bit-identical to a local render
    scene = sb.commit()
    film, _ = renderer.render_frame(scene, camera, params, 32, 32, spp=2,
                                    seed=3)
    local = np.asarray(film.rgb_sum)
    np.testing.assert_allclose(img, local, atol=1e-5)


def test_rgbe8_roundtrip():
    rs = np.random.RandomState(0)
    rgb = (rs.rand(16, 16, 3) * 50).astype(np.float32)
    rgb[0, 0] = 0.0
    dec = network.rgbe8_decode(network.rgbe8_encode(rgb))
    # shared-exponent codec: absolute error bounded by max_channel/128
    bound = rgb.max(axis=-1, keepdims=True) / 128.0 + 1e-6
    assert (np.abs(dec - rgb) <= bound).all()
    np.testing.assert_array_equal(dec[0, 0], 0.0)


def test_jpeg_tier_roundtrip():
    # smooth gradients (render-like content; JPEG is built for it)
    y, x = np.mgrid[0:32, 0:64].astype(np.float32)
    rgb = np.stack([x / 64, y / 32, 0.5 + 0.4 * np.sin(x / 9)],
                   axis=-1).astype(np.float32) * 0.9
    data = network.jpeg_encode(rgb, quality=95)
    assert isinstance(data, bytes) and data[:2] == b'\xff\xd8'  # JFIF SOI
    dec = network.jpeg_decode(data)
    assert dec.shape == rgb.shape
    # lossy tier: perceptual-space error within a few LSBs at q=95
    err = np.abs(np.power(dec, 1 / 2.2) - np.power(rgb, 1 / 2.2))
    assert float(err.mean()) < 0.02
    # quality plumbing: lower quality -> smaller payload
    assert len(network.jpeg_encode(rgb, quality=20)) < len(data)


def test_jpeg_server_encoding():
    """End-to-end 'jpeg' encoding through a real server/client pair
    (the -encode jpeg flag of network_server.cpp:680-739)."""
    port = 19475
    server = network.RenderServer(port, single_connection=True)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    sb = builtin_scenes.cornell_box(with_boxes=False)
    camera = builtin_scenes.cornell_camera(32, 32)
    params = pt.PTParams(max_depth=2)

    client = network.NetworkClient([('127.0.0.1', port)])
    client.set_scene(sb)
    img, weight = client.render(camera, params, 32, 32, spp=2, seed=3,
                                encoding='jpeg', jpeg_quality=95)
    client.close()
    server.stop()

    assert (weight == 2.0).all()
    scene = sb.commit()
    film, _ = renderer.render_frame(scene, camera, params, 32, 32, spp=2,
                                    seed=3)
    local = np.asarray(film.rgb_sum)
    # lossy but close in display space (radiance sums carry weight=spp)
    err = np.abs(np.power(np.maximum(img, 0) / 2, 1 / 2.2)
                 - np.power(np.clip(local / 2, 0, None), 1 / 2.2))
    assert float(np.median(err)) < 0.05


def test_codec_roundtrip_scene_builder():
    """The safe wire codec (no pickle) round-trips the full staged scene,
    cameras, and distribution tables."""
    sb = builtin_scenes.cornell_box()
    blob = network.encode_tree(sb)
    sb2 = network.decode_tree(blob)
    assert len(sb2.meshes) == len(sb.meshes)
    assert len(sb2.lights) == len(sb.lights)
    np.testing.assert_array_equal(sb2.meshes[0].positions,
                                  sb.meshes[0].positions)
    cam = builtin_scenes.cornell_camera(8, 8)
    cam2 = network.decode_tree(network.encode_tree(cam))
    np.testing.assert_array_equal(np.asarray(cam2.local2world),
                                  np.asarray(cam.local2world))
    assert cam2.angle == cam.angle
    # pickle-style payloads must NOT decode
    with pytest.raises((ConnectionError, Exception)):
        network.decode_tree(b'\x80\x04K\x01.')


def test_malformed_peer_rejected():
    """Wrong magick / corrupt payloads raise ConnectionError instead of
    being interpreted (network_common.h:26 magick + crc hardening)."""
    import socket as _socket
    import struct as _struct

    port = 19476
    server = network.RenderServer(port, single_connection=True)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    # peer with a wrong magick: the server must drop the connection
    s = _socket.create_connection(('127.0.0.1', port), timeout=10)
    payload = network.encode_tree({'serverID': 0, 'serverCount': 1})
    s.sendall(network._FRAME.pack(0xDEADBEEF, network.VERSION,
                                  network.OP_HELLO, len(payload), 0)
              + payload)
    s.settimeout(10)
    try:
        assert s.recv(1) == b''     # server closed on us (FIN or RST)
    except (ConnectionResetError, ConnectionError):
        pass
    s.close()
    server.stop()

    # client side: corrupt crc must raise, not decode
    a, b = _socket.socketpair()
    try:
        good = network.encode_tree({'x': 1})
        a.sendall(network._FRAME.pack(network.MAGICK, network.VERSION,
                                      network.OP_FRAME, len(good),
                                      0x12345678) + good)
        with pytest.raises(ConnectionError):
            network._recv(b)
    finally:
        a.close()
        b.close()


def test_incremental_light_update():
    """OP_UPDATE_LIGHT edits a light server-side without reshipping the
    scene (the incremental opcode-protocol requirement): doubling the
    quad light's radiance doubles the direct image."""
    port = 19477
    server = network.RenderServer(port, single_connection=True)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    sb = builtin_scenes.cornell_box(with_boxes=False)
    camera = builtin_scenes.cornell_camera(16, 16)
    params = pt.PTParams(max_depth=1)   # direct light only

    client = network.NetworkClient([('127.0.0.1', port)])
    client.set_scene(sb)
    img1, _ = client.render(camera, params, 16, 16, spp=1, seed=3)
    L0 = np.asarray(sb.lights[0]['L'])
    client.update_light(0, L=(L0 * 2.0).tolist())
    client.update_light(1, L=(np.asarray(sb.lights[1]['L']) * 2).tolist())
    img2, _ = client.render(camera, params, 16, 16, spp=1, seed=3)
    client.close()
    server.stop()

    lit = img1.max(axis=-1) > 1e-3
    assert lit.any()
    np.testing.assert_allclose(img2[lit], 2.0 * img1[lit], rtol=1e-5)


@pytest.mark.slow
def test_cli_connect_matches_local(tmp_path):
    """Front-end device selection (renderer.cpp:948-956): `-connect
    host:port host:port` renders through the TCP device and the merged
    result equals the local render of the same .ecs scene.  Slow tier:
    two full CLI renders (~90 s here); the default run keeps the
    lib-level bit-identity test + the server CLI entry test."""
    import os
    from yulio_raytracer.api import cli
    from PIL import Image

    ports = [19481, 19482]
    servers = [network.RenderServer(p, single_connection=True)
               for p in ports]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    ecs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'assets', 'scenes',
        'cornell_box.ecs')
    net_png = str(tmp_path / "net.png")
    loc_png = str(tmp_path / "loc.png")
    args = ['-c', ecs, '-size', '32', '32', '-spp', '2', '-gamma', '1.0']
    assert cli.main(args + ['-connect', '127.0.0.1:19481',
                            '127.0.0.1:19482', '-o', net_png]) == 0
    for s in servers:
        s.stop()
    assert cli.main(args + ['-o', loc_png]) == 0
    a = np.asarray(Image.open(net_png))
    b = np.asarray(Image.open(loc_png))
    np.testing.assert_array_equal(a, b)


def test_server_cli_entry():
    """`rt_server` standalone entry (network_server_main.cpp:99-112):
    python -m ...parallel.network -port P -single-connection."""
    from yulio_raytracer.io import builtin_scenes
    from yulio_raytracer.integrator import pathtracer as pt

    port = 19483
    t = threading.Thread(
        target=network.main,
        args=(['-port', str(port), '-host', '127.0.0.1', '-encode',
               'rgbe8', '-single-connection'],), daemon=True)
    t.start()
    import time
    for _ in range(50):                       # wait for the listener
        time.sleep(0.1)
        try:
            client = network.NetworkClient([('127.0.0.1', port)],
                                           connect_timeout=2.0)
            break
        except OSError:
            continue
    else:
        raise AssertionError("server CLI never listened")
    sb = builtin_scenes.cornell_box(with_boxes=False)
    client.set_scene(sb)
    # the server's -encode rgbe8 overrides the requested native tier
    img, weight = client.render(
        builtin_scenes.cornell_camera(16, 16),
        pt.PTParams(max_depth=2), 16, 16, spp=1, seed=0)
    client.close()
    t.join(timeout=10)
    assert (weight == 1.0).all()
    assert np.isfinite(img).all() and img.max() > 0


@pytest.mark.slow
def test_stereo_over_tcp_matches_local(tmp_path):
    """The network Device serves the stereo output mode too: a 12-face
    strip rendered through two TCP servers equals the local strip
    (device selection precedes outputMode, renderer.cpp:948-956).
    Exercises the per-viewpoint billboard recommit over the wire
    (view_pos in OP_RENDER).  Slow tier: 24 face renders + 2 full CLI
    invocations (~5 min cold on this box)."""
    import os
    from yulio_raytracer.api import cli
    from PIL import Image

    ecs_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'assets', 'scenes', 'test_stereo.ecs')
    args = ['-c', ecs_path, '-size', '8', '8', '-spp', '1', '-depth', '2']

    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(args) == 0
        os.rename('test_stereo_view.jpg', 'local.jpg')
        ports = [19491, 19492]
        servers = [network.RenderServer(p, single_connection=True)
                   for p in ports]
        threads = [threading.Thread(target=s.serve_forever, daemon=True)
                   for s in servers]
        for t in threads:
            t.start()
        assert cli.main(args + ['-connect', '127.0.0.1:19491',
                                '127.0.0.1:19492']) == 0
        for s in servers:
            s.stop()
        a = np.asarray(Image.open('local.jpg'))
        b = np.asarray(Image.open('test_stereo_view.jpg'))
    finally:
        os.chdir(old)
    np.testing.assert_array_equal(a, b)


def test_view_pos_recommit_matches_local():
    """Fast default-tier coverage of the v5 wire fields: a billboard
    scene rendered over TCP with a view_pos matches the local render
    committed at that viewpoint, and changing view_pos changes the
    image (the server's keyed recommit)."""
    import os
    from yulio_raytracer.io import collada, ecs
    from yulio_raytracer.scene import SceneBuilder
    from yulio_raytracer.cameras import cameras as cam

    dae = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'assets', 'scenes', 'test_room.dae')
    settings = ecs.RenderSettings()
    sb = SceneBuilder()
    collada.load_dae(dae, settings, sb)
    assert sb.has_billboards()
    from yulio_raytracer.lights import lights as gl
    sb.add_light(gl.ambient((1.0, 1.0, 1.0)))   # light any viewpoint

    port = 19493
    server = network.RenderServer(port, single_connection=True)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    # camera fixed on the billboard (authored at (2,-1,0)); only the
    # commit viewpoint changes: face-on vs ~edge-on orientation
    l2w = cam.look_at((6.0, -1.0, 0.0), (2.0, -1.0, 0.0), (0, 1, 0))
    camera = cam.Pinhole(l2w, angle=60.0, aspect=1.0)
    params = pt.PTParams(max_depth=2)
    client = network.NetworkClient([('127.0.0.1', port)])
    client.set_scene(sb)
    imgs = {}
    for vp in ((6.0, -1.0, 0.0), (2.0, -1.0, 6.0)):
        img, w = client.render(camera, params, 16, 16, spp=1, seed=5,
                               view_pos=vp)
        assert (w == 1.0).all()
        scene = sb.commit(view_pos=np.asarray(vp))
        film, _ = renderer.render_frame(scene, camera, params, 16, 16,
                                        spp=1, seed=5)
        np.testing.assert_allclose(img, np.asarray(film.rgb_sum),
                                   atol=1e-5)
        imgs[vp] = img
    client.close()
    server.stop()
    vals = list(imgs.values())
    assert np.abs(vals[0] - vals[1]).max() > 0, \
        "view_pos change must re-orient the billboard"
