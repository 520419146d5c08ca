"""Distributed rendering over TCP — the `device_network` equivalent.

For the devices of one host (or of one jax.distributed job) the
idiomatic scaling path is `parallel.sharding` (XLA collectives over
NVLink).  This module reproduces the reference's *process-level*
distribution for DCN-connected, independently-launched hosts
(`devices/device_network/`):

* a render **server** wraps the local renderer and renders only its
  interleaved row bands — the exact reference decomposition
  `((y >> 2) - serverID) % serverCount == 0` (swapchain.h:57-60,
  network_server.cpp:669);
* a **client** connects to N servers, broadcasts the scene + render
  command to all (network_device.h:103-110), and merges the returned
  bands (network_device.cpp:268-310).

Wire protocol (the opcode-per-command spirit of network_common.h:26-80):
every frame is `MAGICK u32 | VERSION u16 | opcode u16 | length u64 |
crc32 u32 | payload`; the magick is the reference's 0x32657845
(network_common.h:26), the crc covers the payload (per-band integrity —
a corrupted row band is rejected, not merged), and the payload is a
restricted self-describing tree codec (scalars, strings, bytes,
lists/dicts, dtype-whitelisted ndarrays, and a short registry of scene
dataclasses).  NO pickle anywhere: a malicious peer can produce garbage
or a ConnectionError, never code execution.

Incremental updates: `OP_UPDATE_LIGHT` patches one light's parameters on
the server without reshipping the scene (the reference edits any handle
with a 2-word opcode, network_common.h:29-80; lights are the handles
whose interactive edits matter).  Determinism: band assignment only
selects *pixels*; the stateless RNG keys by absolute pixel id, so the
merged image is bit-identical to a single-host render.
"""
from __future__ import annotations

import socket
import struct
import threading
import zlib
from typing import Optional

import numpy as np

MAGICK = 0x32657845   # network_common.h:26
VERSION = 5           # bump on any wire-format change
                      # v4: OP_RENDER carries pixel_filter + backplate
                      # v5: OP_RENDER carries view_pos/view_up (stereo
                      #     billboard recommit over the wire)
_FRAME = struct.Struct(">IHHQI")   # magick, version, opcode, len, crc32

# opcodes (the EMBREE_* command-id table, network_common.h:29-80)
OP_HELLO = 1
OP_SET_SCENE = 2
OP_RENDER = 3
OP_FRAME = 4
OP_UPDATE_LIGHT = 5
OP_CLOSE = 6
OP_ERROR = 7

MAX_FRAME_BYTES = 1 << 33    # 8 GiB sanity bound on declared lengths


# --------------------------------------------------------------------------
# safe tree codec (no pickle)
# --------------------------------------------------------------------------

_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_BYTES = 0, 1, 2, 3, 4, 5
_T_LIST, _T_TUPLE, _T_DICT, _T_NDARRAY, _T_DATACLASS = 6, 7, 8, 9, 10
_T_NAMEDTUPLE = 11

_DTYPE_WHITELIST = ('f4', 'f8', 'i4', 'i8', 'u1', 'u4', 'b1')


def _registry():
    """Dataclasses/NamedTuples allowed on the wire, by name.  Imported
    lazily so the codec has no import cycle with the scene modules."""
    from ..cameras import cameras as gcam
    from ..geometry.mesh import HostMesh
    from ..shading.materials import LobeSpec, MaterialSpec
    from ..shading.textures import TextureTableBuilder
    from ..sampling.distribution import Distribution1D, Distribution2D
    from ..scene import SceneBuilder
    return {c.__name__: c for c in (
        gcam.Pinhole, gcam.DepthOfField, gcam.StereoCube,
        HostMesh, LobeSpec, MaterialSpec, TextureTableBuilder,
        SceneBuilder, Distribution1D, Distribution2D)}


def _pack(obj, out: bytearray):
    import dataclasses
    if obj is None:
        out.append(_T_NONE)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(_T_BOOL)
        out.append(1 if obj else 0)
    elif isinstance(obj, (int, np.integer)):
        out.append(_T_INT)
        out += struct.pack(">q", int(obj))
    elif isinstance(obj, (float, np.floating)):
        out.append(_T_FLOAT)
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_T_STR)
        out += struct.pack(">I", len(b)) + b
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES)
        out += struct.pack(">Q", len(obj)) + obj
    elif isinstance(obj, tuple) and hasattr(obj, '_fields'):
        name = type(obj).__name__
        if name not in _registry():
            raise TypeError(f"namedtuple {name} is not wire-registered")
        out.append(_T_NAMEDTUPLE)
        _pack(name, out)
        _pack(dict(zip(obj._fields, obj)), out)
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST if isinstance(obj, list) else _T_TUPLE)
        out += struct.pack(">I", len(obj))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        out += struct.pack(">I", len(obj))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"wire dict keys must be str, got {k!r}")
            _pack(k, out)
            _pack(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _registry():
            raise TypeError(f"dataclass {name} is not wire-registered")
        out.append(_T_DATACLASS)
        _pack(name, out)
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)
                  if not f.name.startswith('_')}
        _pack(fields, out)
    else:
        # device arrays and array-likes ship as numpy
        a = np.asarray(obj)
        ds = a.dtype.str.lstrip('<>=|')
        if ds not in _DTYPE_WHITELIST:
            raise TypeError(f"dtype {a.dtype} not wire-whitelisted")
        a = np.ascontiguousarray(a)
        out.append(_T_NDARRAY)
        _pack(ds, out)
        _pack(list(a.shape), out)
        raw = a.tobytes()
        out += struct.pack(">Q", len(raw)) + raw


def _unpack(buf: memoryview, pos: int):
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_BOOL:
        return bool(buf[pos]), pos + 1
    if tag == _T_INT:
        return struct.unpack_from(">q", buf, pos)[0], pos + 8
    if tag == _T_FLOAT:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if tag == _T_STR:
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if tag == _T_BYTES:
        (n,) = struct.unpack_from(">Q", buf, pos)
        pos += 8
        return bytes(buf[pos:pos + n]), pos + n
    if tag in (_T_LIST, _T_TUPLE):
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        xs = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            xs.append(x)
        return (xs if tag == _T_LIST else tuple(xs)), pos
    if tag == _T_DICT:
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            v, pos = _unpack(buf, pos)
            d[k] = v
        return d, pos
    if tag == _T_NDARRAY:
        ds, pos = _unpack(buf, pos)
        shape, pos = _unpack(buf, pos)
        if ds not in _DTYPE_WHITELIST:
            raise ConnectionError(f"non-whitelisted wire dtype {ds!r}")
        (n,) = struct.unpack_from(">Q", buf, pos)
        pos += 8
        a = np.frombuffer(bytes(buf[pos:pos + n]), dtype=np.dtype(ds))
        return a.reshape(shape), pos + n
    if tag in (_T_DATACLASS, _T_NAMEDTUPLE):
        name, pos = _unpack(buf, pos)
        fields, pos = _unpack(buf, pos)
        cls = _registry().get(name)
        if cls is None:
            raise ConnectionError(f"unknown wire dataclass {name!r}")
        return cls(**fields), pos
    raise ConnectionError(f"malformed wire payload (tag {tag})")


def encode_tree(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def decode_tree(data: bytes):
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ConnectionError("trailing bytes in wire payload")
    return obj


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------

def _send(sock: socket.socket, opcode: int, obj):
    payload = encode_tree(obj)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    sock.sendall(_FRAME.pack(MAGICK, VERSION, opcode, len(payload), crc)
                 + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer disconnected")   # network.h:30
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket):
    """Returns (opcode, payload tree).  Rejects wrong magick/version and
    corrupt payloads (crc) with ConnectionError."""
    magick, ver, op, n, crc = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    if magick != MAGICK:
        raise ConnectionError(f"bad magick {magick:#x}")
    if ver != VERSION:
        raise ConnectionError(f"wire version mismatch: {ver} != {VERSION}")
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"oversized frame ({n} bytes)")
    payload = _recv_exact(sock, n)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ConnectionError("payload checksum mismatch")
    return op, decode_tree(payload)


# --------------------------------------------------------------------------
# encodings (bandwidth tiers)
# --------------------------------------------------------------------------

def rgbe8_encode(rgb: np.ndarray) -> np.ndarray:
    """Ward RGBE shared-exponent encoding (network_common.h:83-103's
    compression tier): (..., 3) f32 -> (..., 4) u8."""
    v = rgb.max(axis=-1)
    mant, expo = np.frexp(np.maximum(v, 1e-32))
    scale = np.where(v >= 1e-32, mant * 256.0 / np.maximum(v, 1e-32), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v >= 1e-32, expo + 128, 0).astype(np.uint8)
    return out


def rgbe8_decode(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * f[..., None]


def jpeg_encode(rgb: np.ndarray, quality: int = 90) -> bytes:
    """JPEG row-band tier (network_server.cpp:680-739, libjpeg-turbo
    there; Pillow's C libjpeg here).  Linear radiance is sent through a
    gamma-2.2 transfer so JPEG's perceptual quantization operates in
    display space; values above 1.0 clip (lossy by design — the tier
    exists for thin DCN links)."""
    import io
    from PIL import Image
    u8 = np.clip(np.power(np.maximum(rgb, 0.0), 1.0 / 2.2) * 255.0 + 0.5,
                 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format='JPEG', quality=int(quality))
    return buf.getvalue()


def jpeg_decode(data: bytes) -> np.ndarray:
    import io
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        u8 = np.asarray(im.convert('RGB'), np.float32)
    return np.power(u8 / 255.0, 2.2)


def active_rows(height: int, server_id: int, server_count: int) -> np.ndarray:
    """The reference's 4-row band interleave (swapchain.h:57-60)."""
    y = np.arange(height)
    return np.nonzero(((y >> 2) - server_id) % server_count == 0)[0]


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

class RenderServer:
    """`network_server_main.cpp` analog: serve render requests forever."""

    def __init__(self, port: int, host: str = '127.0.0.1',
                 single_connection: bool = False, verbose: bool = False,
                 force_encoding: str = None):
        self.port = port
        self.host = host
        self.single = single_connection
        self.verbose = verbose
        # the -encode server flag (network_server_main.cpp:58-75):
        # overrides the client-requested reply encoding
        self.force_encoding = ({'rgb_float32': 'native'}.get(
            force_encoding, force_encoding) if force_encoding else None)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self._stop = threading.Event()

    def serve_forever(self):
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            try:
                self._serve_one(conn)
            except ConnectionError:
                pass        # malformed/hostile peer: drop the connection
            finally:
                conn.close()
            if self.single:
                break

    def stop(self):
        self._stop.set()

    def _serve_one(self, conn):
        op, hello = _recv(conn)
        if op != OP_HELLO:
            raise ConnectionError("expected HELLO")
        server_id = hello['serverID']          # network_device.cpp:100-106
        server_count = hello['serverCount']
        state = {'scene': None}                # committed-scene cache
        while True:
            try:
                op, msg = _recv(conn)
            except ConnectionError:
                return
            if op == OP_SET_SCENE:
                state['builder'] = msg['builder']
                state['scene'] = None
            elif op == OP_UPDATE_LIGHT:
                # incremental edit: patch one light, recommit lazily
                # (the opcode-per-API-call protocol's set+commit pair)
                light = state['builder'].lights[msg['index']]
                for k, v in msg['values'].items():
                    if k not in light:
                        raise ConnectionError(
                            f"unknown light parameter {k!r}")
                    light[k] = (np.asarray(v, np.float32)
                                if isinstance(light[k], np.ndarray)
                                else type(light[k])(v))
                state['scene'] = None
            elif op == OP_RENDER:
                try:
                    reply = self._render(state, msg, server_id,
                                         server_count)
                except ConnectionError:
                    raise
                except Exception as e:          # render error -> OP_ERROR
                    _send(conn, OP_ERROR, {'error': repr(e)})
                    continue
                _send(conn, OP_FRAME, reply)
            elif op == OP_CLOSE:
                return
            else:
                raise ConnectionError(f"unknown opcode {op}")

    def _render(self, state, msg, server_id, server_count):
        from ..integrator import pathtracer as pt
        from .. import renderer as grenderer
        from ..sampling import patterns

        if self.force_encoding is not None:
            msg = {**msg, 'encoding': self.force_encoding}
        # camera-aligned billboards: stereo viewpoints recommit with the
        # rig origin (rtUpdatePrimitive + rtCommit, renderer.cpp:550-559).
        # Without billboards the commit is viewpoint-independent — keep
        # the cached scene (the local path guards with has_billboards too)
        vp = msg.get('view_pos')
        if vp is not None and not state['builder'].has_billboards():
            vp = None
        vkey = None if vp is None else (tuple(np.asarray(vp).tolist()),
                                        tuple(msg.get('view_up',
                                                      (0.0, 1.0, 0.0))))
        if state['scene'] is None or state.get('view_key') != vkey:
            kw = {}
            if vp is not None:
                kw = dict(view_pos=np.asarray(vp, np.float64),
                          view_up=tuple(msg.get('view_up',
                                                (0.0, 1.0, 0.0))))
            state['scene'] = state['builder'].commit(**kw)
            state['view_key'] = vkey
        scene = state['scene']
        camera = msg['camera']
        params = pt.PTParams(**msg['params'])
        w, h, spp = msg['width'], msg['height'], msg['spp']

        rows = active_rows(h, server_id, server_count)
        # render only our rows: pass their pixel ids through the chunk API
        import jax.numpy as jnp
        bp = msg.get('backplate')
        bp = None if bp is None else jnp.asarray(bp[..., :3], jnp.float32)
        pix = (rows[:, None] * w + np.arange(w)[None, :]).reshape(-1)
        rgb = np.zeros((len(pix), 3), np.float32)
        chunk = 1 << 17
        for s in range(spp):
            for lo in range(0, len(pix), chunk):
                hi = min(lo + chunk, len(pix))
                ids = np.resize(pix[lo:hi].astype(np.uint32), chunk)
                out, _ = grenderer._render_chunk(
                    scene, camera, params, w, h,
                    patterns.grid_scalars(spp),
                    jnp.asarray(ids),
                    jnp.full((chunk,), np.uint32(s)),
                    np.uint32(msg.get('seed', 0)), bp,
                    spp_per_pass=1,
                    pixel_filter=msg.get('pixel_filter', 'box'))
                rgb[lo:hi] += np.asarray(out[:hi - lo])
        out = rgb.reshape(len(rows), w, 3)
        if msg.get('encoding') == 'rgbe8':
            # the bandwidth tier of network_common.h:83-103
            return {'rows': rows, 'rgbe': rgbe8_encode(out),
                    'weight': float(spp)}
        if msg.get('encoding') == 'jpeg':
            # the thin-link tier (network_server.cpp:680-739); the wire
            # carries per-spp-averaged radiance as a JPEG
            return {'rows': rows,
                    'jpeg': jpeg_encode(out / max(spp, 1),
                                        msg.get('jpeg_quality', 90)),
                    'weight': float(spp)}
        return {'rows': rows, 'rgb': out, 'weight': float(spp)}


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------

class NetworkClient:
    """`NetworkDevice` analog: broadcast scene + render, merge bands."""

    def __init__(self, addresses: list, connect_timeout: float = 30.0):
        self.socks = []
        for i, (host, port) in enumerate(addresses):
            s = socket.create_connection((host, port),
                                         timeout=connect_timeout)
            # renders (first-compile especially) can take minutes — only
            # the connect is bounded; replies block indefinitely
            s.settimeout(None)
            _send(s, OP_HELLO, {'serverID': i,
                                'serverCount': len(addresses)})
            self.socks.append(s)

    def set_scene(self, builder):
        for s in self.socks:
            _send(s, OP_SET_SCENE, {'builder': builder})

    def update_light(self, index: int, **values):
        """Incremental light edit on every server — no scene reship
        (e.g. client.update_light(0, L=(2.0, 2.0, 2.0)))."""
        for s in self.socks:
            _send(s, OP_UPDATE_LIGHT, {'index': index, 'values': values})

    def render(self, camera, params, width, height, spp, seed=0,
               encoding: str = 'native', jpeg_quality: int = 90,
               pixel_filter: str = 'box', backplate=None,
               view_pos=None, view_up=(0.0, 1.0, 0.0)):
        """encoding: 'native' (f32 rows), 'rgbe8' (4 B/px shared-exponent,
        network_device.cpp:256-310) or 'jpeg' (lossy row bands with
        quality 1-100, the `-encode jpeg` tier of network_server.cpp).
        view_pos/view_up orient camera-aligned billboards (servers
        recommit when the viewpoint changes)."""
        msg = {'camera': camera,
               'params': {**params.__dict__}, 'width': width,
               'height': height, 'spp': spp, 'seed': seed,
               'encoding': encoding, 'jpeg_quality': jpeg_quality,
               'pixel_filter': pixel_filter,
               'backplate': (None if backplate is None
                             else np.asarray(backplate, np.float32)),
               'view_pos': (None if view_pos is None
                            else np.asarray(view_pos, np.float32)),
               'view_up': tuple(view_up)}
        for s in self.socks:
            _send(s, OP_RENDER, msg)
        img = np.zeros((height, width, 3), np.float32)
        weight = np.zeros((height, width), np.float32)
        results = [None] * len(self.socks)
        errors = [None] * len(self.socks)

        def fetch(i):
            try:
                op, r = _recv(self.socks[i])
                if op == OP_ERROR:
                    raise ConnectionError(r.get('error', 'remote error'))
                if op != OP_FRAME:
                    raise ConnectionError(f"unexpected opcode {op}")
                results[i] = r
            except Exception as e:           # surfaced below, not dropped
                errors[i] = e

        threads = [threading.Thread(target=fetch, args=(i,))
                   for i in range(len(self.socks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, e in enumerate(errors):
            if e is not None:
                raise ConnectionError(f"server {i} failed: {e!r}") from e
        for r in results:
            if 'rgbe' in r:
                band = rgbe8_decode(r['rgbe'])
            elif 'jpeg' in r:
                band = jpeg_decode(r['jpeg']) * r['weight']
            else:
                band = r['rgb']
            img[np.asarray(r['rows'])] = band
            weight[np.asarray(r['rows'])] = r['weight']
        return img, weight

    def close(self):
        for s in self.socks:
            try:
                _send(s, OP_CLOSE, {})
                s.close()
            except OSError:
                pass


# --------------------------------------------------------------------------
# standalone server CLI (network_server_main.cpp:43-112)
# --------------------------------------------------------------------------

def main(argv=None):
    """`rt_server` analog: python -m yulio_raytracer.parallel.network
    -port 8282 [-host 0.0.0.0] [-encode native|rgbe8|jpeg] [-threads N]
    [-single-connection] [-verbose].  Flags mirror
    network_server_main.cpp:43-95 (-device accepted: the only local
    device kind here is the JAX backend; -threads accepted: XLA manages
    intra-op parallelism)."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog='rt_server')
    ap.add_argument('-port', '--port', type=int, default=8282)
    ap.add_argument('-host', '--host', default='0.0.0.0')
    ap.add_argument('-encode', '--encode', default=None,
                    choices=('native', 'rgb_float32', 'rgbe8', 'jpeg'))
    ap.add_argument('-threads', '--threads', type=int, default=0)
    ap.add_argument('-device', '--device', default=None)
    ap.add_argument('-single-connection', '--single-connection',
                    dest='single', action='store_true')
    ap.add_argument('-verbose', '--verbose', action='store_true')
    args = ap.parse_args(argv)

    from ..utils import compile_cache, hostmem
    compile_cache.enable()
    hostmem.prefault_async()
    server = RenderServer(args.port, host=args.host,
                          single_connection=args.single,
                          verbose=args.verbose,
                          force_encoding=args.encode)
    print(f"rt_server listening on {args.host}:{args.port}"
          + (f" (encode={args.encode})" if args.encode else ""),
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
