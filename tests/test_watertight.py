"""Watertight-traversal battery — RTC_SCENE_ROBUST parity
(scene_flat.h:94: the reference commits every scene in robust mode,
promising no missed hits at grazing incidence / edge crossings).

Each case aims rays exactly at shared edges, shared vertices, or a
closed surface's corners — places where a non-watertight f32 triangle
test can land epsilon-outside EVERY incident triangle and leak.  An f64
inclusive Moller-Trumbore oracle decides "should hit"; any oracle hit
that an f32 path misses is a leak.  The repo's policy (zero leaks on
this battery) is the 32-ulp inclusive barycentric test — see
ops/intersect.py::BARY_EPS.

Covers the triangle-test implementations: brute MT (ops/intersect.py),
dense Woop (intersect_woop), the XLA BVH traversal (ops/traverse.py) and
the GPU traversal kernel (ops/traverse_triton.py, interpret mode — the
compiled kernel runs the same arithmetic; tests/test_gpu.py and
chip_smoke.py check it compiled on the card).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from yulio_raytracer.geometry import mesh, bvh, primitives
from yulio_raytracer.ops import intersect, traverse
from yulio_raytracer.ops import traverse_triton as ttk


def _build(meshes):
    packed = mesh.pack_meshes(meshes, pad_multiple=64)
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=8)
    host = {k: getattr(packed, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id',
        'cull', 'illum_mask', 'shadow_mask', 'valid')}
    host = bvh.permute_geom(host, tree.order)
    host['woop'] = mesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                                      host['valid'])
    geom = {k: jnp.asarray(v) for k, v in host.items()}
    return bvh.to_device(tree), geom


def _oracle_should_hit(meshes, org, dirn):
    """f64 inclusive MT: any ray this hits, an f32 path must also hit."""
    packed = mesh.pack_meshes(meshes, pad_multiple=64)
    val = packed.valid
    v0 = packed.v0[val].astype(np.float64)
    e1 = packed.e1[val].astype(np.float64)
    e2 = packed.e2[val].astype(np.float64)
    o = org.astype(np.float64)[:, None]
    d = dirn.astype(np.float64)[:, None]
    eps = 1e-12
    p = np.cross(d, e2[None])
    det = (e1[None] * p).sum(-1)
    inv = np.where(np.abs(det) > 1e-300, 1.0 / det, 0.0)
    tv = o - v0[None]
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1[None])
    v = (d * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    ok = ((np.abs(det) > 0) & (u >= -eps) & (v >= -eps)
          & (u + v <= 1 + eps) & (t > 1e-9))
    return ok.any(-1)


def _leaks(meshes, org, dirn):
    """(brute, woop, XLA BVH, GPU kernel) leak counts vs the f64
    oracle; each path must leak on exactly zero rays."""
    tree, geom = _build(meshes)
    n = len(org)
    o = jnp.asarray(org, jnp.float32)
    d = jnp.asarray(dirn, jnp.float32)
    tn = jnp.zeros((n,))
    tf = jnp.full((n,), np.inf)
    hb = intersect.intersect_brute(geom, o, d, tn, tf, block=64)
    hw = intersect.intersect_woop(geom, o, d, tn, tf, block=64)
    ht = traverse.intersect_bvh(geom, tree, o, d, tn, tf, leaf_size=8)
    hk = ttk.intersect_bvh(geom, tree, o, d, tn, tf, interpret=True)
    should = _oracle_should_hit(meshes, org, dirn)
    out = []
    for h in (hb, hw, ht, hk):
        miss = ~np.isfinite(np.asarray(h.t)[:n])
        out.append(int((miss & should).sum()))
    return tuple(out)


def test_quad_shared_diagonal():
    """Rays exactly on the shared diagonal of a 2-triangle quad — both
    straight-down and oblique (different arithmetic per direction)."""
    quad = primitives.quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0])
    s = np.linspace(0.001, 0.999, 500).astype(np.float32)
    org_v = np.stack([s, s, np.ones_like(s)], -1)
    dir_v = np.tile(np.float32([[0, 0, -1]]), (len(s), 1))
    assert _leaks([quad], org_v, dir_v) == (0, 0, 0, 0)

    o2 = np.float32([-0.7, 0.31, 1.3])
    p = np.stack([s, s, np.zeros_like(s)], -1)
    dv = p - o2
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    org_o = np.tile(o2, (len(s), 1)).astype(np.float32)
    assert _leaks([quad], org_o, dv) == (0, 0, 0, 0)


def test_vertex_fan_center():
    """Rays through the shared center vertex of a 12-triangle fan."""
    c = np.float32([0.3, 0.7, 0.0])
    K = 12
    ang = np.linspace(0, 2 * np.pi, K + 1)
    rim = np.stack([c[0] + np.cos(ang), c[1] + np.sin(ang),
                    np.zeros(K + 1)], -1).astype(np.float32)
    fan = [primitives.single_triangle(c, rim[i], rim[i + 1])
           for i in range(K)]
    rs = np.random.RandomState(3)
    orgs = (rs.randn(256, 3) * 2 + np.float32([0, 0, 3])).astype(np.float32)
    orgs[:, 2] = np.abs(orgs[:, 2]) + 0.5
    dirs = c[None] - orgs
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    assert _leaks(fan, orgs, dirs) == (0, 0, 0, 0)


def _cube():
    lo, hi = np.float32(-1.0), np.float32(1.0)
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)], np.float32)
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris_idx = []
    for a, b, cc, dd in faces:
        tris_idx += [(a, b, cc), (a, cc, dd)]
    return mesh.HostMesh(v, np.asarray(tris_idx, np.int32)), v, tris_idx


def test_closed_cube_no_escape():
    """From a closed cube's center toward every edge point and corner:
    any miss is a leak out of a closed surface."""
    cube, v, tris_idx = _cube()
    edges = set()
    for t in tris_idx:
        for i in range(3):
            e = tuple(sorted((t[i], t[(i + 1) % 3])))
            edges.add(e)
    targets = [v[a] * (1 - w) + v[b] * w
               for a, b in sorted(edges)
               for w in np.linspace(0, 1, 32, dtype=np.float32)]
    targets = np.asarray(targets, np.float32)
    dirs = targets / np.linalg.norm(targets, axis=1, keepdims=True)
    orgs = np.zeros_like(dirs)
    assert _leaks([cube], orgs, dirs) == (0, 0, 0, 0)


def test_closed_cube_random_directions():
    cube, _, _ = _cube()
    rs = np.random.RandomState(7)
    rd = rs.randn(2048, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    assert _leaks([cube], np.zeros_like(rd), rd) == (0, 0, 0, 0)


def test_sliver_grazing():
    """Grazing rays down the long axis of near-degenerate slivers."""
    slivers = []
    for i in range(8):
        y = np.float32(i * 0.01)
        slivers.append(primitives.single_triangle(
            [0, y, 0], [100.0, y + 1e-4, 0], [0, y + 1e-4, 1e-3]))
    m = 256
    rs = np.random.RandomState(11)
    oy = rs.uniform(0, 0.08, m).astype(np.float32)
    oz = rs.uniform(0, 1e-3, m).astype(np.float32)
    org = np.stack([np.full(m, -1.0, np.float32), oy, oz], -1)
    px = rs.uniform(10, 90, m).astype(np.float32)
    tgt = np.stack([px, oy + 5e-5, oz * 0.5], -1)
    dv = tgt - org
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    assert _leaks(slivers, org, dv) == (0, 0, 0, 0)


def test_bary_eps_is_32ulp():
    """The policy constant matches the reference's 32-ulp convention
    (pathtraceintegrator.cpp:32)."""
    assert intersect.BARY_EPS == pytest.approx(32 * np.finfo(np.float32).eps)
