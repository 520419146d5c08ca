import numpy as np
import jax.numpy as jnp

from yulio_raytracer.geometry import mesh, bvh, primitives
from yulio_raytracer.ops import intersect, traverse


def _scene(seed=0, num_meshes=6):
    rs = np.random.RandomState(seed)
    meshes = []
    for i in range(num_meshes):
        nv = rs.randint(8, 40)
        # cluster meshes in different regions to give the BVH structure
        center = rs.randn(3) * 10
        pos = (rs.randn(nv, 3) * 1.5 + center).astype(np.float32)
        nt = rs.randint(5, 40)
        tri = rs.randint(0, nv, (nt, 3)).astype(np.int32)
        meshes.append(mesh.HostMesh(pos, tri, material=i,
                                    cull=int(rs.rand() < 0.3)))
    meshes.append(primitives.tessellate_sphere(rs.randn(3) * 5, 2.0, 12, 16))
    return mesh.pack_meshes(meshes, pad_multiple=64)


def _rays(seed, R):
    rs = np.random.RandomState(seed)
    org = rs.randn(R, 3).astype(np.float32) * 8
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def _build(packed, leaf_size):
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=leaf_size)
    # permute on host then upload
    host = {
        'v0': packed.v0, 'e1': packed.e1, 'e2': packed.e2, 'ng': packed.ng,
        'vn': packed.vn, 'uv': packed.uv, 'mat_id': packed.mat_id,
        'light_id': packed.light_id, 'cull': packed.cull,
        'illum_mask': packed.illum_mask, 'shadow_mask': packed.shadow_mask,
        'valid': packed.valid,
    }
    host = bvh.permute_geom(host, tree.order)
    geom = {k: jnp.asarray(v) for k, v in host.items()}
    return geom, bvh.to_device(tree), tree


def test_skip_pointers_wellformed():
    packed = _scene()
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=8)
    n = tree.num_nodes
    assert tree.skip[0] == n
    # every interior node's skip is > its own index and <= n
    assert (tree.skip > np.arange(n)).all()
    assert (tree.skip <= n).all()
    # leaves' ranges tile the live triangle set exactly once
    leaves = tree.count > 0
    total = tree.count[leaves].sum()
    assert total == packed.valid.sum()
    # the permutation is a bijection
    assert len(np.unique(tree.order)) == len(tree.order)


def test_bvh_intersect_matches_brute():
    packed = _scene(1)
    geom_b = mesh.to_device(packed)
    geom, tree_dev, tree = _build(packed, leaf_size=8)
    org, d = _rays(2, 512)
    tn = jnp.full((512,), 1e-4)
    tf = jnp.full((512,), jnp.inf)
    href = intersect.intersect_brute(geom_b, org, d, tn, tf, block=64)
    hbvh = traverse.intersect_bvh(geom, tree_dev, org, d, tn, tf, leaf_size=8)
    np.testing.assert_allclose(
        np.where(np.isfinite(np.asarray(href.t)), np.asarray(href.t), 0),
        np.where(np.isfinite(np.asarray(hbvh.t)), np.asarray(hbvh.t), 0),
        rtol=2e-4, atol=1e-5)
    assert (np.isfinite(np.asarray(href.t))
            == np.isfinite(np.asarray(hbvh.t))).all()
    # triangle ids must agree modulo the permutation (up to exact-t ties)
    ref_tri = np.asarray(href.tri)
    bvh_tri = np.asarray(hbvh.tri)
    hit = ref_tri >= 0
    inv = tree.order  # geom[new] = packed[order[new]] -> old id = order[new]
    mapped = np.where(bvh_tri >= 0, inv[np.maximum(bvh_tri, 0)], -1)
    agree = (mapped[hit] == ref_tri[hit]).mean()
    assert agree > 0.99


def test_bvh_occluded_matches_brute():
    packed = _scene(3)
    geom_b = mesh.to_device(packed)
    geom, tree_dev, _ = _build(packed, leaf_size=16)
    org, d = _rays(4, 256)
    tn = jnp.full((256,), 1e-4)
    # finite tfar exercises the range clamp
    tf = jnp.full((256,), 12.0)
    oref = intersect.occluded_brute(geom_b, org, d, tn, tf, block=64)
    obvh = traverse.occluded_bvh(geom, tree_dev, org, d, tn, tf, leaf_size=16)
    np.testing.assert_array_equal(np.asarray(oref), np.asarray(obvh))


def test_bvh_big_leaf_sizes():
    packed = _scene(5)
    geom_b = mesh.to_device(packed)
    org, d = _rays(6, 128)
    tn = jnp.full((128,), 1e-4)
    tf = jnp.full((128,), jnp.inf)
    href = intersect.intersect_brute(geom_b, org, d, tn, tf, block=64)
    for leaf in (4, 64, 256):
        geom, tree_dev, _ = _build(packed, leaf_size=leaf)
        h = traverse.intersect_bvh(geom, tree_dev, org, d, tn, tf,
                                   leaf_size=leaf)
        assert (np.isfinite(np.asarray(href.t))
                == np.isfinite(np.asarray(h.t))).all()
        np.testing.assert_allclose(
            np.where(np.isfinite(np.asarray(href.t)), np.asarray(href.t), 0),
            np.where(np.isfinite(np.asarray(h.t)), np.asarray(h.t), 0),
            rtol=2e-4, atol=1e-5)


def test_native_builder_matches_numpy():
    from yulio_raytracer.geometry import bvh as gb
    packed = _scene(7)
    nat = gb.build_native(packed.v0, packed.e1, packed.e2, packed.valid,
                          leaf_size=8)
    if nat is None:
        import pytest
        pytest.skip("native library not built")
    # structural invariants match the numpy builder's
    assert nat.skip[0] == nat.num_nodes
    assert (nat.skip > np.arange(nat.num_nodes)).all()
    assert nat.count[nat.count > 0].sum() == packed.valid.sum()
    assert len(np.unique(nat.order)) == len(nat.order)
    # and traversal produces identical hits
    geom_b = mesh.to_device(packed)
    org, d = _rays(8, 256)
    tn = jnp.full((256,), 1e-4)
    tf = jnp.full((256,), jnp.inf)
    href = intersect.intersect_brute(geom_b, org, d, tn, tf, block=64)
    host = {k: getattr(packed, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id', 'cull',
        'illum_mask', 'shadow_mask', 'valid')}
    host = bvh.permute_geom(host, nat.order)
    geom = {k: jnp.asarray(v) for k, v in host.items()}
    h = traverse.intersect_bvh(geom, bvh.to_device(nat), org, d, tn, tf,
                               leaf_size=8)
    assert (np.isfinite(np.asarray(href.t))
            == np.isfinite(np.asarray(h.t))).all()
    np.testing.assert_allclose(
        np.where(np.isfinite(np.asarray(href.t)), np.asarray(href.t), 0),
        np.where(np.isfinite(np.asarray(h.t)), np.asarray(h.t), 0),
        rtol=2e-4, atol=1e-5)


def test_native_builder_speed():
    from yulio_raytracer.geometry import bvh as gb
    import time
    if gb._load_native() is None:
        import pytest
        pytest.skip("native library not built")
    rs = np.random.RandomState(0)
    n = 200_000
    v0 = rs.randn(n, 3).astype(np.float32) * 100
    e1 = rs.randn(n, 3).astype(np.float32)
    e2 = rs.randn(n, 3).astype(np.float32)
    valid = np.ones(n, bool)
    t0 = time.perf_counter()
    tree = gb.build_native(v0, e1, e2, valid, leaf_size=64)
    dt = time.perf_counter() - t0
    assert tree is not None
    assert dt < 5.0  # 200k tris in seconds, not minutes
