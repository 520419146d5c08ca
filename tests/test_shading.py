import numpy as np
import jax
import jax.numpy as jnp

from yulio_raytracer.shading import lobes as lb
from yulio_raytracer.shading import materials as mt
from yulio_raytracer.shading import textures as tx
from yulio_raytracer.core import rng

# jit the kernels under test: eagerly these graphs are hundreds of
# individually-dispatched ops (~4 s per call on the 1-core CI box); one
# jitted call hits the persistent compile cache and runs in microseconds
_sample_lobes = jax.jit(lb.sample_lobes,
                        static_argnames=('type_mask', 'types_present'))
_eval_lobes = jax.jit(lb.eval_lobes, static_argnames=('type_mask',))
_shade_context = jax.jit(mt.shade_context)


def _ctx(mats, mat_ids, st=None, tex_builder=None, medium_eta=None):
    table = mt.build_table(mats)
    textable = (tex_builder or tx.TextureTableBuilder()).build()
    n = len(mat_ids)
    st = jnp.zeros((n, 2)) if st is None else st
    me = jnp.ones((n,)) if medium_eta is None else medium_eta
    mtr = jnp.ones((n, 3))
    return _shade_context(table, textable, jnp.asarray(mat_ids, jnp.int32),
                          st, me, mtr)


def _nswo(n):
    ns = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    wo = jnp.tile(jnp.asarray([[0.6, 0.0, 0.8]]), (n, 1))
    return ns, wo


def test_lambertian_furnace():
    """White-furnace: E[weight/pdf] over BRDF sampling == albedo."""
    n = 1 << 15
    lobed, _ = _ctx([mt.make_material('matte', {'reflectance': (0.7, 0.5, 0.3)})],
                    np.zeros(n, np.int64))
    ns, wo = _nswo(n)
    pid = jnp.arange(n, dtype=jnp.uint32)
    s2 = rng.uniform2(jnp.uint32(0), pid, jnp.uint32(0), jnp.uint32(0))
    s1 = rng.uniform1(jnp.uint32(0), pid, jnp.uint32(0), jnp.uint32(1))
    out = _sample_lobes(lobed, ns, ns, wo, s2, s1)
    est = np.asarray(out['weight'] / out['pdf'][..., None]).mean(axis=0)
    np.testing.assert_allclose(est, [0.7, 0.5, 0.3], atol=0.01)
    # all samples in upper hemisphere with cosine stats
    wi = np.asarray(out['wi'])
    assert (wi[:, 2] > 0).all()
    assert bool(np.asarray(out['valid']).all())
    assert (np.asarray(out['type_bits']) == lb.DIFFUSE_REFLECTION).all()


def test_eval_matches_lambertian_formula():
    n = 64
    lobed, _ = _ctx([mt.make_material('matte', {'reflectance': 0.8})],
                    np.zeros(n, np.int64))
    ns, wo = _nswo(n)
    rs = np.random.RandomState(0)
    wi = rs.randn(n, 3)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    f = np.asarray(_eval_lobes(lobed, ns, ns, wo, jnp.asarray(wi, jnp.float32)))
    expect = 0.8 / np.pi * np.clip(wi[:, 2], 0, 1)
    np.testing.assert_allclose(f[:, 0], expect, atol=1e-5)
    # specular lobes contribute nothing to DIFFUSE eval
    lob2, _ = _ctx([mt.make_material('mirror', {'reflectance': 1.0})],
                   np.zeros(n, np.int64))
    f2 = np.asarray(_eval_lobes(lob2, ns, ns, wo, jnp.asarray(wi, jnp.float32)))
    np.testing.assert_allclose(f2, 0.0)


def test_mirror_delta_reflection():
    n = 8
    lobed, _ = _ctx([mt.make_material('mirror', {'reflectance': (0.9, 0.9, 0.9)})],
                    np.zeros(n, np.int64))
    ns, wo = _nswo(n)
    s2 = jnp.full((n, 2), 0.5)
    s1 = jnp.full((n,), 0.5)
    out = _sample_lobes(lobed, ns, ns, wo, s2, s1)
    wi = np.asarray(out['wi'])
    np.testing.assert_allclose(wi, np.tile([[-0.6, 0.0, 0.8]], (n, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out['pdf']), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out['weight']), 0.9, atol=1e-6)


def test_glass_energy_split():
    """Fresnel reflection + transmission weights sum to ~1 (unit color)."""
    n = 1 << 12
    mats = [mt.make_material('glass', {'etaOutside': 1.0, 'etaInside': 1.5})]
    lobed, aux = _ctx(mats, np.zeros(n, np.int64))
    ns, wo = _nswo(n)
    pid = jnp.arange(n, dtype=jnp.uint32)
    s2 = rng.uniform2(jnp.uint32(1), pid, jnp.uint32(0), jnp.uint32(0))
    s1 = rng.uniform1(jnp.uint32(1), pid, jnp.uint32(0), jnp.uint32(1))
    out = _sample_lobes(lobed, ns, ns, wo, s2, s1)
    # E[w/pdf] = F + (1-F)/eta^2: the reference's refract() reports
    # pdf = eta^2 (optics.h:57 Sample3f(..., sqr(eta))), i.e. the radiance
    # compression factor of non-symmetric transport; it cancels on exit.
    cos_o = 0.8
    eta = 1.0 / 1.5
    k = 1 - eta * eta * (1 - cos_o * cos_o)
    cos_t = np.sqrt(k)
    rper = (eta * cos_o - cos_t) / (eta * cos_o + cos_t)
    rpar = (cos_o - eta * cos_t) / (cos_o + eta * cos_t)
    F = 0.5 * (rpar ** 2 + rper ** 2)
    expect = F + (1 - F) / (eta * eta)
    est = float(np.asarray(out['weight'][:, 0] / out['pdf']).mean())
    np.testing.assert_allclose(est, expect, atol=0.02)
    # sampled transmission bends downward, reflection upward
    bits = np.asarray(out['type_bits'])
    wi = np.asarray(out['wi'])
    trans = (bits & lb.TRANSMISSION_BITS) != 0
    assert trans.any() and (~trans).any()
    assert (wi[trans, 2] < 0).all()
    assert (wi[~trans, 2] > 0).all()
    # eta factor: transmission reports 1/eta_rel = 1.5
    np.testing.assert_allclose(np.asarray(out['eta'])[trans], 1.5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out['eta'])[~trans], 1.0)


def test_glass_inside_flips_eta():
    """A ray inside the glass must refract with the flipped eta ratio."""
    n = 4
    mats = [mt.make_material('glass', {'etaOutside': 1.0, 'etaInside': 1.5})]
    lobed_out, _ = _ctx(mats, np.zeros(n, np.int64))
    lobed_in, _ = _ctx(mats, np.zeros(n, np.int64),
                       medium_eta=jnp.full((n,), 1.5))
    np.testing.assert_allclose(np.asarray(lobed_out['eta'][0, :2]),
                               [1.0 / 1.5, 1.0 / 1.5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(lobed_in['eta'][0, :2]),
                               [1.5, 1.5], atol=1e-6)


def test_uber_alpha_decomposition():
    """Uber with a translucent texel: lambertian*alpha + const-trans(1-a)."""
    tb = tx.TextureTableBuilder()
    img = np.zeros((2, 2, 4), np.float32)
    img[..., :3] = (1.0, 0.5, 0.25)
    img[..., 3] = 0.5
    tid = tb.add(img)
    mats = [mt.make_material('uber', {'roughness': 0.9, 'eta': 1.4},
                             tex_id=tid)]
    n = 16
    lobed, _ = _ctx(mats, np.zeros(n, np.int64), tex_builder=tb)
    col = np.asarray(lobed['color'][0])
    types = np.asarray(lobed['type'][0])
    assert types[0] == lb.LAMBERTIAN
    np.testing.assert_allclose(col[0], [0.5, 0.25, 0.125], atol=1e-6)
    assert types[1] == lb.CONST_TRANSMIT
    np.testing.assert_allclose(col[1], 0.5, atol=1e-6)
    assert types[2] == lb.MICROFACET_DIELECTRIC
    np.testing.assert_allclose(col[2], 0.5, atol=1e-6)
    # opaque texel: const-trans lobe weight drops to zero
    img2 = np.ones((1, 1, 4), np.float32)
    tb2 = tx.TextureTableBuilder()
    tid2 = tb2.add(img2)
    mats2 = [mt.make_material('uber', {}, tex_id=tid2)]
    lobed2, _ = _ctx(mats2, np.zeros(4, np.int64), tex_builder=tb2)
    np.testing.assert_allclose(np.asarray(lobed2['color'][0, 1]), 0.0,
                               atol=1e-6)


def test_composited_pick_proportional_to_luminance():
    """Two-lobe material (velvet): picks are luminance/pdf-weighted
    (compositedbrdf.h:150)."""
    n = 1 << 14
    mats = [mt.make_material('velvet', {
        'reflectance': (0.8, 0.8, 0.8), 'backScattering': 0.0,
        'horizonScatteringColor': (0.2, 0.2, 0.2),
        'horizonScatteringFallOff': 0.0})]
    lobed, _ = _ctx(mats, np.zeros(n, np.int64))
    ns, wo = _nswo(n)
    pid = jnp.arange(n, dtype=jnp.uint32)
    s2 = rng.uniform2(jnp.uint32(2), pid, jnp.uint32(0), jnp.uint32(0))
    s1 = rng.uniform1(jnp.uint32(2), pid, jnp.uint32(0), jnp.uint32(1))
    out = _sample_lobes(lobed, ns, ns, wo, s2, s1)
    # minnaert with b=0 == lambertian(0.8); velvety f=0 == lambertian(0.2)
    # both cosine-sampled -> same pdf; pick ratio == 0.8 : 0.2*sinO-factor...
    # with f=0 the sinO^0 = 1, so exactly 0.8 : 0.2
    w = np.asarray(out['weight'])[:, 0]
    frac_big = (w > 0.5 / np.pi * np.asarray(out['wi'])[:, 2]).mean()
    np.testing.assert_allclose(frac_big, 0.8, atol=0.02)


def test_textures_bilinear_and_nearest():
    tb = tx.TextureTableBuilder()
    img = np.zeros((2, 2, 4), np.float32)
    img[0, 0] = (1, 0, 0, 1)
    img[0, 1] = (0, 1, 0, 1)
    img[1, 0] = (0, 0, 1, 1)
    img[1, 1] = (1, 1, 1, 1)
    t_bi = tb.add(img, tx.FILTER_BILINEAR)
    t_nn = tb.add(img, tx.FILTER_NEAREST)
    t_inv = tb.add(img, tx.FILTER_NEAREST, invert=True)
    table = tb.build()
    # center of texel (0,0) in uv space = (0.25, 0.25)
    uv = jnp.asarray([[0.25, 0.25]])
    c = np.asarray(tx.fetch(table, jnp.asarray([t_bi]), uv))
    np.testing.assert_allclose(c[0, :3], [1, 0, 0], atol=1e-6)
    # dead center: bilinear average of all four
    c2 = np.asarray(tx.fetch(table, jnp.asarray([t_bi]),
                             jnp.asarray([[0.5, 0.5]])))
    np.testing.assert_allclose(c2[0, :3], [0.5, 0.5, 0.5], atol=1e-6)
    # nearest picks the texel containing the point
    c3 = np.asarray(tx.fetch(table, jnp.asarray([t_nn]),
                             jnp.asarray([[0.7, 0.2]])))
    np.testing.assert_allclose(c3[0, :3], [0, 1, 0], atol=1e-6)
    # invert flag
    c4 = np.asarray(tx.fetch(table, jnp.asarray([t_inv]),
                             jnp.asarray([[0.2, 0.2]])))
    np.testing.assert_allclose(c4[0, :3], [0, 1, 1], atol=1e-6)
    # wrap: uv + 1 identical
    c5 = np.asarray(tx.fetch(table, jnp.asarray([t_bi]),
                             jnp.asarray([[1.25, -0.75]])))
    np.testing.assert_allclose(c5, c, atol=1e-6)
    # missing texture -> white
    c6 = np.asarray(tx.fetch(table, jnp.asarray([-1]), uv))
    np.testing.assert_allclose(c6, 1.0)


def test_phong_specular_normalization():
    """Specular (obj Ks/Ns) furnace: E[weight/pdf] ~= Ks * (exp+2)/(exp+1)
    * <cos>/... just check energy <= Ks and sampling validity."""
    n = 1 << 14
    mats = [mt.make_material('obj', {'Kd': (0, 0, 0), 'Ks': (0.5, 0.5, 0.5),
                                     'Ns': 32.0})]
    lobed, _ = _ctx(mats, np.zeros(n, np.int64))
    ns, wo = _nswo(n)
    pid = jnp.arange(n, dtype=jnp.uint32)
    s2 = rng.uniform2(jnp.uint32(3), pid, jnp.uint32(0), jnp.uint32(0))
    s1 = rng.uniform1(jnp.uint32(3), pid, jnp.uint32(0), jnp.uint32(1))
    out = _sample_lobes(lobed, ns, ns, wo, s2, s1)
    valid = np.asarray(out['valid'])
    w = np.asarray(out['weight'])[valid]
    p = np.asarray(out['pdf'])[valid]
    est = (w[:, 0] / p).mean() * valid.mean()
    assert 0.3 < est <= 0.55  # energy-conserving, near Ks=0.5


def test_has_type():
    lobed, _ = _ctx([mt.make_material('uber', {})], np.zeros(2, np.int64))
    assert bool(lb.has_type(lobed, lb.DIFFUSE).all())
    lob2, _ = _ctx([mt.make_material('mirror', {})], np.zeros(2, np.int64))
    assert not bool(lb.has_type(lob2, lb.DIFFUSE).any())
    assert bool(lb.has_type(lob2, lb.SPECULAR).all())


def test_bump_mapping_perturbs_normal():
    """Obj map_Bump (obj.h:51-56): a flat bump (0.5,0.5,1) keeps Ns; a
    tilted bump rotates it toward the tangent."""
    import jax.numpy as jnp
    tb = tx.TextureTableBuilder()
    flat = np.full((2, 2, 4), 0.5, np.float32)
    flat[..., 2] = 1.0
    tilt = np.array(flat, copy=True)
    tilt[..., 0] = 1.0     # b.x = +1 -> lean into Tx
    t_flat = tb.add(flat, tx.FILTER_NEAREST)
    t_tilt = tb.add(tilt, tx.FILTER_NEAREST)
    m_flat = mt.make_material('obj', {'Kd': (0.5,) * 3},
                              tex_ids={'map_Bump': t_flat})
    m_tilt = mt.make_material('obj', {'Kd': (0.5,) * 3},
                              tex_ids={'map_Bump': t_tilt})
    table = mt.build_table([m_flat, m_tilt])
    textable = tb.build()
    n = 4
    ns = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    txv = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (n, 1))
    tyv = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    st = jnp.full((n, 2), 0.25)
    me = jnp.ones((n,))
    mtr = jnp.ones((n, 3))
    _, aux0 = mt.shade_context(table, textable,
                               jnp.zeros((n,), jnp.int32), st, me, mtr,
                               ns=ns, tx=txv, ty=tyv)
    np.testing.assert_allclose(np.asarray(aux0['ns']), np.asarray(ns),
                               atol=1e-6)
    _, aux1 = mt.shade_context(table, textable,
                               jnp.ones((n,), jnp.int32), st, me, mtr,
                               ns=ns, tx=txv, ty=tyv)
    pert = np.asarray(aux1['ns'][0])
    np.testing.assert_allclose(pert, [1 / np.sqrt(2), 0, 1 / np.sqrt(2)],
                               atol=1e-5)


def test_brushed_metal_anisotropy():
    """BrushedMetal: reflected lobes spread differently along Tx vs Ty."""
    import jax.numpy as jnp
    n = 1 << 13
    mats = [mt.make_material('brushedmetal', {
        'reflectance': (1.0, 1.0, 1.0), 'eta': (1.4,) * 3, 'k': (3.0,) * 3,
        'roughnessX': 0.5, 'roughnessY': 0.01})]
    lobed, _ = _ctx(mats, np.zeros(n, np.int64))
    ns = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    wo = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))  # normal view
    txv = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (n, 1))
    tyv = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    pid = jnp.arange(n, dtype=jnp.uint32)
    s2 = rng.uniform2(jnp.uint32(5), pid, jnp.uint32(0), jnp.uint32(0))
    s1 = rng.uniform1(jnp.uint32(5), pid, jnp.uint32(0), jnp.uint32(1))
    out = _sample_lobes(lobed, ns, ns, wo, s2, s1, tx=txv, ty=tyv)
    wi = np.asarray(out['wi'])
    ok = np.asarray(out['valid']) & (np.asarray(out['pdf']) > 0)
    wi = wi[ok]
    # rough along x (nx small) -> wide x-spread; smooth along y -> narrow
    assert wi[:, 0].std() > 3.0 * wi[:, 1].std()
    # energy sane
    w = np.asarray(out['weight'])[ok][:, 0]
    p = np.asarray(out['pdf'])[ok]
    est = (w / p).mean() * ok.mean()
    assert 0.2 < est <= 1.05
