"""Material presets -> lobe tables (the shade() stage as data).

Each of the reference's 14 material classes builds its CompositedBRDF in
`shade()` from per-hit texture fetches (`materials/*.h`).  Here that logic
is split into:

* a host-side *compiler* (`make_material`) that turns (type, params) into
  up to MAX_LOBES static lobe records + texture bindings, and
* a device-side *context builder* (`shade_context`) that gathers each hit's
  material row, fetches its texels, applies the per-lobe texture mode, and
  resolves medium-dependent IORs — producing the clean lobe arrays that
  shading/lobes.py consumes.

Texture modes encode the data-dependent parts of the reference shaders
(e.g. Uber's alpha decomposition, materials/Uber.h:34-68): the *structure*
of each material's lobe list is static, the *weights* depend on the texel —
zero-weight lobes drop out of sampling exactly like un-added BRDFs.

Material registry parity: singleray_device.cpp:262-280 (Matte, Plastic,
Dielectric/Glass, ThinDielectric/ThinGlass, Mirror, Metal, BrushedMetal,
MetallicPaint, MatteTextured, Uber, Obj, Velvet).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from . import lobes as lb
from . import textures as gtex

MAX_LOBES = 4

# texture modes (applied to lobe color at shade time)
TEX_NONE = 0          # color = base * cscale
TEX_UBER_DIFFUSE = 1  # color = (tex? tex.rgb : base) * tex.a
TEX_UBER_OPACITY = 2  # color = (1 - tex.a) * ones
TEX_UBER_ALPHA = 3    # color = base * tex.a
TEX_MUL_RGB = 4       # color = base * tex.rgb * cscale
TEX_REPLACE_RGB = 5   # color = (tex? tex.rgb : base) * cscale
TEX_OBJ_OPACITY = 6   # color = ones * (1 - cscale * tex.r)


@dataclass
class LobeSpec:
    type: int = lb.NONE
    color: tuple = (0.0, 0.0, 0.0)
    cscale: float = 1.0
    eta: float = 1.0
    exp: float = 0.0
    ceta: tuple = (1.0, 1.0, 1.0)
    ck: tuple = (0.0, 0.0, 0.0)
    tex: int = -1
    texmode: int = TEX_NONE
    medium_sensitive: bool = False


@dataclass
class MaterialSpec:
    lobes: list          # list[LobeSpec], len <= MAX_LOBES
    s0: tuple = (0.0, 0.0)
    ds: tuple = (1.0, 1.0)
    bump_tex: int = -1   # map_Bump (obj.h:51-56)
    is_media_interface: bool = False
    medium_out_eta: float = 1.0
    medium_in_eta: float = 1.0
    medium_out_trans: tuple = (1.0, 1.0, 1.0)
    medium_in_trans: tuple = (1.0, 1.0, 1.0)


def _c3(v, default=(1.0, 1.0, 1.0)):
    if v is None:
        return tuple(float(x) for x in default)
    if np.isscalar(v):
        return (float(v),) * 3
    return tuple(float(x) for x in v)


def make_material(mtype: str, p: dict, tex_id: int = -1,
                  tex_ids: dict | None = None) -> MaterialSpec:
    """Compile a material. `p` holds reference parameter names; `tex_id` is
    the bound Kd texture (or -1); `tex_ids` optional extra maps for Obj."""
    t = mtype.lower()
    tex_ids = tex_ids or {}
    s0 = tuple(p.get('s0', (0.0, 0.0)))
    ds = tuple(p.get('ds', (1.0, 1.0)))

    if t == 'matte':
        # matte.h: Lambertian(reflectance)
        return MaterialSpec([LobeSpec(lb.LAMBERTIAN,
                                      _c3(p.get('reflectance')))],
                            s0=s0, ds=ds)

    if t == 'mattetextured':
        # matte_textured.h: Lambertian(Kd->get(ds*st+s0)) (only if textured)
        return MaterialSpec([LobeSpec(lb.LAMBERTIAN, (1.0, 1.0, 1.0),
                                      tex=tex_id, texmode=TEX_MUL_RGB)],
                            s0=s0, ds=ds)

    if t == 'plastic':
        # plastic.h: DielectricLayer<Lambertian>(1,1,eta, Lam(pigment))
        # + DielectricReflection(1,eta) [rough==0] | MicrofacetPlastic
        eta = float(p.get('eta', 1.4))
        rough = float(p.get('roughness', 0.01))
        out = [LobeSpec(lb.DIELECTRIC_LAYER_LAMB, _c3(p.get('pigmentColor')),
                        eta=1.0 / eta)]
        if rough == 0.0:
            out.append(LobeSpec(lb.DIELECTRIC_REFLECT, (1.0, 1.0, 1.0),
                                eta=1.0 / eta))
        else:
            out.append(LobeSpec(lb.MICROFACET_DIELECTRIC, (1.0, 1.0, 1.0),
                                eta=1.0 / eta, exp=1.0 / rough))
        return MaterialSpec(out, s0=s0, ds=ds)

    if t in ('dielectric', 'glass'):
        # dielectric.h: medium-dependent reflection+transmission pair
        eta_o = float(p.get('etaOutside', 1.0))
        eta_i = float(p.get('etaInside', 1.4))
        return MaterialSpec(
            [LobeSpec(lb.DIELECTRIC_REFLECT, (1.0, 1.0, 1.0),
                      eta=eta_o / eta_i, medium_sensitive=True),
             LobeSpec(lb.DIELECTRIC_TRANSMIT, (1.0, 1.0, 1.0),
                      eta=eta_o / eta_i, medium_sensitive=True)],
            s0=s0, ds=ds, is_media_interface=True,
            medium_out_eta=eta_o, medium_in_eta=eta_i,
            medium_out_trans=_c3(p.get('transmissionOutside')),
            medium_in_trans=_c3(p.get('transmission')))

    if t in ('thindielectric', 'thinglass'):
        # thindielectric.h: DielectricReflection(1,eta) +
        # ThinDielectricTransmission(1, eta, (Kd|transmission)*transparency,
        # thickness)
        eta = float(p.get('eta', 1.4))
        return MaterialSpec(
            [LobeSpec(lb.DIELECTRIC_REFLECT, (1.0, 1.0, 1.0), eta=1.0 / eta),
             LobeSpec(lb.THIN_DIELECTRIC_TRANSMIT,
                      _c3(p.get('transmission')),
                      cscale=float(p.get('transparency', 1.0)),
                      eta=1.0 / eta, exp=float(p.get('thickness', 0.1)),
                      tex=tex_id, texmode=TEX_REPLACE_RGB)],
            s0=s0, ds=ds)

    if t == 'mirror':
        # mirror.h: Reflection(reflectance)
        return MaterialSpec([LobeSpec(lb.SPECULAR_REFLECT,
                                      _c3(p.get('reflectance')))],
                            s0=s0, ds=ds)

    if t == 'metal':
        # metal.h: Conductor [rough==0] | MicrofacetMetal
        refl = _c3(p.get('reflectance'))
        ceta = _c3(p.get('eta'), (1.4, 1.4, 1.4))
        ck = _c3(p.get('k'), (0.0, 0.0, 0.0))
        rough = float(p.get('roughness', 0.01))
        if rough == 0.0:
            return MaterialSpec([LobeSpec(lb.CONDUCTOR, refl,
                                          ceta=ceta, ck=ck)], s0=s0, ds=ds)
        return MaterialSpec([LobeSpec(lb.MICROFACET_CONDUCTOR, refl,
                                      ceta=ceta, ck=ck, exp=1.0 / rough)],
                            s0=s0, ds=ds)

    if t == 'brushedmetal':
        # brushedmetal.h: Conductor [either roughness==0] |
        # Microfacet<FresnelConductor, AnisotropicPowerCosine(1/rx, 1/ry)>
        refl = _c3(p.get('reflectance'))
        ceta = _c3(p.get('eta'), (1.4, 1.4, 1.4))
        ck = _c3(p.get('k'), (0.0, 0.0, 0.0))
        rx = float(p.get('roughnessX', 0.01))
        ry = float(p.get('roughnessY', 0.01))
        if rx == 0.0 or ry == 0.0:
            return MaterialSpec([LobeSpec(lb.CONDUCTOR, refl,
                                          ceta=ceta, ck=ck)], s0=s0, ds=ds)
        # exp = nx, eta = ny (the aniso lobe's second exponent)
        return MaterialSpec([LobeSpec(lb.MICROFACET_CONDUCTOR_ANISO, refl,
                                      ceta=ceta, ck=ck, exp=1.0 / rx,
                                      eta=1.0 / ry)], s0=s0, ds=ds)

    if t == 'metallicpaint':
        # metallicpaint.h: DielectricReflection(1,eta) +
        # DielectricLayer<Lambertian(shadeColor)> (+ glitter layer folded
        # into a microfacet-conductor approximation when enabled)
        eta = float(p.get('eta', 1.4))
        out = [LobeSpec(lb.DIELECTRIC_REFLECT, (1.0, 1.0, 1.0),
                        eta=1.0 / eta),
               LobeSpec(lb.DIELECTRIC_LAYER_LAMB, _c3(p.get('shadeColor')),
                        eta=1.0 / eta)]
        glitter = _c3(p.get('glitterColor'), (0, 0, 0))
        spread = float(p.get('glitterSpread', 1.0))
        if spread != 0 and any(g != 0 for g in glitter):
            # aluminium flakes under the paint's dielectric layer
            # (metallicpaint.h:37-40); eta != 1 marks the layered conductor
            out.append(LobeSpec(lb.MICROFACET_CONDUCTOR, glitter,
                                ceta=(0.62, 0.62, 0.62), ck=(4.8, 4.8, 4.8),
                                exp=1.0 / spread, eta=1.0 / eta))
        return MaterialSpec(out, s0=s0, ds=ds)

    if t == 'uber':
        # Uber.h:34-68 (Yulio): Lambertian(diffuse*alpha)
        # + ConstDielectricTransmission(1-alpha) [alpha<1]
        # + DielectricReflection(1, eta, alpha*reflectivity) [refl>0]
        #   | DielectricReflection(1, eta, alpha) [roughness==0]
        #   | Microfacet<FresnelDielectric, PowerCosine(1/roughness)>(alpha)
        eta = float(p.get('eta', 1.4))
        rough = float(p.get('roughness', 0.9))
        refl = float(p.get('reflectivity', 0.0))
        out = [LobeSpec(lb.LAMBERTIAN, _c3(p.get('diffuse'), (0, 0, 0)),
                        tex=tex_id, texmode=TEX_UBER_DIFFUSE),
               LobeSpec(lb.CONST_TRANSMIT, (1.0, 1.0, 1.0),
                        tex=tex_id, texmode=TEX_UBER_OPACITY)]
        if refl > 0.0:
            out.append(LobeSpec(lb.DIELECTRIC_REFLECT,
                                (refl, refl, refl), eta=1.0 / eta,
                                tex=tex_id, texmode=TEX_UBER_ALPHA))
        elif rough == 0.0:
            out.append(LobeSpec(lb.DIELECTRIC_REFLECT, (1.0, 1.0, 1.0),
                                eta=1.0 / eta,
                                tex=tex_id, texmode=TEX_UBER_ALPHA))
        else:
            out.append(LobeSpec(lb.MICROFACET_DIELECTRIC, (1.0, 1.0, 1.0),
                                eta=1.0 / eta, exp=1.0 / rough,
                                tex=tex_id, texmode=TEX_UBER_ALPHA))
        return MaterialSpec(out, s0=s0, ds=ds)

    if t == 'obj':
        # obj.h: Transmission(1-d) [d<1] + Lambertian(d*Kd*map_Kd)
        # + Specular(d*Ks, Ns) (bump mapping not yet applied)
        d = float(p.get('d', 1.0))
        kd = _c3(p.get('Kd'))
        ks = _c3(p.get('Ks'), (0, 0, 0))
        ns = float(p.get('Ns', 10.0))
        map_kd = tex_ids.get('map_Kd', tex_id)
        map_d = tex_ids.get('map_d', -1)
        out = []
        if d < 1.0 or map_d >= 0:
            out.append(LobeSpec(lb.TRANSMISSION, (1.0, 1.0, 1.0), cscale=d,
                                tex=map_d, texmode=TEX_OBJ_OPACITY))
        out.append(LobeSpec(lb.LAMBERTIAN,
                            tuple(d * c for c in kd),
                            tex=map_kd, texmode=TEX_MUL_RGB))
        if any(c != 0 for c in ks):
            out.append(LobeSpec(lb.SPECULAR_PHONG,
                                tuple(d * c for c in ks), exp=ns,
                                tex=tex_ids.get('map_Ks', -1),
                                texmode=TEX_MUL_RGB))
        return MaterialSpec(out, s0=s0, ds=ds,
                            bump_tex=tex_ids.get('map_Bump', -1))

    if t == 'velvet':
        # velvet.h: Minnaert(reflectance, backScattering)
        # + Velvety(horizonScatteringColor, horizonScatteringFallOff)
        return MaterialSpec(
            [LobeSpec(lb.MINNAERT, _c3(p.get('reflectance')),
                      exp=float(p.get('backScattering', 0.0))),
             LobeSpec(lb.VELVETY, _c3(p.get('horizonScatteringColor')),
                      exp=float(p.get('horizonScatteringFallOff', 0.0)))],
            s0=s0, ds=ds)

    raise ValueError(f"unknown material type: {mtype}")


# ===========================================================================
# device table
# ===========================================================================

def build_table(mats: list[MaterialSpec]) -> dict:
    """Stack MaterialSpecs into the device material table."""
    if not mats:
        mats = [make_material('matte', {})]
    m = len(mats)
    l = MAX_LOBES
    out = {
        'lobe_type': np.zeros((m, l), np.int32),
        'lobe_color': np.zeros((m, l, 3), np.float32),
        'lobe_cscale': np.ones((m, l), np.float32),
        'lobe_eta': np.ones((m, l), np.float32),
        'lobe_exp': np.zeros((m, l), np.float32),
        'lobe_ceta': np.ones((m, l, 3), np.float32),
        'lobe_ck': np.zeros((m, l, 3), np.float32),
        'lobe_tex': np.full((m, l), -1, np.int32),
        'lobe_texmode': np.zeros((m, l), np.int32),
        'lobe_medium': np.zeros((m, l), np.int32),
        's0': np.zeros((m, 2), np.float32),
        'ds': np.ones((m, 2), np.float32),
        'media': np.zeros((m,), np.int32),
        'medium_out_eta': np.ones((m,), np.float32),
        'medium_in_eta': np.ones((m,), np.float32),
        'medium_out_trans': np.ones((m, 3), np.float32),
        'medium_in_trans': np.ones((m, 3), np.float32),
    }
    for i, ms in enumerate(mats):
        assert len(ms.lobes) <= l, "material exceeds MAX_LOBES"
        for j, lo in enumerate(ms.lobes):
            out['lobe_type'][i, j] = lo.type
            out['lobe_color'][i, j] = lo.color
            out['lobe_cscale'][i, j] = lo.cscale
            out['lobe_eta'][i, j] = lo.eta
            out['lobe_exp'][i, j] = lo.exp
            out['lobe_ceta'][i, j] = lo.ceta
            out['lobe_ck'][i, j] = lo.ck
            out['lobe_tex'][i, j] = lo.tex
            out['lobe_texmode'][i, j] = lo.texmode
            out['lobe_medium'][i, j] = int(lo.medium_sensitive)
        out['s0'][i] = ms.s0
        out['ds'][i] = ms.ds
        out['media'][i] = int(ms.is_media_interface)
        out['medium_out_eta'][i] = ms.medium_out_eta
        out['medium_in_eta'][i] = ms.medium_in_eta
        out['medium_out_trans'][i] = ms.medium_out_trans
        out['medium_in_trans'][i] = ms.medium_in_trans
    table = {k: jnp.asarray(v) for k, v in out.items()}
    # fused (M, K) f32 matrix so per-hit material lookup is ONE row
    # gather; assembled in numpy — a device concatenate here would be a
    # fresh tiny-op compile per commit
    table['mat_tab'] = jnp.asarray(np.concatenate([
        out['lobe_type'].astype(np.float32),                  # 0:4
        out['lobe_color'].reshape(m, 12).astype(np.float32),  # 4:16
        out['lobe_cscale'].astype(np.float32),                # 16:20
        out['lobe_eta'].astype(np.float32),                   # 20:24
        out['lobe_exp'].astype(np.float32),                   # 24:28
        out['lobe_ceta'].reshape(m, 12).astype(np.float32),   # 28:40
        out['lobe_ck'].reshape(m, 12).astype(np.float32),     # 40:52
        out['lobe_tex'].astype(np.float32),                   # 52:56
        out['lobe_texmode'].astype(np.float32),               # 56:60
        out['lobe_medium'].astype(np.float32),                # 60:64
        out['s0'].astype(np.float32),                         # 64:66
        out['ds'].astype(np.float32),                         # 66:68
        out['media'].astype(np.float32)[:, None],             # 68
        out['medium_out_eta'].astype(np.float32)[:, None],    # 69
        out['medium_in_eta'].astype(np.float32)[:, None],     # 70
        out['medium_out_trans'].astype(np.float32),           # 71:74
        out['medium_in_trans'].astype(np.float32),            # 74:77
        np.asarray([ms.bump_tex for ms in mats],
                   np.float32)[:, None],                      # 77
    ], axis=1))
    return table


def shade_context(table: dict, textable: dict, mat_id, st,
                  medium_eta, medium_trans, ns=None, tx=None, ty=None):
    """Build per-hit lobe arrays for lobes.eval/sample.

    mat_id: (R,) i32; st: (R, 2); medium_eta: (R,), medium_trans: (R, 3)
    (the ray's current medium, for glass direction resolution).  When
    ns/tx/ty are given and a material binds a bump map, aux['ns'] holds
    the perturbed shading normal (obj.h:51-56).
    Returns (lobes dict with (R, L[,3]) arrays, aux dict).
    """
    mid = jnp.maximum(mat_id, 0)
    r = mid.shape[0]
    tab = table['mat_tab'][mid]                     # (R, 77), one gather
    ltype = jnp.round(tab[:, 0:4]).astype(jnp.int32)
    base = tab[:, 4:16].reshape(r, 4, 3)
    cscale = tab[:, 16:20][..., None]
    eta0 = tab[:, 20:24]
    exp_ = tab[:, 24:28]
    ceta = tab[:, 28:40].reshape(r, 4, 3)
    ck = tab[:, 40:52].reshape(r, 4, 3)
    tex_id = jnp.round(tab[:, 52:56]).astype(jnp.int32)
    mode = jnp.round(tab[:, 56:60]).astype(jnp.int32)
    lobe_medium = jnp.round(tab[:, 60:64]).astype(jnp.int32)
    s0 = tab[:, 64:66]
    ds = tab[:, 66:68]
    media = tab[:, 68]
    out_eta = tab[:, 69]
    in_eta = tab[:, 70]
    out_trans = tab[:, 71:74]
    in_trans = tab[:, 74:77]

    uv = ds * st + s0                               # (R, 2)
    if textable['data'].shape[0] <= 1:
        # textureless scene (only the 1x1 white fallback exists): the
        # fetch would be pure gather overhead
        texel = jnp.ones(tex_id.shape + (4,))
    else:
        texel = jnp.where((tex_id >= 0)[..., None],
                          jnp_fetch(textable, tex_id, uv),
                          jnp.asarray([1.0, 1.0, 1.0, 1.0]))
    rgb = texel[..., :3]
    a = texel[..., 3:4]
    has_tex = (tex_id >= 0)[..., None]

    color = jnp.where(
        (mode == TEX_UBER_DIFFUSE)[..., None],
        jnp.where(has_tex, rgb, base) * a,
        jnp.where((mode == TEX_UBER_OPACITY)[..., None],
                  1.0 - a,
        jnp.where((mode == TEX_UBER_ALPHA)[..., None],
                  base * a,
        jnp.where((mode == TEX_MUL_RGB)[..., None],
                  base * rgb * cscale,
        jnp.where((mode == TEX_REPLACE_RGB)[..., None],
                  jnp.where(has_tex, rgb, base) * cscale,
        jnp.where((mode == TEX_OBJ_OPACITY)[..., None],
                  1.0 - cscale * texel[..., 0:1],
                  base * cscale))))))

    # medium-sensitive relative IOR (dielectric.h:59-66): the lobe's stored
    # eta is the outside->inside ratio; flip it when the ray currently
    # travels in the inside medium
    inside = (jnp.abs(medium_eta - in_eta) < 1e-6) & jnp.all(
        jnp.abs(medium_trans - in_trans) < 1e-6, axis=-1)
    eta = jnp.where((lobe_medium != 0) & inside[..., None],
                    1.0 / jnp.maximum(eta0, 1e-6), eta0)

    lobed = {
        'type': ltype,
        'color': color,
        'eta': eta,
        'exp': exp_,
        'ceta': ceta,
        'ck': ck,
    }
    aux = {
        'is_media_interface': media != 0,
        'medium_out_eta': out_eta,
        'medium_in_eta': in_eta,
        'medium_out_trans': out_trans,
        'medium_in_trans': in_trans,
        'inside': inside,
    }

    # bump mapping (obj.h:51-56): Ns' = normalize(b.x Tx + b.y Ty + b.z Ns)
    # with b = 2*bump.rgb - 1
    bump_tex = jnp.round(tab[:, 77]).astype(jnp.int32)
    if ns is not None and tx is not None and textable['data'].shape[0] > 1:
        bump = gtex.fetch(textable, jnp.maximum(bump_tex, 0), uv)
        b = 2.0 * bump[:, :3] - 1.0
        ns_pert = (b[:, 0:1] * tx + b[:, 1:2] * ty + b[:, 2:3] * ns)
        nl = jnp.sqrt(jnp.maximum(
            jnp.sum(ns_pert * ns_pert, axis=-1, keepdims=True), 1e-20))
        ns_pert = ns_pert / nl
        aux['ns'] = jnp.where((bump_tex >= 0)[:, None], ns_pert, ns)
    return lobed, aux


def jnp_fetch(textable, tid, uv):
    """Per-lobe texture fetch: tid (R, L), uv (R, 2) -> (R, L, 4)."""
    uvl = jnp.broadcast_to(uv[..., None, :], tid.shape + (2,))
    return gtex.fetch(textable, tid, uvl)


def next_medium(aux, sampled_transmission_bit, medium_eta, medium_trans):
    """Medium tracking (material.h:49-52 + pathtraceintegrator.cpp:203-206):
    on a sampled TRANSMISSION component at a media interface, switch to the
    other medium."""
    switch = aux['is_media_interface'] & sampled_transmission_bit
    new_eta = jnp.where(aux['inside'], aux['medium_out_eta'],
                        aux['medium_in_eta'])
    new_trans = jnp.where(aux['inside'][..., None], aux['medium_out_trans'],
                          aux['medium_in_trans'])
    eta = jnp.where(switch, new_eta, medium_eta)
    trans = jnp.where(switch[..., None], new_trans, medium_trans)
    return eta, trans
