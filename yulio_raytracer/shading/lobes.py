"""Lobe-table BSDFs: the reference's CompositedBRDF as masked tensor ops.

The reference shades by placement-new'ing up to 8 virtual BRDF objects per
hit (`brdfs/compositedbrdf.h`), then luminance-weighting one for GI
(`compositedbrdf.h:119-181`).  Here virtual dispatch becomes a *static
lobe table*: every material compiles to at most `MAX_LOBES` lobe records
(type id + parameters), and shading evaluates all lobe *families* for every
(ray, slot) lane with masked selects — dense, divergence-free work.

Lobe types cover every concrete BRDF the 14 material presets instantiate
(`brdfs/{lambertian,specular,dielectric,dielectriclayer,conductor,
transmission,reflection,minnaert,velvety,microfacet}.h`).  Formulas and pdf
conventions are bit-faithful to the reference (cited per branch below).

A lobe record (arrays shaped (..., L) or (..., L, 3)):
  type   i32  lobe id (NONE=0 slots are dead lanes)
  color  f32x3  reflectance/transmittance scale
  eta    f32  relative IOR etai/etat (reference convention)
  exp    f32  exponent (microfacet/phong n, minnaert b, velvety falloff,
              thin-dielectric thickness)
  ceta   f32x3  conductor complex IOR (real)
  ck     f32x3  conductor complex IOR (imag)
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import math as vm
from ..sampling import shapesampler as ss

# ---------------------------------------------------------------- lobe ids
NONE = 0
LAMBERTIAN = 1
MINNAERT = 2
VELVETY = 3
DIELECTRIC_LAYER_LAMB = 4
SPECULAR_REFLECT = 5
DIELECTRIC_REFLECT = 6
CONDUCTOR = 7
DIELECTRIC_TRANSMIT = 8
THIN_DIELECTRIC_TRANSMIT = 9
CONST_TRANSMIT = 10
TRANSMISSION = 11
MICROFACET_DIELECTRIC = 12
MICROFACET_CONDUCTOR = 13
SPECULAR_PHONG = 14
# BrushedMetal: anisotropic power-cosine microfacet conductor
# (anisotropic_power_cosine_distribution.h); exp = nx, eta field = ny
MICROFACET_CONDUCTOR_ANISO = 15
NUM_LOBE_TYPES = 16

# ------------------------------------------------- BRDF type bits (brdf.h)
DIFFUSE_REFLECTION = 0x00000001
GLOSSY_REFLECTION = 0x00000010
SPECULAR_REFLECTION = 0x00000100
DIFFUSE_TRANSMISSION = 0x00010000
GLOSSY_TRANSMISSION = 0x00100000
SPECULAR_TRANSMISSION = 0x01000000
DIFFUSE = 0x000F000F
GLOSSY = 0x00F000F0
SPECULAR = 0x0F000F00
TRANSMISSION_BITS = 0x0FFF0000   # brdf.h TRANSMISSION mask
ALL = 0xFFFFFFFF

_TYPE_BITS = np.zeros(NUM_LOBE_TYPES, np.uint32)
_TYPE_BITS[LAMBERTIAN] = DIFFUSE_REFLECTION
_TYPE_BITS[MINNAERT] = DIFFUSE_REFLECTION
_TYPE_BITS[VELVETY] = DIFFUSE_REFLECTION
_TYPE_BITS[DIELECTRIC_LAYER_LAMB] = DIFFUSE_REFLECTION   # layer takes ground's type
_TYPE_BITS[SPECULAR_REFLECT] = SPECULAR_REFLECTION
_TYPE_BITS[DIELECTRIC_REFLECT] = SPECULAR_REFLECTION
_TYPE_BITS[CONDUCTOR] = SPECULAR_REFLECTION
_TYPE_BITS[DIELECTRIC_TRANSMIT] = SPECULAR_TRANSMISSION
_TYPE_BITS[THIN_DIELECTRIC_TRANSMIT] = SPECULAR_TRANSMISSION
_TYPE_BITS[CONST_TRANSMIT] = SPECULAR_TRANSMISSION
_TYPE_BITS[TRANSMISSION] = SPECULAR_TRANSMISSION
_TYPE_BITS[MICROFACET_DIELECTRIC] = GLOSSY_REFLECTION
_TYPE_BITS[MICROFACET_CONDUCTOR] = GLOSSY_REFLECTION
_TYPE_BITS[SPECULAR_PHONG] = GLOSSY_REFLECTION
_TYPE_BITS[MICROFACET_CONDUCTOR_ANISO] = GLOSSY_REFLECTION

ONE_OVER_PI = float(1.0 / np.pi)
ONE_OVER_TWO_PI = float(1.0 / (2.0 * np.pi))


def type_bits(lobe_type):
    """Gather the BRDF type bitmask for integer lobe-type array."""
    return jnp.asarray(_TYPE_BITS)[lobe_type].astype(jnp.uint32)


def _cdot(a, b):
    return jnp.sum(a * b, axis=-1)


def _clamp01(x):
    return jnp.clip(x, 0.0, 1.0)


def _fresnel_dielectric(cosi, eta):
    """optics.h:114-121 — relative eta = etai/etat, cosi >= 0.
    Returns (F, cost); F = 1 on TIR."""
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    cost = jnp.sqrt(jnp.maximum(k, 0.0))
    rper = (eta * cosi - cost) / jnp.maximum(eta * cosi + cost, 1e-20)
    rpar = (cosi - eta * cost) / jnp.maximum(cosi + eta * cost, 1e-20)
    f = 0.5 * (rpar * rpar + rper * rper)
    return jnp.where(tir, 1.0, f), jnp.where(tir, 0.0, cost)


def _fresnel_conductor(cosi, eta, k):
    """optics.h:123-131 — complex-IOR conductor fresnel, per channel."""
    c = cosi[..., None]
    tmp = eta * eta + k * k
    rpar = ((tmp * c * c - 2.0 * eta * c + 1.0)
            / jnp.maximum(tmp * c * c + 2.0 * eta * c + 1.0, 1e-20))
    rper = ((tmp - 2.0 * eta * c + c * c)
            / jnp.maximum(tmp + 2.0 * eta * c + c * c, 1e-20))
    return 0.5 * (rpar + rper)


# ===========================================================================
# eval — used only for NEE; the reference evaluates DIFFUSE lobes only
# (pathtraceintegrator.cpp:56,140), and of the lobe set only the cosine
# family has a nonzero diffuse eval.
# ===========================================================================

def eval_lobes(lobes, ns, ng, wo, wi, type_mask: int = DIFFUSE):
    """Sum of lobe evals matching CompositedBRDF::eval (compositedbrdf.h:74-80).

    lobes: dict of (..., L[, 3]) arrays; ns/ng/wo/wi: (..., 3).
    Returns (..., 3).
    """
    t = lobes['type']
    color = lobes['color']
    bits = type_bits(t)
    sel = (bits & jnp.uint32(type_mask)) != 0

    cos_i = _cdot(wi[..., None, :], ns[..., None, :])          # (..., L)
    cos_o = _cdot(wo[..., None, :], ns[..., None, :])
    cos_i_c = _clamp01(cos_i)

    # LAMBERTIAN (lambertian.h:36-38): R/pi * clamp(dot(wi, Ns))
    f_lam = ONE_OVER_PI * cos_i_c

    # MINNAERT (minnaert.h): R/pi * clamp(dot(wi,Ns)) * clamp(dot(wo,wi))^b
    back = _clamp01(_cdot(wo[..., None, :], wi[..., None, :]))
    f_min = f_lam * jnp.power(jnp.maximum(back, 1e-20), lobes['exp'])

    # VELVETY (velvety.h): R/pi * clamp(dot(wi,Ns)) * sin(thetaO)^f
    sin_o = jnp.sqrt(jnp.maximum(1.0 - _clamp01(cos_o) ** 2, 0.0))
    f_vel = f_lam * jnp.power(jnp.maximum(sin_o, 1e-20), lobes['exp'])

    # DIELECTRIC_LAYER over Lambertian (dielectriclayer.h:36-47):
    # Fo * T * (R/pi * cosThetaI1) * T * Fi with refracted cosines
    eta = lobes['eta']
    fo, _ = _fresnel_dielectric(_clamp01(cos_o), eta)
    fi, cos_i1 = _fresnel_dielectric(_clamp01(cos_i), eta)
    f_layer = (1.0 - fo) * (1.0 - fi) * ONE_OVER_PI * cos_i1
    f_layer = jnp.where((cos_i > 0.0) & (cos_o > 0.0), f_layer, 0.0)

    f = jnp.where(t == LAMBERTIAN, f_lam,
        jnp.where(t == MINNAERT, f_min,
        jnp.where(t == VELVETY, f_vel,
        jnp.where(t == DIELECTRIC_LAYER_LAMB, f_layer, 0.0))))
    f = jnp.where(sel, f, 0.0)
    return jnp.sum(color * f[..., None], axis=-2)


# ===========================================================================
# sample — CompositedBRDF::sample (compositedbrdf.h:119-181): sample every
# lobe with the same 2D sample, build a luminance/pdf-weighted discrete
# distribution, pick one component with ss.
# ===========================================================================

def sample_lobes(lobes, ns, ng, wo, s2, s1, type_mask: int = ALL,
                 tx=None, ty=None, types_present=None):
    """types_present: optional static collection of lobe-type ids that can
    occur in this scene — families no material uses compile away entirely
    (the scene knows its material set at commit time)."""
    """Returns dict with (...,)-shaped: wi (..,3), pdf, weight (..,3) [the
    sampled lobe's color term], type_bits, eta (relative IOR factor for RR),
    valid."""
    t = lobes['type']                               # (..., L)
    color = lobes['color']                          # (..., L, 3)
    eta = lobes['eta']
    exp = lobes['exp']
    L = t.shape[-1]

    nsb = ns[..., None, :]                          # (..., 1, 3)
    wob = wo[..., None, :]
    cos_o = _cdot(wob, nsb)                         # (..., L)
    cos_o_c = _clamp01(cos_o)
    u = jnp.broadcast_to(s2[..., None, 0], t.shape)
    v = jnp.broadcast_to(s2[..., None, 1], t.shape)

    def present(*tys):
        return types_present is None or any(x in types_present for x in tys)

    zero_v = jnp.zeros(t.shape + (3,))
    zero_s = jnp.zeros(t.shape)

    # ---------------- family: cosine hemisphere around Ns -----------------
    if present(LAMBERTIAN, MINNAERT, VELVETY, DIELECTRIC_LAYER_LAMB):
        wi_cos, pdf_cos = ss.cosine_sample_hemisphere(
            u, v, jnp.broadcast_to(nsb, t.shape + (3,)))
        # eval at the sampled direction (Lambertian family returns eval())
        cos_i = _cdot(wi_cos, nsb)
        cos_i_c = _clamp01(cos_i)
        f_lam = ONE_OVER_PI * cos_i_c
        if present(MINNAERT):
            back = _clamp01(_cdot(wob, wi_cos))
            f_min = f_lam * jnp.power(jnp.maximum(back, 1e-20), exp)
        else:
            f_min = f_lam
        if present(VELVETY):
            sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_o_c ** 2, 0.0))
            f_vel = f_lam * jnp.power(jnp.maximum(sin_o, 1e-20), exp)
        else:
            f_vel = f_lam
        if present(DIELECTRIC_LAYER_LAMB):
            # dielectric layer: sample ground cosine INSIDE the layer,
            # refract out (dielectriclayer.h:49-70)
            fo, _ = _fresnel_dielectric(cos_o_c, eta)
            cos_i1_l = _cdot(wi_cos, nsb)            # ground sample cosine
            etati = 1.0 / jnp.maximum(eta, 1e-6)
            wi_out, ok_out, cos_out = vm.refract(wi_cos, -jnp.broadcast_to(
                nsb, t.shape + (3,)), etati, _clamp01(cos_i1_l))
            fi_l, _ = _fresnel_dielectric(_clamp01(cos_out), eta)
            f_layer_w = ((1.0 - fo) * (1.0 - fi_l) * ONE_OVER_PI
                         * _clamp01(cos_i1_l))
            f_layer_w = jnp.where(ok_out & (cos_o > 0.0), f_layer_w, 0.0)
            is_layer = t == DIELECTRIC_LAYER_LAMB
            wi_cosf = jnp.where(is_layer[..., None], wi_out, wi_cos)
        else:
            f_layer_w = f_lam
            wi_cosf = wi_cos
        w_cos = jnp.where(t == LAMBERTIAN, f_lam,
                jnp.where(t == MINNAERT, f_min,
                jnp.where(t == VELVETY, f_vel, f_layer_w)))
    else:
        wi_cosf, pdf_cos, w_cos = zero_v, zero_s, zero_s

    # ---------------- family: delta reflection -----------------------------
    if present(SPECULAR_REFLECT, DIELECTRIC_REFLECT, CONDUCTOR):
        wi_refl = vm.reflect(jnp.broadcast_to(wob, t.shape + (3,)),
                             jnp.broadcast_to(nsb, t.shape + (3,)), cos_o_c)
        f_diel, _ = _fresnel_dielectric(cos_o_c, eta)
        f_cond = (_fresnel_conductor(cos_o_c, lobes['ceta'], lobes['ck'])
                  if present(CONDUCTOR) else 1.0)
        w_refl = jnp.where((t == DIELECTRIC_REFLECT)[..., None],
                           f_diel[..., None],
                           jnp.where((t == CONDUCTOR)[..., None], f_cond,
                                     1.0))
    else:
        wi_refl, w_refl = zero_v, zero_v

    # ---------------- family: delta straight transmission ------------------
    if present(THIN_DIELECTRIC_TRANSMIT, CONST_TRANSMIT, TRANSMISSION):
        wi_str = -jnp.broadcast_to(wob, t.shape + (3,))
        # thin dielectric (dielectric.h:128-138):
        # exp(logT * thickness/cosO) * (1 - F)
        f_thin, _ = _fresnel_dielectric(cos_o_c, eta)
        alpha_thin = exp / jnp.maximum(cos_o_c, 1e-6)       # thickness/cosO
        w_str = jnp.where((t == THIN_DIELECTRIC_TRANSMIT)[..., None],
                          (1.0 - f_thin)[..., None], 1.0)
        w_str = jnp.where(
            (t == THIN_DIELECTRIC_TRANSMIT | (t == CONST_TRANSMIT))[..., None]
            & (cos_o <= 0.0)[..., None], 0.0, w_str)
    else:
        wi_str, w_str = zero_v, zero_v
        alpha_thin = zero_s

    # ---------------- family: refraction (dielectric.h:82-89) --------------
    if present(DIELECTRIC_TRANSMIT):
        wi_refr, ok_refr, cos_t = vm.refract(
            jnp.broadcast_to(wob, t.shape + (3,)),
            jnp.broadcast_to(nsb, t.shape + (3,)), eta, cos_o_c)
        f_refr, _ = _fresnel_dielectric(cos_o_c, eta)
        w_refr = jnp.where(ok_refr, 1.0 - f_refr, 0.0)
        pdf_refr = jnp.where(ok_refr, eta * eta, 0.0)
    else:
        wi_refr, w_refr, pdf_refr = zero_v, zero_s, zero_s

    # ---------------- family: glossy (microfacet / phong) ------------------
    if present(MICROFACET_DIELECTRIC, MICROFACET_CONDUCTOR):
        # microfacet (microfacet.h:59-67): sample wh ~ power-cosine around
        # Ns, wi = reflect(wo, wh), pdf = pdf_h / (4 |dot(wo, wh)|)
        wh, pdf_h = ss.power_cosine_sample_hemisphere(
            u, v, exp, jnp.broadcast_to(nsb, t.shape + (3,)))
        cos_owh = _cdot(jnp.broadcast_to(wob, t.shape + (3,)), wh)
        wi_mf = vm.reflect(jnp.broadcast_to(wob, t.shape + (3,)), wh,
                           cos_owh)
        pdf_mf = pdf_h / jnp.maximum(4.0 * jnp.abs(cos_owh), 1e-12)
        # microfacet eval (microfacet.h:43-56) at sampled wi
        cos_i_mf = _cdot(wi_mf, nsb)
        cos_h = _cdot(wh, nsb)
        d_mf = (exp + 2.0) * ONE_OVER_TWO_PI * jnp.power(
            jnp.maximum(jnp.abs(cos_h), 1e-20), exp)
        g_mf = jnp.minimum(1.0, jnp.minimum(
            2.0 * cos_h * cos_o_c / jnp.maximum(cos_owh, 1e-12),
            2.0 * cos_h * _clamp01(cos_i_mf) / jnp.maximum(cos_owh, 1e-12)))
        fr_d, _ = _fresnel_dielectric(_clamp01(cos_owh), eta)
        fr = fr_d[..., None]
        if present(MICROFACET_CONDUCTOR):
            fr_c = _fresnel_conductor(_clamp01(cos_owh), lobes['ceta'],
                                      lobes['ck'])
            fr = jnp.where((t == MICROFACET_CONDUCTOR)[..., None], fr_c, fr)
        w_mf = fr * (d_mf * g_mf
                     / jnp.maximum(4.0 * cos_o_c, 1e-12))[..., None]
        # MetallicPaint glitter flakes sit under a dielectric layer
        # (metallicpaint.h:37-40 DielectricLayer<MicrofacetGlitter>):
        # conductor microfacet lobes with eta != 1 get (1-Fo)(1-Fi)
        layered = (t == MICROFACET_CONDUCTOR) & (jnp.abs(eta - 1.0) > 1e-6)
        fo_l, _ = _fresnel_dielectric(cos_o_c, eta)
        fi_l2, _ = _fresnel_dielectric(_clamp01(cos_i_mf), eta)
        w_mf = jnp.where(layered[..., None],
                         w_mf * ((1.0 - fo_l) * (1.0 - fi_l2))[..., None],
                         w_mf)
        mf_ok = ((cos_i_mf > 0.0) & (cos_o > 0.0)
                 & (_cdot(wi_mf, ng[..., None, :]) > 0.0))
        w_mf = jnp.where(mf_ok[..., None], w_mf, 0.0)
    else:
        wi_mf, pdf_mf, w_mf = zero_v, zero_s, zero_v

    if present(SPECULAR_PHONG):
        # phong specular (specular.h): power-cosine around the reflect dir
        rdir = vm.reflect(jnp.broadcast_to(wob, t.shape + (3,)),
                          jnp.broadcast_to(nsb, t.shape + (3,)), cos_o)
        wi_ph, pdf_ph = ss.power_cosine_sample_hemisphere(u, v, exp, rdir)
        cos_ri = _cdot(rdir, wi_ph)
        w_ph = ((exp + 2.0) * ONE_OVER_TWO_PI
                * jnp.power(jnp.maximum(cos_ri, 1e-20), exp)
                * _clamp01(_cdot(wi_ph, nsb)))
        w_ph = jnp.where(cos_ri >= 0.0, w_ph, 0.0)
    else:
        wi_ph, pdf_ph, w_ph = zero_v, zero_s, zero_s

    if present(MICROFACET_CONDUCTOR_ANISO):
        # anisotropic conductor (BrushedMetal) — the reference's
        # anisotropic_power_cosine_distribution.h:56-73, oriented by the
        # surface tangent frame
        if tx is None or ty is None:
            txb, tyb, _ = vm.frame(ns)
        else:
            txb, tyb = tx, ty
        nx = exp
        ny_a = eta          # overloaded second exponent for aniso lobes
        phi_a = 2.0 * jnp.pi * u
        sin0 = jnp.sqrt(jnp.maximum(nx + 1.0, 0.0)) * jnp.sin(phi_a)
        cos0 = jnp.sqrt(jnp.maximum(ny_a + 1.0, 0.0)) * jnp.cos(phi_a)
        inv_n0 = 1.0 / jnp.sqrt(jnp.maximum(sin0 ** 2 + cos0 ** 2, 1e-20))
        sin_p = sin0 * inv_n0
        cos_p = cos0 * inv_n0
        n_eff = nx * cos_p ** 2 + ny_a * sin_p ** 2
        cos_ta = jnp.power(jnp.maximum(v, 1e-30), 1.0 / (n_eff + 1.0))
        sin_ta = jnp.sqrt(jnp.maximum(1.0 - cos_ta ** 2, 0.0))
        norm1_a = jnp.sqrt(jnp.maximum((nx + 1.0) * (ny_a + 1.0), 0.0)) \
            * ONE_OVER_TWO_PI
        norm2_a = jnp.sqrt(jnp.maximum((nx + 2.0) * (ny_a + 2.0), 0.0)) \
            * ONE_OVER_TWO_PI
        pdf_ha = norm1_a * jnp.power(cos_ta, n_eff)
        wh_a = ((cos_p * sin_ta)[..., None] * txb[..., None, :]
                + (sin_p * sin_ta)[..., None] * tyb[..., None, :]
                + cos_ta[..., None] * nsb)
        cos_owha = _cdot(jnp.broadcast_to(wob, t.shape + (3,)), wh_a)
        wi_a = vm.reflect(jnp.broadcast_to(wob, t.shape + (3,)), wh_a,
                          cos_owha)
        pdf_a = pdf_ha / jnp.maximum(4.0 * jnp.abs(cos_owha), 1e-12)
        cos_i_a = _cdot(wi_a, nsb)
        d_a = norm2_a * jnp.power(jnp.maximum(cos_ta, 1e-20), n_eff)
        g_a = jnp.minimum(1.0, jnp.minimum(
            2.0 * cos_ta * cos_o_c / jnp.maximum(cos_owha, 1e-12),
            2.0 * cos_ta * _clamp01(cos_i_a) / jnp.maximum(cos_owha, 1e-12)))
        fr_a = _fresnel_conductor(_clamp01(cos_owha), lobes['ceta'],
                                  lobes['ck'])
        w_a = fr_a * (d_a * g_a
                      / jnp.maximum(4.0 * cos_o_c, 1e-12))[..., None]
        a_ok = ((cos_i_a > 0.0) & (cos_o > 0.0)
                & (_cdot(wi_a, ng[..., None, :]) > 0.0))
        w_a = jnp.where(a_ok[..., None], w_a, 0.0)
    else:
        wi_a, pdf_a, w_a = zero_v, zero_s, zero_v

    is_ph = t == SPECULAR_PHONG
    is_aniso = t == MICROFACET_CONDUCTOR_ANISO
    wi_gl = jnp.where(is_aniso[..., None], wi_a,
                      jnp.where(is_ph[..., None], wi_ph, wi_mf))
    pdf_gl = jnp.where(is_aniso, pdf_a, jnp.where(is_ph, pdf_ph, pdf_mf))
    w_gl = jnp.where(is_aniso[..., None], w_a,
                     jnp.where(is_ph[..., None], w_ph[..., None], w_mf))

    # ---------------- select per-slot family --------------------------------
    fam_cos = ((t == LAMBERTIAN) | (t == MINNAERT) | (t == VELVETY)
               | (t == DIELECTRIC_LAYER_LAMB))
    fam_refl = ((t == SPECULAR_REFLECT) | (t == DIELECTRIC_REFLECT)
                | (t == CONDUCTOR))
    fam_str = ((t == THIN_DIELECTRIC_TRANSMIT) | (t == CONST_TRANSMIT)
               | (t == TRANSMISSION))
    fam_refr = t == DIELECTRIC_TRANSMIT
    fam_gl = ((t == MICROFACET_DIELECTRIC) | (t == MICROFACET_CONDUCTOR)
              | (t == SPECULAR_PHONG) | (t == MICROFACET_CONDUCTOR_ANISO))

    wi = jnp.where(fam_cos[..., None], wi_cosf,
         jnp.where(fam_refl[..., None], wi_refl,
         jnp.where(fam_str[..., None], wi_str,
         jnp.where(fam_refr[..., None], wi_refr, wi_gl))))
    pdf = jnp.where(fam_cos, pdf_cos,
          jnp.where(fam_refl | fam_str, 1.0,
          jnp.where(fam_refr, pdf_refr, pdf_gl)))

    # per-slot weight color c
    # thin dielectric: T^(thickness/cosO) * (1-F); color holds T
    thin_pow = jnp.power(jnp.maximum(color, 1e-12),
                         alpha_thin[..., None])
    c = jnp.where(fam_cos[..., None], color * w_cos[..., None],
        jnp.where(fam_refl[..., None], color * w_refl,
        jnp.where((t == THIN_DIELECTRIC_TRANSMIT)[..., None],
                  thin_pow * w_str,
        jnp.where(fam_str[..., None], color * w_str,
        jnp.where(fam_refr[..., None], color * w_refr[..., None],
                  color * w_gl)))))

    # RR eta factor (sample.eta): refraction-type lobes report rcp(eta_rel)
    eta_out = jnp.where(
        (t == DIELECTRIC_TRANSMIT) | (t == THIN_DIELECTRIC_TRANSMIT),
        1.0 / jnp.maximum(eta, 1e-6), 1.0)

    # type filter + dead slots
    bits = type_bits(t)
    live = (t != NONE) & ((bits & jnp.uint32(type_mask)) != 0)
    lum = jnp.sum(c, axis=-1)
    good = live & (lum > 0.0) & (pdf > 0.0)

    # luminance/pdf-weighted component pick (compositedbrdf.h:138-174)
    f_w = jnp.where(good, lum / jnp.maximum(pdf, 1e-20), 0.0)
    total = jnp.sum(f_w, axis=-1, keepdims=True)
    probs = f_w / jnp.maximum(total, 1e-30)
    cdf = jnp.cumsum(probs, axis=-1)
    pick = jnp.sum((cdf < s1[..., None]).astype(jnp.int32), axis=-1)
    pick = jnp.minimum(pick, L - 1)

    # one-hot selects instead of take_along_axis: 4-wide masked sums fuse
    # into the surrounding elementwise work
    onehot = (jax.lax.broadcasted_iota(jnp.int32, t.shape, t.ndim - 1)
              == pick[..., None])

    def take(a):
        return jnp.sum(jnp.where(onehot, a, jnp.zeros_like(a)), axis=-1)

    def take3(a):
        return jnp.sum(jnp.where(onehot[..., None], a, 0.0), axis=-2)

    sel_prob = take(probs)
    out = {
        'wi': take3(wi),
        'pdf': take(pdf) * sel_prob,
        'weight': take3(c),
        'type_bits': take(bits),
        'eta': take(eta_out),
        'valid': (total[..., 0] > 0.0) & jnp.any(onehot & good, axis=-1),
    }
    return out


def has_type(lobes, type_mask: int):
    """Any live lobe matching the mask (CompositedBRDF::has)."""
    bits = type_bits(lobes['type'])
    return jnp.any((lobes['type'] != NONE)
                   & ((bits & jnp.uint32(type_mask)) != 0), axis=-1)
