"""Light models, vectorized over ray batches.

The seven light types of the reference registry
(`singleray_device.cpp:291-302`): ambient (the Yulio dome light),
point, spot, directional, distant, HDRI environment, triangle area light.

Design: scene light *count and types are static* at trace time — the NEE
loop in the integrator unrolls over the scene's light list, so each light's
sampling code specializes with zero dynamic dispatch (the wavefront analog
of the reference's virtual `Light::sample`, pathtraceintegrator.cpp:124-137).

Each light is a dict {'kind': str, ...params (jnp arrays)}.  `sample`
returns (Le, wi, pdf, tmax) for a batch of shade points; pdf conventions
match the reference exactly (pointlight.h / spotlight.h / distantlight.h /
trianglelight.h / ambientlight.h / hdrilight.cpp — cited inline).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import math as vm
from ..sampling import shapesampler as ss
from ..sampling import distribution as dist

TWO_PI = float(2 * np.pi)
PI = float(np.pi)


# --------------------------------------------------------------- builders

def _np3(x):
    return np.asarray(x, np.float32)


def _npnorm(x):
    v = np.asarray(x, np.float32)
    return v / max(float(np.linalg.norm(v)), 1e-20)


def ambient(L, illum_mask=-1, shadow_mask=-1):
    """AmbientLight (ambientlight.h): uniform env light; the dome model.

    Builders stay host-side numpy: a jnp array here would be a device
    round-trip per light at scene-build time; commit() moves the arrays
    to the device once (_split_lights)."""
    return {'kind': 'ambient', 'L': _np3(L),
            'bsphere_center': np.zeros(3, np.float32),
            'bsphere_radius': np.float32(0),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def point(P, I, illum_mask=-1, shadow_mask=-1):
    return {'kind': 'point', 'P': _np3(P), 'I': _np3(I),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def spot(P, D, I, angle_min_deg, angle_max_deg, illum_mask=-1,
         shadow_mask=-1):
    """spotlight.h:42-45: the stored axis is -normalize(D) (compared
    against the surface->light direction) and the cone parameters are
    cosines of HALF the given angles."""
    return {'kind': 'spot', 'P': _np3(P),
            'D': -_npnorm(D), 'I': _np3(I),
            'cos_min': np.float32(np.cos(0.5 * np.deg2rad(angle_min_deg))),
            'cos_max': np.float32(np.cos(0.5 * np.deg2rad(angle_max_deg))),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def directional(D, E, illum_mask=-1, shadow_mask=-1):
    return {'kind': 'directional', 'wo': -_npnorm(D), 'E': _np3(E),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def distant(D, L, half_angle_deg, illum_mask=-1, shadow_mask=-1):
    ha = float(np.deg2rad(half_angle_deg))
    return {'kind': 'distant', 'wo': -_npnorm(D), 'L': _np3(L),
            'half_angle': np.float32(ha),
            'cos_half': np.float32(np.cos(ha)),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def triangle(v0, v1, v2, L, illum_mask=-1, shadow_mask=-1):
    v0, v1, v2 = _np3(v0), _np3(v1), _np3(v2)
    return {'kind': 'triangle', 'v0': v0, 'v1': v1, 'v2': v2,
            'L': _np3(L),
            # unnormalized Ng = cross(e1, e2) with e1 = v0 - v1, e2 = v2 - v0
            # (trianglelight.h:39) — |Ng| = 2*area feeds the pdf
            'Ng': np.cross(v0 - v1, v2 - v0).astype(np.float32),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def hdri(image: np.ndarray, L=(1, 1, 1), local2world=None,
         illum_mask=-1, shadow_mask=-1):
    """HDRILight (hdrilight.cpp): lat-long env map with sin(theta)-weighted
    2D importance distribution."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    h, w = img.shape[:2]
    ys = (np.arange(h) + 0.5) / h
    importance = np.sin(np.pi * ys)[:, None] * img.sum(axis=-1)
    d2 = dist.build_2d(importance)
    l2w = (np.asarray(local2world, np.float32) if local2world is not None
           else np.concatenate([np.eye(3, dtype=np.float32),
                                np.zeros((1, 3), np.float32)]))
    linv = np.linalg.inv(l2w[:3, :]).astype(np.float32)
    w2l = np.concatenate([linv, (-l2w[3, :] @ linv)[None, :]]) \
        .astype(np.float32)
    return {'kind': 'hdri', 'image': img,
            'L': _np3(L),
            'width': w, 'height': h, 'dist': d2,
            'local2world': l2w, 'world2local': w2l,
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def is_env(light) -> bool:
    return light['kind'] in ('ambient', 'hdri')


def set_scene_bounds(light, bbox_lo, bbox_hi):
    """AmbientLight::createShape (ambientlight.h:43-47): bsphere of the
    scene bbox with radius * 1.5 limits dome shadow rays."""
    if light['kind'] != 'ambient':
        return light
    center, radius = vm.bsphere_of_bbox(bbox_lo, bbox_hi)
    out = dict(light)
    out['bsphere_center'] = np.asarray(center, np.float32)
    out['bsphere_radius'] = np.float32(max(radius * 1.5,
                                           np.finfo(np.float32).eps))
    return out


# --------------------------------------------------------------- sampling

def sample(light, P, Ns, u2):
    """Sample incoming illumination at shade points.

    P, Ns: (R, 3); u2: (R, 2).  Returns (Le (R,3), wi (R,3), pdf (R,),
    tmax (R,)).  Zero radiance or pdf=0 marks an invalid sample
    (pathtraceintegrator.cpp:137).
    """
    k = light['kind']
    r = P.shape[0]
    inf = jnp.full((r,), jnp.inf)

    if k == 'ambient':
        # ambientlight.h:67-80: cosine hemisphere; tMax clipped to the
        # scene bsphere's far hit
        wi, pdf = ss.cosine_sample_hemisphere(u2[..., 0], u2[..., 1], Ns)
        has_sphere = light['bsphere_radius'] > 0
        hit, tfar = vm.ray_sphere_tfar(P, wi, light['bsphere_center'],
                                       light['bsphere_radius'])
        tmax = jnp.where(has_sphere & hit, tfar, jnp.inf)
        return (jnp.broadcast_to(light['L'], (r, 3)), wi, pdf, tmax)

    if k == 'point':
        # pointlight.h: pdf = distance^2
        d = light['P'] - P
        distn = vm.length(d)
        wi = d / jnp.maximum(distn, 1e-20)[..., None]
        return (jnp.broadcast_to(light['I'], (r, 3)), wi, distn * distn,
                distn)

    if k == 'spot':
        d = light['P'] - P
        distn = vm.length(d)
        wi = d / jnp.maximum(distn, 1e-20)[..., None]
        cos_a = vm.dot(wi, light['D'])
        denom = light['cos_min'] - light['cos_max']
        fall = jnp.where(denom != 0,
                         jnp.clip((cos_a - light['cos_max'])
                                  / jnp.where(denom != 0, denom, 1.0), 0, 1),
                         (cos_a > light['cos_min']).astype(jnp.float32))
        return (light['I'] * fall[..., None], wi, distn * distn, distn)

    if k == 'directional':
        wi = jnp.broadcast_to(light['wo'], (r, 3))
        return (jnp.broadcast_to(light['E'], (r, 3)), wi, jnp.ones((r,)),
                inf)

    if k == 'distant':
        local, pdf = ss.uniform_sample_cone(u2[..., 0], u2[..., 1],
                                            light['half_angle'])
        dx, dy, dz = vm.frame(jnp.broadcast_to(light['wo'], (r, 3)))
        wi = (local[..., 0:1] * dx + local[..., 1:2] * dy
              + local[..., 2:3] * dz)
        return (jnp.broadcast_to(light['L'], (r, 3)), wi, pdf, inf)

    if k == 'triangle':
        # trianglelight.h: pdf = 2 t^3 / |d . Ng| (solid-angle form with
        # unnormalized Ng = 2A); zero radiance from the back side
        p = ss.uniform_sample_triangle(u2[..., 0], u2[..., 1],
                                       light['v0'], light['v1'], light['v2'])
        d = p - P
        tmax = vm.length(d)
        d_dot_ng = vm.dot(d, light['Ng'])
        wi = d / jnp.maximum(tmax, 1e-20)[..., None]
        pdf = 2.0 * tmax ** 3 / jnp.maximum(jnp.abs(d_dot_ng), 1e-20)
        le = jnp.where((d_dot_ng < 0.0)[..., None],
                       jnp.broadcast_to(light['L'], (r, 3)), 0.0)
        return (le, wi, pdf, tmax)

    if k == 'hdri':
        # hdrilight.cpp:93-104
        xy, pdf2 = dist.sample_2d(light['dist'], u2)
        w, h = light['width'], light['height']
        theta = PI * xy[..., 1] / h
        phi = TWO_PI * (1.0 - xy[..., 0] / w)
        sin_t = jnp.sin(theta)
        wi_local = jnp.stack([-sin_t * jnp.cos(phi), jnp.cos(theta),
                              -sin_t * jnp.sin(phi)], axis=-1)
        wi = vm.xfm_vector(light['local2world'], wi_local)
        pdf = pdf2 / jnp.maximum(TWO_PI * PI * sin_t, 1e-20)
        xi = jnp.clip(xy[..., 0].astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(xy[..., 1].astype(jnp.int32), 0, h - 1)
        le = light['L'] * light['image'][yi, xi]
        return (le, wi, pdf, inf)

    raise ValueError(f"unknown light kind {k}")


def le_env(light, wo):
    """Environment radiance for escaped rays Le(wo)
    (pathtraceintegrator.cpp:86-89). wo = -ray.dir."""
    k = light['kind']
    if k == 'ambient':
        return jnp.broadcast_to(light['L'], wo.shape)
    if k == 'hdri':
        # hdrilight.cpp:59-86: lat-long lookup with bilinear filtering and
        # x-wraparound
        wi = vm.xfm_vector(light['world2local'], -wo)
        theta = jnp.arccos(jnp.clip(wi[..., 1], -1.0, 1.0))
        phi = jnp.arctan2(-wi[..., 2], -wi[..., 0])
        phi = jnp.where(phi < 0, phi + TWO_PI, phi)
        u = 1.0 - phi / TWO_PI
        v = theta / PI
        w, h = light['width'], light['height']
        x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
        x_next = jnp.where(x + 1 == w, 0, x + 1)
        alpha = u * w - x
        y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
        y_next = jnp.minimum(y + 1, h - 1)
        beta = v * h - y
        img = light['image']
        c0 = img[y, x]
        c1 = img[y, x_next]
        c2 = img[y_next, x_next]
        c3 = img[y_next, x]
        t0 = beta[..., None] * c3 + (1 - beta)[..., None] * c0
        t1 = beta[..., None] * c2 + (1 - beta)[..., None] * c1
        return light['L'] * (alpha[..., None] * t1
                             + (1 - alpha)[..., None] * t0)
    raise ValueError(f"{k} is not an environment light")


def le_area(light, backfacing):
    """Emission of a hit area light (trianglelight Le); zero when the hit
    is backfacing (pathtraceintegrator.cpp:114)."""
    return jnp.where(backfacing[..., None], 0.0, light['L'])
