"""Wavefront path-trace integrator.

The reference's recursive-turned-iterative per-pixel loop
(`integrators/pathtraceintegrator.cpp:50-217`) becomes a `lax.scan` over
bounce index with the whole ray batch as state: every semantic branch of
the C++ loop is reproduced as a masked tensor op, cited inline.

Divergences from the reference (deliberate, documented):
* RNG: decorrelated pcg4d streams per (pixel, sample, bounce, purpose)
  instead of precomputed shared sample sets; the reference reuses one 2D
  light sample across bounces and reuses the Russian-roulette float as the
  lobe-selection float (pathtraceintegrator.cpp:179,189) — both are
  variance/bias quirks we do not copy.
* Russian roulette divides surviving throughput by q (the reference omits
  the 1/q compensation, which darkens deep paths).
* tMaxShadowRay == inf disables the shadow-cap/jitter/horizon machinery
  entirely (the reference's inf default produces inf-inf = NaN tMax in
  C++, effectively disabling shadows — clearly unintended; finite values
  reproduce the Yulio dome-lighting trick exactly).  NOTE the faithful
  finite-cap semantics REPLACE every light sample's tMax — a shadow ray
  toward an area/quad light overshoots the light and reports occlusion
  by whatever lies behind it (pathtraceintegrator.cpp:152 does the
  same), so finite caps only make sense for dome/ambient-lit scenes —
  exactly the Yulio production configuration (YulioRT.h:41).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core import math as vm
from ..core import rng
from ..ops import intersect as ops_i
from ..ops import raysort
from ..ops import traverse as ops_t
from ..ops import traverse_triton as ops_k
from ..shading import lobes as lb
from ..shading import materials as gmat
from ..lights import lights as glights

ULP = float(np.finfo(np.float32).eps / 2)  # 2^-24; C++ `ulp` = 2^-23?
# the reference uses `float(ulp)` = machine epsilon of float = 1.19e-7
ULP = 1.1920929e-7


@dataclass(frozen=True)
class PTParams:
    """Defaults match pathtraceintegrator.cpp:24-32."""
    max_depth: int = 10
    rr_depth: int = 5
    min_contribution: float = 0.02
    epsilon: float = 32.0 * ULP
    t_max_shadow_ray: float = float('inf')
    t_max_shadow_jitter: float = 0.15
    up: tuple = (0.0, 1.0, 0.0)
    strict_normals: bool = True
    # when set, the geometry's triangle axis is sharded over this mesh axis
    # and hits are combined across it (parallel/sharding.py)
    tri_axis: Optional[str] = None


# RNG dimension layout (per bounce `d`, base = 16 + stride*d).
# With <= 5 lights the historical layout (stride 16, lights at dim 8)
# is preserved bit-for-bit (golden images pin it); more lights widen the
# layout so shadow-jitter dims never collide with light-sample dims and
# bounces never overlap (collision at nl >= 6 under the fixed layout).
_DIM_SCATTER = 0        # 2D lobe directional sample
_DIM_SCATTER_TYPE = 1   # 1D lobe selection
_DIM_RR = 2             # 1D russian roulette
_DIM_SHADOW = 3         # 1D shadow tMax jitter (+light)
_DIM_LIGHT = 8          # 2D light sample (+light)


def _dim_layout(n_lights: int):
    """(dim_light, stride) for n_lights (static per scene)."""
    if n_lights <= 5:
        return _DIM_LIGHT, 16
    dim_light = _DIM_SHADOW + n_lights
    return dim_light, dim_light + n_lights


def _bounce_dims(depth, stride: int = 16):
    return jnp.uint32(stride) + jnp.uint32(stride) * depth.astype(jnp.uint32)


def traversal_kind(scene, motion: bool = False, platform=None) -> str:
    """The one traversal family the renderer runs for a scene:

    * 'kernel' — the GPU BVH kernel (ops/traverse_triton.py), compiled
      for the card; chosen only when the backend is a GPU;
    * 'bvh'    — the plain-XLA skip-pointer traversal (ops/traverse.py):
      BVH scenes on other backends, and motion-blur scenes everywhere
      (time-aware leaf test over the union-bounds tree);
    * 'woop' / 'brute' — scenes committed without a BVH (force_bvh=False,
      or a sharded triangle axis) test every triangle; motion scenes take
      'brute' (time-aware).

    The kernel is never run in interpret mode here: a backend without a
    GPU takes the XLA path, which is the kernel's own reference."""
    if scene.bvh is None:
        return 'brute' if motion or 'woop' not in scene.geom else 'woop'
    if motion:
        return 'bvh'
    platform = platform or jax.default_backend()
    return 'kernel' if platform == 'gpu' else 'bvh'


def _intersect(scene, org, dirn, tnear, tfar, time=None, sort_rays=False):
    """Closest hit.  sort_rays: rays are incoherent (bounce >= 1) and not
    already in raysort order — the GPU kernel then runs them sorted."""
    motion = 'mv0' in scene.geom and time is not None
    kind = traversal_kind(scene, motion)
    if kind == 'kernel':
        if sort_rays:
            return ops_k.intersect_bvh_sorted(
                scene.geom, scene.bvh, org, dirn, tnear, tfar,
                scene.bbox_lo, scene.bbox_hi)
        return ops_k.intersect_bvh(scene.geom, scene.bvh, org, dirn, tnear,
                                   tfar)
    if kind == 'bvh':
        return ops_t.intersect_bvh(scene.geom, scene.bvh, org, dirn,
                                   tnear, tfar, leaf_size=scene.leaf_size,
                                   time=time if motion else None)
    if kind == 'woop':
        return ops_i.intersect_woop(scene.geom, org, dirn, tnear, tfar)
    return ops_i.intersect_brute(scene.geom, org, dirn, tnear, tfar,
                                 time=time)


def _post_intersect_combined(scene, org, dirn, hit, tri_axis):
    """post_intersect, combining per-shard closest hits across a sharded
    triangle axis: all shards end up with the globally-nearest hit's full
    shading record, so everything downstream of intersection is replicated
    compute (the cross-shard min is the only collective per bounce)."""
    dg = ops_i.post_intersect(scene.geom, org, dirn, hit)
    if tri_axis is None:
        return hit, dg
    t_all = jax.lax.all_gather(hit.t, tri_axis)          # (S, R)
    winner = jnp.argmin(t_all, axis=0)                   # (R,)

    def pick(x):
        x_all = jax.lax.all_gather(x, tri_axis)
        idx = winner.reshape((1,) + winner.shape + (1,) * (x.ndim - 1))
        return jnp.take_along_axis(
            x_all, idx.astype(jnp.int32), axis=0)[0]

    hit = ops_i.Hit(pick(hit.t), pick(hit.tri), pick(hit.u), pick(hit.v))
    dg = {k: pick(v) for k, v in dg.items()}
    return hit, dg


def _occluded(scene, org, dirn, tnear, tfar, tri_axis=None, time=None,
              perm=None):
    """Any-hit occlusion.  perm: a raysort order for the GPU kernel (the
    shared hit-point sort of a bounce's shadow batch); None runs the rays
    as given."""
    motion = 'mv0' in scene.geom and time is not None
    kind = traversal_kind(scene, motion)
    if kind == 'kernel':
        if perm is not None:
            occ = ops_k.occluded_bvh_sorted(
                scene.geom, scene.bvh, org, dirn, tnear, tfar,
                scene.bbox_lo, scene.bbox_hi, perm=perm)
        else:
            occ = ops_k.occluded_bvh(scene.geom, scene.bvh, org, dirn,
                                     tnear, tfar)
    elif kind == 'bvh':
        occ = ops_t.occluded_bvh(scene.geom, scene.bvh, org, dirn,
                                 tnear, tfar, leaf_size=scene.leaf_size,
                                 time=time if motion else None)
    elif kind == 'woop':
        occ = ops_i.occluded_woop(scene.geom, org, dirn, tnear, tfar)
    else:
        occ = ops_i.occluded_brute(scene.geom, org, dirn, tnear, tfar,
                                   time=time)
    if tri_axis is not None:
        occ = jax.lax.psum(occ.astype(jnp.int32), tri_axis) > 0
    return occ


def _init_state(org, dirn, pixel_id, sample_id, pixel_uv=None, time=None,
                samples=None):
    """Fresh wavefront state for primary rays.  Per-ray RNG keys and the
    optional per-ray sample-table picks ride INSIDE the state dict so
    the whole wavefront can be permuted/compacted between bounces."""
    r = org.shape[0]
    state = {
        'org': org,
        'dir': dirn,
        'L': jnp.zeros((r, 3)),
        'throughput': jnp.ones((r, 3)),
        'active': jnp.ones((r,), bool),
        'ignore_vl': jnp.zeros((r,), bool),
        'unbent': jnp.ones((r,), bool),
        'medium_eta': jnp.ones((r,)),
        'medium_trans': jnp.ones((r, 3)),
        'eta_rr': jnp.ones((r,)),
        'num_rays': jnp.zeros((), jnp.float32),
        'pid': pixel_id,
        'sid': sample_id,
    }
    if pixel_uv is not None:
        state['uv'] = pixel_uv
    if time is not None:
        state['time'] = time
    if samples is not None:
        state['sset'] = samples['set']
        state['ssidx'] = samples['sidx']
    return state


def _make_bounce(scene, params: PTParams, seed, backplate=None,
                 sample_tables=None):
    """Build the per-bounce wavefront body — shared by trace() (the
    single-dispatch lax.scan path) and trace_compacted() (the
    host-driven loop with live-ray compaction).

    The returned bounce(state, depth, sort_rays, presorted) consumes an
    _init_state dict.  depth may be a traced scalar (both callers trace
    it, so ONE compiled body serves every bounce at a given width).
    presorted=True promises rays already arrive in raysort.ray_sort_key
    order (the compaction gather's order), so the closest-hit traversal
    skips its own argsort; NEE shadow batches still re-sort by hit
    point.  sample_tables: {'s1d','s2d'} arrays of
    the precomputed sampler (see trace() docstring).
    """
    up = jnp.asarray(params.up, jnp.float32)
    seed = jnp.uint32(seed)
    has_shadow_cap = np.isfinite(params.t_max_shadow_ray)

    env_lights = scene.env_lights
    all_lights = scene.lights

    dim_light, dim_stride = _dim_layout(len(all_lights))

    # NEE light groups: same-kind lights are sampled through ONE vmapped
    # graph instance (stacked parameter arrays), so trace/compile size
    # stays O(#kinds) instead of O(#lights) — a Collada export with
    # dozens of lights compiles as fast as the 3-light cornell.  HDRI
    # lights group only when their maps share a shape (static w/h).
    def _group_key(l):
        if l['kind'] == 'hdri':
            return ('hdri', l['width'], l['height'])
        return (l['kind'],)

    light_groups = {}
    for _li, _l in enumerate(all_lights):
        light_groups.setdefault(_group_key(_l), []).append(_li)
    _NO_STACK = ('kind', 'width', 'height')

    def _stacked(idxs):
        arrs = {}
        proto = all_lights[idxs[0]]
        for key, val in proto.items():
            if key in _NO_STACK or isinstance(val, str):
                arrs[key] = val
            elif isinstance(val, dict):
                arrs[key] = {k2: jnp.stack(
                    [jnp.asarray(all_lights[i][key][k2]) for i in idxs])
                    for k2 in val}
            elif key.endswith('mask'):
                arrs[key] = jnp.asarray(np.asarray(
                    [all_lights[i][key] for i in idxs],
                    np.int64).astype(np.uint32))
            else:
                arrs[key] = jnp.stack(
                    [jnp.asarray(all_lights[i][key]) for i in idxs])
        return arrs

    def bounce(state, depth, sort_rays=False, presorted=False):
        r = state['org'].shape[0]
        pixel_id = state['pid']
        sample_id = state['sid']
        pixel_uv = state.get('uv')
        time = state.get('time')
        base = _bounce_dims(depth, dim_stride)
        if sample_tables is not None:
            _sset, _sidx = state['sset'], state['ssidx']
            # shared NEE light sample: 2D dim 0 (cpp:39,133)
            nee_u2 = sample_tables['s2d'][_sset, _sidx, 0]
            # per-depth scatter-type 1D, reused by RR (cpp:179,189)
            pre_s1 = sample_tables['s1d'][_sset, _sidx, depth]
            pre_s2 = sample_tables['s2d'][_sset, _sidx, 1 + depth]
        active = state['active']
        org = state['org']
        dirn = state['dir']
        thr = state['throughput']
        L = state['L']

        # terminate low-contribution paths (pathtraceintegrator.cpp:66-67)
        active = active & (jnp.max(thr, axis=-1) >= params.min_contribution)

        # dead lanes get tfar < tnear: they fail every slab/tri test, and
        # the ray sort banishes them to all-dead blocks that end in O(1)
        # (the wavefront analog of the reference simply not recursing,
        # cpp:169-182)
        tfar_live = jnp.where(active, jnp.inf, -1.0)
        hit = _intersect(scene, org, dirn,
                         jnp.zeros((r,)), tfar_live, time=time,
                         sort_rays=(sort_rays and not presorted))
        state = dict(state)
        state['num_rays'] = state['num_rays'] + jnp.sum(active)
        hit, dg = _post_intersect_combined(scene, org, dirn, hit,
                                           params.tri_axis)
        wo = -dirn

        # ---- miss: backplate or environment lights (cpp:79-92) ----
        miss = active & ~hit.valid
        env_l = jnp.zeros((r, 3))
        if backplate is not None and pixel_uv is not None:
            bp_h, bp_w = backplate.shape[0], backplate.shape[1]
            bx = jnp.clip((pixel_uv[:, 0] * bp_w).astype(jnp.int32), 0,
                          bp_w - 1)
            by = jnp.clip((pixel_uv[:, 1] * bp_h).astype(jnp.int32), 0,
                          bp_h - 1)
            bp = backplate[by, bx]
            env_l = jnp.where(state['unbent'][:, None], bp, env_l)
            non_bp = ~state['unbent']
        else:
            non_bp = jnp.ones((r,), bool)
        env_sum = jnp.zeros((r, 3))
        for l in env_lights:
            env_sum = env_sum + glights.le_env(l, wo)
        env_l = env_l + jnp.where((non_bp & ~state['ignore_vl'])[:, None],
                                  env_sum, 0.0)
        L = L + jnp.where(miss[:, None], thr * env_l, 0.0)
        active = active & hit.valid

        # ---- face-forward normals (cpp:94-98) ----
        backfacing = vm.dot(dg['Ng'], dirn) > 0.0
        ng = jnp.where(backfacing[:, None], -dg['Ng'], dg['Ng'])
        ns = jnp.where(backfacing[:, None], -dg['Ns'], dg['Ns'])

        # ---- shade: material -> lobe context (cpp:108-111) ----
        lobed, aux = gmat.shade_context(scene.materials, scene.textures,
                                        dg['mat_id'], dg['st'],
                                        state['medium_eta'],
                                        state['medium_trans'],
                                        ns=ns, tx=dg.get('Tx'),
                                        ty=dg.get('Ty'))
        ns = aux.get('ns', ns)   # bump-mapped shading normal

        # ---- area-light emission (cpp:113-115) ----
        for li, l in enumerate(all_lights):
            if l['kind'] != 'triangle':
                continue
            is_hit_light = active & (dg['light_id'] == li) & ~backfacing \
                & ~state['ignore_vl']
            L = L + jnp.where(is_hit_light[:, None],
                              thr * glights.le_area(l, backfacing), 0.0)

        # ---- NEE: shadow rays to every light (cpp:117-167) ----
        # Sampling/shading is unrolled per light (kinds differ), but ALL
        # lights' occlusion rays are batched into ONE traversal call: one
        # kernel instance regardless of light count (compile time stays
        # flat with dozens of lights) and one ray sort.
        use_dl = lb.has_type(lobed, lb.DIFFUSE) & active
        err_eps = dg['error'] * params.epsilon
        # group-major stacked NEE tensors: cand/contrib/wi/tfar (nk, R..)
        cand_gs, contrib_gs, wi_gs, tfar_gs = [], [], [], []

        def nee_one(l, li_dim, illum_mask_u32):
            """One light's NEE sample+shade (vmapped per kind group;
            li_dim carries the ORIGINAL light index so RNG streams are
            identical to the unrolled form)."""
            mask_ok = (illum_mask_u32
                       & dg['illum_mask'].astype(jnp.uint32)) != 0
            u2 = (nee_u2 if sample_tables is not None else
                  rng.uniform2(seed, pixel_id, sample_id,
                               base + jnp.uint32(dim_light) + li_dim))
            le, wi, pdf, tmax = glights.sample(l, dg['P'], ns, u2)
            cand = use_dl & mask_ok & (pdf > 0.0) \
                & jnp.any(le > 0.0, axis=-1)
            brdf = lb.eval_lobes(lobed, ns, ng, wo, wi, lb.DIFFUSE)
            cand = cand & jnp.any(brdf > 0.0, axis=-1)

            if has_shadow_cap:
                # Yulio dome trick (cpp:148-157): cap shadow length with
                # jitter; lengthen up to 100x below the horizon
                jit = rng.uniform1(
                    seed, pixel_id, sample_id,
                    base + jnp.uint32(_DIM_SHADOW) + li_dim)
                t_cap = params.t_max_shadow_ray
                t_jit = params.t_max_shadow_jitter
                jlen = 2.0 * t_cap * t_jit * jit - t_cap * t_jit
                tmax = t_cap + jlen
                dot_up = vm.dot(wi, up)
                below = dot_up <= 0.0
                tmax = tmax + jnp.where(
                    below,
                    t_cap * 100.0 * vm.smoothstep(0.0, 1.0,
                                                  jnp.abs(dot_up)),
                    0.0)

            contrib = thr * le * brdf / jnp.maximum(pdf, 1e-20)[:, None]
            return cand, contrib, wi, jnp.where(cand, tmax - err_eps,
                                                -1.0)

        for gkey, idxs in light_groups.items():
            if gkey[0] == 'hdri':
                # HDRI's Distribution2D holds ragged CDF tables that do
                # not batch; sample each directly (rarely more than one)
                for li in idxs:
                    c1, k1, w1, t1 = nee_one(
                        all_lights[li], jnp.uint32(li),
                        jnp.uint32(all_lights[li]['illum_mask']
                                   & 0xFFFFFFFF))
                    cand_gs.append(c1[None])
                    contrib_gs.append(k1[None])
                    wi_gs.append(w1[None])
                    tfar_gs.append(t1[None])
                continue
            stacked = _stacked(idxs)
            statics = {k: v for k, v in stacked.items()
                       if k in _NO_STACK or isinstance(v, str)}
            arrays = {k: v for k, v in stacked.items()
                      if k not in statics and k != 'illum_mask'}
            dims = jnp.asarray(idxs, jnp.uint32)
            masks = stacked['illum_mask']
            c_g, k_g, w_g, t_g = jax.vmap(
                lambda larr, d, m, _s=statics: nee_one(
                    {**_s, **larr}, d, m),
                in_axes=(0, 0, 0))(arrays, dims, masks)
            cand_gs.append(c_g)
            contrib_gs.append(k_g)
            wi_gs.append(w_g)
            tfar_gs.append(t_g)

        if cand_gs:
            cand_all = jnp.concatenate(cand_gs)        # (nl, R)
            contrib_all = jnp.concatenate(contrib_gs)  # (nl, R, 3)
            wi_all = jnp.concatenate(wi_gs)            # (nl, R, 3)
            tfar_all = jnp.concatenate(tfar_gs)        # (nl, R)
            nl = cand_all.shape[0]
            state['num_rays'] = state['num_rays'] + jnp.sum(cand_all)
            # every light's shadow batch starts at the SAME hit points:
            # one hit-point sort, shared light-major across the whole
            # nl*r batch, for the traversal that runs sorted rays
            shadow_perm = None
            if (sort_rays and nl > 0
                    and traversal_kind(scene, time is not None
                                       and 'mv0' in scene.geom) == 'kernel'):
                p0 = raysort.hitpoint_sort_perm(
                    dg['P'], scene.bbox_lo, scene.bbox_hi,
                    live=hit.tri >= 0)
                shadow_perm = raysort.tile_perm(p0, nl, r)
            occ_all = _occluded(
                scene,
                jnp.tile(dg['P'], (nl, 1)),
                wi_all.reshape(nl * r, 3),
                jnp.tile(err_eps, (nl,)),
                tfar_all.reshape(nl * r),
                params.tri_axis, time=(None if time is None
                                       else jnp.tile(time, (nl,))),
                perm=shadow_perm)
            lit = cand_all & ~occ_all.reshape(nl, r)
            L = L + jnp.sum(jnp.where(lit[:, :, None], contrib_all, 0.0),
                            axis=0)

        # ---- depth cut (cpp:169-170) ----
        cont = active & (depth < params.max_depth - 1)

        # ---- russian roulette (cpp:172-182, with 1/q compensation) ----
        q = jnp.minimum(jnp.max(thr, axis=-1) * state['eta_rr'] ** 2, 0.95)
        rr_on = depth >= (params.rr_depth - 1)
        rr_u = (pre_s1 if sample_tables is not None else
                rng.uniform1(seed, pixel_id, sample_id,
                             base + jnp.uint32(_DIM_RR)))
        killed = rr_on & (rr_u >= q)
        cont = cont & ~killed
        rr_scale = jnp.where(rr_on, 1.0 / jnp.maximum(q, 1e-3), 1.0)

        # ---- GI: sample one lobe (cpp:184-213) ----
        if sample_tables is not None:
            s2, s1 = pre_s2, pre_s1    # s1 == rr_u, as in the reference
        else:
            s2 = rng.uniform2(seed, pixel_id, sample_id,
                              base + jnp.uint32(_DIM_SCATTER))
            s1 = rng.uniform1(seed, pixel_id, sample_id,
                              base + jnp.uint32(_DIM_SCATTER_TYPE))
        samp = lb.sample_lobes(lobed, ns, ng, wo, s2, s1, lb.ALL,
                               tx=dg.get('Tx'), ty=dg.get('Ty'),
                               types_present=getattr(scene, 'lobe_types',
                                                     None))
        cont = cont & samp['valid'] & (samp['pdf'] > 0.0) \
            & jnp.any(samp['weight'] > 0.0, axis=-1)

        # simple volumetrics: Beer attenuation through the current medium
        # (cpp:197-201): c *= transmission^tfar when medium is absorbing
        trans_med = state['medium_trans']
        absorbing = jnp.any(trans_med < 1.0, axis=-1)
        beer = jnp.where(absorbing[:, None],
                         jnp.power(jnp.maximum(trans_med, 1e-20),
                                   hit.t[:, None]), 1.0)

        w = samp['weight'] * beer / jnp.maximum(samp['pdf'], 1e-20)[:, None]
        new_thr = thr * w * rr_scale[:, None]

        # medium transition on sampled transmission (cpp:203-206)
        trans_bit = (samp['type_bits'] & jnp.uint32(lb.TRANSMISSION_BITS)) != 0
        new_eta_m, new_trans_m = gmat.next_medium(
            aux, trans_bit, state['medium_eta'], state['medium_trans'])

        # offset new ray origin (cpp:210: Ray(dg.P, dir, err*eps, inf))
        new_org = dg['P']
        new_dir = samp['wi']
        # emulate tnear via a small push along the direction (our intersect
        # uses tnear=0 for the next segment); the error-scaled epsilon is
        # the reference's self-intersection guard
        new_org = new_org + new_dir * err_eps[:, None]

        # diffuse-sampled -> ignore directly visible lights next bounce
        new_ignore = (samp['type_bits'] & jnp.uint32(lb.DIFFUSE)) != 0

        state['org'] = jnp.where(cont[:, None], new_org, state['org'])
        state['dir'] = jnp.where(cont[:, None], new_dir, state['dir'])
        state['throughput'] = jnp.where(cont[:, None], new_thr, thr)
        state['L'] = L
        state['active'] = cont
        state['ignore_vl'] = jnp.where(cont, new_ignore,
                                       state['ignore_vl'])
        state['unbent'] = state['unbent'] & jnp.all(
            jnp.abs(state['dir'] - dirn) < 1e-12, axis=-1)
        state['medium_eta'] = jnp.where(cont, new_eta_m,
                                        state['medium_eta'])
        state['medium_trans'] = jnp.where(cont[:, None], new_trans_m,
                                          state['medium_trans'])
        state['eta_rr'] = jnp.where(cont, state['eta_rr'] * samp['eta'],
                                    state['eta_rr'])
        return state, None

    return bounce


def trace(scene, params: PTParams, org, dirn, seed, pixel_id, sample_id,
          pixel_uv=None, backplate=None, time=None, samples=None):
    """Estimate radiance along primary rays (single-dispatch scan form).

    org/dirn: (R, 3); pixel_id/sample_id: (R,) uint32 (RNG keys);
    pixel_uv: (R, 2) in [0,1)^2 for backplate lookups.
    samples: optional precomputed sample-set tables
    (sampling/precomputed.py — the reference's SamplerFactory sequences,
    sampler.cpp:85-160): dict with 'set'/'sidx' (R,) int32 and
    's1d' (sets, spp, >=max_depth) / 's2d' (sets, spp, >=1+max_depth, 2).
    When given, the NEE light sample is 2D dim 0 (shared by every light
    and depth, pathtraceintegrator.cpp:39+133), scatter directions are
    2D dims 1+depth (cpp:188), and the scatter-type 1D dim `depth` is
    REUSED for Russian roulette (cpp:179+189) — exactly the reference's
    stream.  Shadow tMax jitter stays stateless (the reference draws the
    global system RNG there, cpp:152 — irreproducible by design).
    Returns (L (R, 3), num_rays (scalar f32)).
    """
    state = _init_state(org, dirn, pixel_id, sample_id, pixel_uv, time,
                        samples)
    tables = (None if samples is None else
              {'s1d': samples['s1d'], 's2d': samples['s2d']})
    bounce = _make_bounce(scene, params, seed, backplate, tables)
    # bounce 0 is peeled out of the scan: primary (and first-shadow) rays
    # arrive in tiled order and need no ray binning; the remaining bounces
    # have scattered directions/origins, so their traversals run behind an
    # octant/Morton sort (ops/raysort.py)
    state, _ = bounce(state, jnp.int32(0), sort_rays=False)
    if params.max_depth > 1:
        state, _ = jax.lax.scan(
            lambda st, d: bounce(st, d, sort_rays=True), state,
            jnp.arange(1, params.max_depth, dtype=jnp.int32))
    return state['L'], state['num_rays']


# ---------------------------------------------------------------------------
# Host-driven wavefront with live-ray compaction.
#
# The reference's per-pixel recursion simply STOPS when a path dies
# (pathtraceintegrator.cpp:169-182) — zero dead work.  The lax.scan form
# above keeps the full batch width through all max_depth bounces: dead
# lanes end traversal at once, but they still occupy width in every
# argsort, shade, NEE and scatter stage.  At
# the production depth-10 + RR-from-5 config most lanes are dead from
# bounce ~5 on, so the scan form does up to ~8x dead elementwise work on
# late bounces (SURVEY §7 step 8 'compaction').
#
# trace_compacted() runs ONE dispatch per bounce from the host: after
# each bounce it fetches the live count (a scalar), gathers live rays to
# a prefix (the same octant/Morton key the sorted traversal uses, so the
# gather REPLACES the traversal's own argsort),
# and slices the state to the smallest allowed static width >= live.
# XLA static shapes make truly dynamic widths impossible; a small set of
# power-of-two bucket widths bounds the compile count while capturing
# most of the dead-lane discount.  Dropped lanes are always dead, so the
# result is bit-identical per ray to trace() (tests/test_integrator.py).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=('params', 'sort_rays', 'presorted'))
def _bounce_step(scene, params, state, depth, seed, backplate=None,
                 sample_tables=None, sort_rays=True, presorted=False):
    """One jitted bounce.  depth is TRACED: one compiled graph serves
    every bounce at a given width (the RR/depth/min-contribution tests
    and the sample-table indices all consume it dynamically).  Returns
    (state, live count entering the next bounce)."""
    bounce = _make_bounce(scene, params, seed, backplate, sample_tables)
    state, _ = bounce(state, depth, sort_rays=sort_rays,
                      presorted=presorted)
    live = state['active'] & (jnp.max(state['throughput'], axis=-1)
                              >= params.min_contribution)
    return state, jnp.sum(live.astype(jnp.int32))


@partial(jax.jit, static_argnames=('bbox_lo', 'bbox_hi', 'w_out', 'minc'))
def _compact_step(state, l_out, bbox_lo, bbox_hi, w_out: int, minc: float):
    """Sort the wavefront by the ray-coherence key (dead lanes last),
    flush the DROPPED lanes' accumulated L into the full-width output
    buffer, and slice the state to the first w_out lanes.  The caller
    guarantees w_out >= live count, so sliced-off lanes are dead and
    their L is final — exact, not lossy.  Lanes that survive (live or
    not) are flushed once by trace_compacted's final full flush, so the
    per-step scatter touches only the r - w_out dropped rows."""
    org, dirn = state['org'], state['dir']
    r = org.shape[0]
    live = state['active'] & (jnp.max(state['throughput'], axis=-1)
                              >= minc)
    key = raysort.ray_sort_key(org, dirn, bbox_lo, bbox_hi)
    key = key | ((~live).astype(jnp.uint32) << jnp.uint32(30))
    perm = jnp.argsort(key)
    dropped = perm[w_out:]
    if w_out < r:
        # rid is unique per lane -> a permutation scatter
        l_out = l_out.at[state['rid'][dropped]].set(state['L'][dropped])
    sl = perm[:w_out]
    new_state = {k: (v[sl] if getattr(v, 'ndim', 0) >= 1
                     and v.shape[0] == r else v)
                 for k, v in state.items()}
    return new_state, l_out


def scene_key(scene):
    """Hashable summary of a committed scene's compiled shape: array
    shapes/dtypes plus the static fields (two scenes with equal keys
    share every compiled graph)."""
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    return (treedef, tuple((v.shape, str(v.dtype)) for v in leaves
                           if hasattr(v, 'shape')))


def bounce_memory(scene, params, width: int, motion: bool = False):
    """compiled.memory_analysis() of one bounce at `width` rays, in the
    form trace_compacted dispatches bounce 0 (stateless sampler, no
    backplate), so a persistent compilation cache then serves that
    dispatch from this compile."""
    f32, u32 = jnp.float32, jnp.uint32
    sd = jax.ShapeDtypeStruct
    state = jax.eval_shape(
        lambda o, d, p, s_, uv, t: _init_state(o, d, p, s_, uv, t),
        sd((width, 3), f32), sd((width, 3), f32), sd((width,), u32),
        sd((width,), u32), sd((width, 2), f32),
        sd((width,), f32) if motion else None)
    state['rid'] = sd((width,), jnp.int32)
    return _bounce_step.lower(scene, params, state, jnp.int32(0),
                              jnp.uint32(0), None, None,
                              sort_rays=False).compile().memory_analysis()


def bounce_bytes(scene, params, width: int) -> int:
    """Device bytes one bounce at `width` rays holds: arguments + outputs
    + temporaries, less what the outputs alias."""
    mem = bounce_memory(scene, params, width, motion='mv0' in scene.geom)
    return int(mem.argument_size_in_bytes + mem.output_size_in_bytes
               + mem.temp_size_in_bytes - mem.alias_size_in_bytes)


_PREWARM_KEYS = set()


def _prewarm_shrunk_widths(scene, params, state, widths, seed, backplate,
                           tables):
    """Overlap the shrunk-width compiles with the full-width bounces.

    Each compact bucket width compiles its own bounce graph, and the
    host loop otherwise discovers them SERIALLY: bounce 5 blocks on the
    first shrunk width's compile, bounce 6 on the next.  Here one daemon
    thread
    per shrunk width AOT-compiles its bounce + compact graphs
    (jit.lower().compile() — host-side work, no device dispatch) while
    the full-width bounces 1-4 execute; the results land in the
    persistent compilation cache (utils/compile_cache.py), which the
    host loop's jit calls then hit instead of compiling.  Concurrent
    XLA compiles are independent, so cold cost ≈ max(compile) instead
    of Σ(compile).  Pure optimization: failures are swallowed and the
    foreground loop compiles as before."""
    import threading
    r = state['org'].shape[0]
    shrunk = [w2 for w2 in widths if w2 < r]
    if not shrunk or r < (1 << 18):     # tiny configs compile in seconds
        return
    key = (scene_key(scene), r, tuple(widths), params,
           backplate is not None, tables is not None)
    if key in _PREWARM_KEYS:
        return
    _PREWARM_KEYS.add(key)

    def sds_state(w2):
        return {k: (jax.ShapeDtypeStruct((w2,) + v.shape[1:], v.dtype)
                    if getattr(v, 'ndim', 0) >= 1 and v.shape[0] == r
                    else v)
                for k, v in state.items()}

    def compile_bounce(w2):
        try:
            _bounce_step.lower(
                scene, params, sds_state(w2), jnp.int32(1), seed,
                backplate, tables, sort_rays=True,
                presorted=True).compile()
        except Exception:
            pass

    def compile_compacts():
        try:
            l_sds = jax.ShapeDtypeStruct((r, 3), jnp.float32)
            pairs = [(r, w2) for w2 in shrunk]
            pairs += [(a, b) for a in shrunk for b in shrunk if b <= a]
            for w_in, w_out in pairs:
                st = sds_state(w_in)
                _compact_step.lower(st, l_sds, scene.bbox_lo,
                                    scene.bbox_hi, w_out,
                                    params.min_contribution).compile()
        except Exception:
            pass

    for w2 in shrunk:
        threading.Thread(target=compile_bounce, args=(w2,),
                         daemon=True).start()
    threading.Thread(target=compile_compacts, daemon=True).start()


# Bucket divisor set for trace_compacted: widths ceil(r/d).  Finer sets
# track the post-RR live tail tighter (less dead work in bounces 5+) at
# the cost of more compiled bounce graphs (each prewarmed async,
# _prewarm_shrunk_widths).  The set is not yet re-measured on the GPU
# (PERF.md open questions).
COMPACT_DIVISORS = (1, 4, 8, 16, 32)


def compact_widths(r: int, divisors=None):
    """Allowed static wavefront widths for r rays: ceil(r/d) for each
    divisor.  Each distinct width compiles its own bounce graph — the
    divisor set bounds cold-compile cost."""
    ws = set()
    for d in (COMPACT_DIVISORS if divisors is None else divisors):
        ws.add(int(-(-r // d)))
    ws.add(int(r))
    return sorted(ws, reverse=True)


def trace_compacted(scene, params: PTParams, org, dirn, seed, pixel_id,
                    sample_id, pixel_uv=None, backplate=None, time=None,
                    samples=None, width_divisors=None,
                    bounce_stats=None):
    """trace() with one dispatch per bounce and live-ray compaction
    between bounces (see the section comment above).  Bit-identical per
    ray to trace(); NOT jittable (host control flow picks bucket widths
    from fetched live counts — the XLA-static-shapes answer to the
    reference's recursion simply stopping, pathtraceintegrator.cpp:169).

    bounce_stats: optional list; one dict per bounce is appended:
    {'depth', 'width', 'live', 'seconds'} — `live` is the count ENTERING
    the next bounce, `seconds` the host wall time of this bounce's
    dispatch+fetch (the per-bounce phase profile).
    Returns (L (R, 3), num_rays (device scalar f32)).
    """
    import time as _time
    r = org.shape[0]
    state = _init_state(org, dirn, pixel_id, sample_id, pixel_uv, time,
                        samples)
    state['rid'] = jnp.arange(r, dtype=jnp.int32)
    tables = (None if samples is None else
              {'s1d': samples['s1d'], 's2d': samples['s2d']})
    widths = compact_widths(r, width_divisors)
    seed = jnp.uint32(seed)
    l_out = jnp.zeros((r, 3))
    _prewarm_shrunk_widths(scene, params, state, widths, seed, backplate,
                           tables)

    t0 = _time.perf_counter()
    state, n_live = _bounce_step(scene, params, state, jnp.int32(0), seed,
                                 backplate, tables, sort_rays=False)
    w = r
    last_d = 0
    for d in range(1, params.max_depth):
        n = int(jax.device_get(n_live))     # syncs bounce d-1
        if bounce_stats is not None:
            t1 = _time.perf_counter()
            bounce_stats.append(dict(depth=d - 1, width=w, live=n,
                                     seconds=t1 - t0))
            t0 = t1
        if n == 0:
            bounce_stats = None     # all-dead: last entry already logged
            break
        w_new = min(w, next(x for x in reversed(widths) if x >= n))
        # Compact only when the width SHRINKS (or to keep an already-
        # shrunk wavefront in presorted order, where the step is cheap).
        # At full width nothing is dropped, and permuting the whole
        # state costs more than the traversal's own 4-array sort.
        presorted = False
        if w_new < w or w < r:
            state, l_out = _compact_step(state, l_out, scene.bbox_lo,
                                         scene.bbox_hi, w_new,
                                         params.min_contribution)
            presorted = True
        w = w_new
        last_d = d
        state, n_live = _bounce_step(scene, params, state, jnp.int32(d),
                                     seed, backplate, tables,
                                     sort_rays=True, presorted=presorted)
    if bounce_stats is not None:
        n = int(jax.device_get(n_live))
        bounce_stats.append(dict(depth=last_d, width=w, live=n,
                                 seconds=_time.perf_counter() - t0))
    l_out = l_out.at[state['rid']].set(state['L'])
    return l_out, state['num_rays']
