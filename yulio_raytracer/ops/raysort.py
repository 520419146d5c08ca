"""Ray-coherence sorting for the wavefront: octant + origin-Morton keys.

Bounce>=1 rays arrive in pixel order with scattered origins and
directions.  Grouping same-octant, nearby-origin rays makes neighbouring
lanes of a traversal kernel walk similar node sequences, so a block's
loop ends sooner.  The reference never needed this — Embree's single-ray
traversal is order-insensitive (pathtraceintegrator.cpp recursion); the
analog there is Embree's internal ray-stream sorting (rtcIntersect1M).
"""
from __future__ import annotations

import jax.numpy as jnp


def ray_sort_key(org, dirn, bbox_lo, bbox_hi):
    """Coherence key: direction octant (3 high bits) then a 15-bit origin
    Morton code over the scene box.  Bits 18+ are free for callers."""
    lo = jnp.asarray(bbox_lo, jnp.float32)
    span = jnp.maximum(jnp.asarray(bbox_hi, jnp.float32) - lo, 1e-6)
    q = jnp.clip((org - lo) / span, 0.0, 1.0)
    cell = (q * 31.0).astype(jnp.uint32)              # 5 bits per axis
    m = jnp.zeros(org.shape[0], jnp.uint32)
    for b in range(5):                                 # interleave (Morton)
        for a in range(3):
            bit = (cell[:, a] >> b) & 1
            m = m | (bit << jnp.uint32(3 * b + a))
    oct_ = ((dirn[:, 0] < 0).astype(jnp.uint32)
            | ((dirn[:, 1] < 0).astype(jnp.uint32) << 1)
            | ((dirn[:, 2] < 0).astype(jnp.uint32) << 2))
    return (oct_ << jnp.uint32(15)) | m


def sorted_call(fn, n_outs, org, dirn, tnear, tfar, bbox_lo, bbox_hi,
                perm=None):
    """Run fn on octant/Morton-sorted rays and unsort its outputs.  Dead
    rays (tfar <= tnear, the integrator's inactive-lane marker) sort to
    the end, so they fill blocks that exit at once.

    perm: optional precomputed (R,) permutation that replaces the key +
    argsort; the integrator shares one hit-point sort across all of a
    bounce's shadow batches this way (hitpoint_sort_perm + tile_perm)."""
    if perm is None:
        key = ray_sort_key(org, dirn, bbox_lo, bbox_hi)
        key = key | ((tfar <= tnear).astype(jnp.uint32) << jnp.uint32(30))
        perm = jnp.argsort(key)
    outs = fn(org[perm], dirn[perm], tnear[perm], tfar[perm])
    if n_outs == 1:
        outs = (outs,)
    # unsort by scatter (an inverse-permutation argsort would cost a
    # second full sort)
    outs = tuple(jnp.zeros_like(o).at[perm].set(o) for o in outs)
    return outs[0] if n_outs == 1 else outs


def hitpoint_sort_perm(org, bbox_lo, bbox_hi, live=None):
    """One origin-Morton argsort to be shared (via sorted_call's `perm`)
    by every same-origin traversal batch of a bounce: the bounce's NEE
    shadow rays all start at the same hit points, so for nl lights this
    replaces an nl*R-ray argsort with an R-ray one.  Dead/invalid rays
    (live=False) sort to the end."""
    key = ray_sort_key(org, jnp.ones_like(org), bbox_lo,
                       bbox_hi) & jnp.uint32(0x7FFF)
    if live is not None:
        key = key | ((~live).astype(jnp.uint32) << jnp.uint32(30))
    return jnp.argsort(key)


def tile_perm(perm, n_seg: int, r: int):
    """Concatenated-batch permutation: segment s keeps its rays in
    `perm` order (segment-major layout, one argsort total)."""
    return (jnp.arange(n_seg, dtype=perm.dtype)[:, None] * r
            + perm[None, :]).reshape(-1)
