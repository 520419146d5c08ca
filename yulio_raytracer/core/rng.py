"""Counter-based, stateless RNG for wavefront rendering.

The reference renderer uses per-thread mutable `Random` state plus
precomputed multi-jittered sample sets keyed by tile coordinates
(`samplers/sampler.cpp:85-160`, seed from tile + firstActiveLine
`integratorrenderer.cpp:134`), which makes renders deterministic per
(scene, spp, serverID).  On an accelerator the idiomatic equivalent is
a *stateless* counter-based hash: every random number is a pure function
of (seed, pixel_id, sample_id, bounce, dimension), so results are
independent of sharding/layout — the same determinism property, without
any state.

The mixer below uses only CONSTANT multipliers (the 'lowbias32'
finalizer family, Chris Wellons' exhaustive-searched constants, public
domain): cheap integer work on any backend at pcg4d-equal render
quality.
"""
from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32
_INV_2_32 = float(2.0 ** -32)


def _as_u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def _mix(h):
    """lowbias32 finalizer — constant multiplies only."""
    h = h ^ (h >> 16)
    h = h * _U32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * _U32(0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _key(a, b, c, d):
    """Combine four u32 streams with distinct odd constants (vector *
    constant multiplies), then finalize."""
    h = (_as_u32(a) * _U32(0x9E3779B1)
         ^ _as_u32(b) * _U32(0x85EBCA77)
         ^ _as_u32(c) * _U32(0xC2B2AE3D)
         ^ _as_u32(d) * _U32(0x27D4EB2F))
    return _mix(h)


def pcg4d(a, b, c, d):
    """Four decorrelated u32 streams from four u32 inputs (keeps the
    historical name; the implementation is the constant-multiplier mixer
    described in the module docstring)."""
    h = _key(a, b, c, d)
    v0 = _mix(h ^ _U32(0x632BE59B))
    v1 = _mix(h ^ _U32(0x85EBCA6B))
    v2 = _mix(h ^ _U32(0xC2B2AE35))
    v3 = _mix(h ^ _U32(0x27D4EB2F))
    return v0, v1, v2, v3


def _to_unit_float(u):
    """u32 -> float32 in [0, 1)."""
    return u.astype(jnp.float32) * jnp.float32(_INV_2_32)


def uniform1(seed, pixel_id, sample_id, dim):
    """One float in [0,1) per lane."""
    return _to_unit_float(_key(seed, pixel_id, sample_id, dim))


def uniform2(seed, pixel_id, sample_id, dim):
    """Two floats in [0,1) per lane, shape (..., 2)."""
    h = _key(seed, pixel_id, sample_id, dim)
    return jnp.stack([_to_unit_float(_mix(h ^ _U32(0x632BE59B))),
                      _to_unit_float(_mix(h ^ _U32(0x85EBCA6B)))], axis=-1)


def uniform3(seed, pixel_id, sample_id, dim):
    h = _key(seed, pixel_id, sample_id, dim)
    return jnp.stack([_to_unit_float(_mix(h ^ _U32(0x632BE59B))),
                      _to_unit_float(_mix(h ^ _U32(0x85EBCA6B))),
                      _to_unit_float(_mix(h ^ _U32(0xC2B2AE35)))], axis=-1)


def hash_u32(a, b=0, c=0, d=0):
    """A single decorrelated u32 (e.g. for stratum permutation)."""
    return _key(a, b, c, d)
