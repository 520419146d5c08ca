"""Accumulation film: the AccuBuffer / SwapChain as device arrays.

Reference semantics (`devices/device_singleray/api/framebuffer.h:229-327`,
`api/swapchain.h:29-123`): the AccuBuffer stores per pixel an RGB *sum* and a
*weight*; `update(x, y, color, weight, accumulate)` either overwrites or adds,
and returns the normalized color sum/weight.  Progressive refinement keeps
adding spp chunks across frames ("iterations") and is resumable because the
sampler draws deterministic chunks (sampler.cpp:93-97).

Here the film is an immutable pytree `(rgb_sum, weight)` of (H, W) arrays;
`accumulate()` is a pure function so it jits/shards cleanly, and serializing
the pytree gives true checkpoint/resume (SURVEY.md section 5) which the
reference lacked.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Film(NamedTuple):
    rgb_sum: jnp.ndarray   # (H, W, 3) f32
    weight: jnp.ndarray    # (H, W)   f32

    @property
    def height(self):
        return self.rgb_sum.shape[0]

    @property
    def width(self):
        return self.rgb_sum.shape[1]


def create(height: int, width: int) -> Film:
    return Film(jnp.zeros((height, width, 3), jnp.float32),
                jnp.zeros((height, width), jnp.float32))


def accumulate(film: Film, rgb, weight, reset: bool = False) -> Film:
    """Add one iteration's weighted sums. rgb: (H, W, 3), weight: (H, W).

    reset=True reproduces accumulate=0 (overwrite) of AccuBuffer::update.
    """
    if reset:
        return Film(jnp.asarray(rgb, jnp.float32),
                    jnp.asarray(weight, jnp.float32))
    return Film(film.rgb_sum + rgb, film.weight + weight)


def resolve(film: Film):
    """Normalized color = sum / weight (framebuffer.h AccuBuffer::update)."""
    w = jnp.maximum(film.weight, 1e-12)[..., None]
    return film.rgb_sum / w


def to_numpy_checkpoint(film: Film) -> dict:
    return {"rgb_sum": np.asarray(film.rgb_sum),
            "weight": np.asarray(film.weight)}


def from_numpy_checkpoint(d: dict) -> Film:
    return Film(jnp.asarray(d["rgb_sum"]), jnp.asarray(d["weight"]))
