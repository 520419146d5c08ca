"""Texture table: all scene images packed into one flat RGBA buffer.

The reference fetches texels through virtual `Texture::get` with per-object
image pointers (`textures/Bilinear.h`, `textures/nearestneighbor.h`).
Here the textures become ONE flat (P, 4) float buffer plus per-texture
(offset, width, height, filter, invert) metadata, so a whole wavefront's
fetches are 1 or 4 gathers regardless of how many images the scene uses.

Filtering semantics are bit-faithful to the reference:
* wrap: fractional repeat `p - floor(p)` on both filters;
* bilinear (Bilinear.h:23-36): u = s*W - .5 with x clamped to [0, W-2]
  (note the reference's edge behavior: the rightmost/bottom texel row is
  only reached via the +1 neighbor) and the optional `invert` flag;
* nearest (nearestneighbor.h): floor(s*W) clamped to [0, W-1].
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

FILTER_NEAREST = 0
FILTER_BILINEAR = 1


@dataclass
class TextureTableBuilder:
    """Host-side accumulator; `build()` returns the device dict."""
    datas: list = field(default_factory=list)
    offs: list = field(default_factory=list)
    widths: list = field(default_factory=list)
    heights: list = field(default_factory=list)
    filters: list = field(default_factory=list)
    inverts: list = field(default_factory=list)
    _cursor: int = 0
    _cache: dict = field(default_factory=dict)

    def add(self, image: np.ndarray, filter: int = FILTER_BILINEAR,
            invert: bool = False, key=None) -> int:
        """image: (H, W, 3|4) float or uint8. Returns texture id."""
        if key is not None and (key, filter, invert) in self._cache:
            return self._cache[(key, filter, invert)]
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        h, w = img.shape[:2]
        tid = len(self.offs)
        self.datas.append(img.reshape(-1, 4))
        self.offs.append(self._cursor)
        self.widths.append(w)
        self.heights.append(h)
        self.filters.append(filter)
        self.inverts.append(invert)
        self._cursor += h * w
        if key is not None:
            self._cache[(key, filter, invert)] = tid
        return tid

    def build(self) -> dict:
        if not self.datas:
            # 1x1 white fallback so gathers always have a target
            self.add(np.ones((1, 1, 4), np.float32))
        return {
            'data': jnp.asarray(np.concatenate(self.datas, axis=0)),
            'off': jnp.asarray(self.offs, jnp.int32),
            'w': jnp.asarray(self.widths, jnp.int32),
            'h': jnp.asarray(self.heights, jnp.int32),
            'filter': jnp.asarray(self.filters, jnp.int32),
            'invert': jnp.asarray(self.inverts, jnp.int32),
        }


def fetch(table: dict, tid, uv):
    """Gathered texel fetch. tid: (...,) i32 (clamped; callers mask tid<0
    to white); uv: (..., 2). Returns (..., 4) RGBA."""
    safe_tid = jnp.maximum(tid, 0)
    off = table['off'][safe_tid]
    w = table['w'][safe_tid]
    h = table['h'][safe_tid]
    filt = table['filter'][safe_tid]
    inv = table['invert'][safe_tid]

    s = uv[..., 0] - jnp.floor(uv[..., 0])
    t = uv[..., 1] - jnp.floor(uv[..., 1])
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)

    # ---- bilinear path (Bilinear.h) ----
    u = s * wf - 0.5
    v = t * hf - 0.5
    x0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, jnp.maximum(w - 2, 0))
    y0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, jnp.maximum(h - 2, 0))
    ur = (u - x0.astype(jnp.float32))[..., None]
    vr = (v - y0.astype(jnp.float32))[..., None]
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)

    def texel(x, y):
        return table['data'][off + y * w + x]

    c_bi = ((texel(x0, y0) * (1 - ur) + texel(x1, y0) * ur) * (1 - vr)
            + (texel(x0, y1) * (1 - ur) + texel(x1, y1) * ur) * vr)

    # ---- nearest path (nearestneighbor.h) ----
    xn = jnp.clip((s * wf).astype(jnp.int32), 0, w - 1)
    yn = jnp.clip((t * hf).astype(jnp.int32), 0, h - 1)
    c_nn = texel(xn, yn)

    c = jnp.where((filt == FILTER_BILINEAR)[..., None], c_bi, c_nn)
    c = jnp.where((inv != 0)[..., None], 1.0 - c, c)
    # missing texture (tid < 0) -> opaque white
    return jnp.where((tid < 0)[..., None], 1.0, c)
