"""Precomputed sample-set mode: the reference's exact sample sequences.

The reference precomputes 64 sample sets x spp `PrecomputedSample`s per
iteration chunk (`devices/device_singleray/samplers/sampler.cpp:85-160`)
from one serial RNG, and each pixel picks a set with a tile-seeded RNG
(`renderers/integratorrenderer.cpp:134,149`).  The default sampler
(`sampling/patterns.py`) replaces this with stateless per-ray hashing —
variance-neutral, but it makes bit-level A/B against a CPU build of the
reference impossible.  This module reproduces the reference's sequences
*exactly* so such an A/B becomes possible:

* `Ran1` — the Park-Miller MINSTD LCG with a 32-entry Bays-Durham
  shuffle table (Numerical Recipes `ran1`), matching
  `common/math/random.h:28-80` bit-for-bit including the `setSeed`
  warm-up walk, the int->float32 conversion in `getFloat`, and the
  `1.0f - FLT_EPSILON` clamp.
* `jittered` / `multi_jittered` — `samplers/patterns.h:28-68`: the
  in-place Fisher-Yates-with-replacement `Permutation`
  (`common/math/permutation.h:42-48`), the PERSISTENT `numbers` vector
  that carries shuffle state across grid rows (`vector_t::shuffle`,
  `common/sys/stl/vector.h:129-133`), and the transposed y-write
  (`patterns.h:56-61`) are all reproduced, with float32 arithmetic at
  every expression the C++ evaluates in float.
* `build_tables` — `SamplerFactory::init` (`sampler.cpp:85-160`):
  spp rounded up to a power of two, chunkSize = max(spp, 64), chunk
  seed = currentChunk * 5897, per set: multiJittered pixel, jittered
  time, multiJittered lens, then `numSamples1D` jittered dims followed
  by `numSamples2D` multiJittered dims, sliced at the iteration's
  offset.  The PathTraceIntegrator's request layout
  (`pathtraceintegrator.cpp:35-46`) is: 2D dim 0 = the shared NEE
  light sample, 2D dims 1..maxDepth = per-depth scatter direction,
  1D dims 0..maxDepth-1 = per-depth scatter-type (REUSED by Russian
  roulette, cpp:179+189).
* `bspline_warp` — the tabulated filter importance sampling
  (`filters/filter.cpp:22-44`, `filters/bsplinefilter.h:25-43`,
  `samplers/distribution1d.cpp:42-75`): a 256x256 table of the RADIAL
  cubic B-spline (the reference's filter is radial, not the separable
  tensor-product spline the stateless sampler uses), warped by step-CDF
  inversion.  Known divergence: the reference's SSE scalar `rcp`
  (`math/math.h:38-45`, `_mm_rcp_ps` + Newton) is a hardware
  approximation; we use exact division, so warped *fractions* can
  differ from an SSE build by <= 2 ulp.  Everything upstream of the
  warp (the raw RNG/jitter sequences) is bit-exact.
* `tile_set_ids` — the per-pixel set pick: one `Random(tile_x*91711 +
  tile_y*81551 + 3433*firstActiveLine)` per 16x16 tile, one
  `getInt(64)` per in-bounds pixel in tile scan order
  (`integratorrenderer.cpp:131-149`).

Not reproduced (not reproducible in the reference either): the shadow
tMax jitter draws the GLOBAL `random<float>()` system RNG
(`pathtraceintegrator.cpp:152`), so it is run-to-run random even in the
reference; this path keeps its stateless hash there.

Host-side only: tables are small ((64, spp, ~4*maxDepth) float32) and
are uploaded once per frame; the device render gathers from them.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

_F = np.float32
_M = 2147483647
_ONE_MINUS_ULP = _F(1.0) - _F(2.0) ** -23   # 1.0f - float(ulp), constants.h:116
_NTAB = 32
_NDIV = 1 + (_M - 1) // _NTAB               # random.h:63


def next_pow2(n: int) -> int:
    """RoundUpPow2 (sampler.cpp:91)."""
    p = 1
    while p < n:
        p <<= 1
    return p


class Ran1:
    """Bit-exact `embree::Random` (common/math/random.h:24-80)."""

    __slots__ = ('seed', 'state', 'table')

    def __init__(self, seed: int = 27):
        self.set_seed(seed)

    def set_seed(self, s: int) -> None:
        # random.h:32-50: normalize, then a 40-step warm-up filling the
        # shuffle table top-down; state starts at table[0]
        if s == 0:
            s = 1
        elif s < 0:
            s = -s
        table = [0] * _NTAB
        for j in range(_NTAB + 7, -1, -1):
            k = s // 127773
            s = 16807 * (s - k * 127773) - 2836 * k
            if s < 0:
                s += _M
            if j < _NTAB:
                table[j] = s
        self.seed = s
        self.table = table
        self.state = table[0]

    def get_int(self, limit: int | None = None) -> int:
        # random.h:53-70: advance the LCG, swap through the shuffle table
        s = self.seed
        k = s // 127773
        s = 16807 * (s - k * 127773) - 2836 * k
        if s < 0:
            s += _M
        self.seed = s
        j = self.state // _NDIV
        self.state = self.table[j]
        self.table[j] = s
        return self.state if limit is None else self.state % limit

    def get_float(self) -> np.float32:
        # random.h:72: min(getInt()/2147483647.0f, 1.0f-ulp) in float32
        return min(_F(self.get_int()) / _F(_M), _ONE_MINUS_ULP)

    def get_floats(self, n: int) -> np.ndarray:
        ints = np.array([self.get_int() for _ in range(n)], np.int64)
        return np.minimum(ints.astype(_F) / _F(_M), _ONE_MINUS_ULP)


def permutation(n: int, rng: Ran1) -> np.ndarray:
    """permutation.h:42-48: swap(perm[i], perm[getInt(n)]) for each i."""
    perm = list(range(n))
    for i in range(n):
        j = rng.get_int(n)
        perm[i], perm[j] = perm[j], perm[i]
    return np.asarray(perm, np.int64)


def _shuffle(numbers: list, rng: Ran1) -> None:
    """vector_t::shuffle (vector.h:129-133) — in place, state persists."""
    n = len(numbers)
    for i in range(n):
        j = rng.get_int(n)
        numbers[i], numbers[j] = numbers[j], numbers[i]


def jittered(n: int, rng: Ran1) -> np.ndarray:
    """patterns.h:28-35: samples[perm[i]] = (i + getFloat()) / n."""
    perm = permutation(n, rng)
    f = rng.get_floats(n)
    scale = _F(1.0) / _F(n)
    vals = (np.arange(n, dtype=_F) + f) * scale
    out = np.empty(n, _F)
    out[perm] = vals
    return out


def multi_jittered(n: int, rng: Ran1) -> np.ndarray:
    """patterns.h:39-68 -> (n, 2) float32.

    b = (uint32)sqrtf(float(N)) (+1 if b*b<N); the `numbers` stratum
    vector is shuffled per row but NEVER reset; x fills grid rows
    (grid[i][j].x), y fills transposed (grid[j][i].y); a final
    Permutation(N) scatters grid cells (row-major np/b, np%b) to samples.
    """
    b = int(_F(np.sqrt(_F(n))))
    if b * b < n:
        b += 1
    fb = _F(b)
    fb2 = _F(b * b)
    gx = np.empty((b, b), _F)
    gy = np.empty((b, b), _F)
    numbers = list(range(b))
    for i in range(b):
        _shuffle(numbers, rng)
        f = rng.get_floats(b)
        gx[i, :] = _F(i) / fb + (np.asarray(numbers, _F) + f) / fb2
    for i in range(b):
        _shuffle(numbers, rng)
        f = rng.get_floats(b)
        gy[:, i] = _F(i) / fb + (np.asarray(numbers, _F) + f) / fb2
    perm = permutation(n, rng)
    r, c = perm // b, perm % b
    return np.stack([gx[r, c], gy[r, c]], axis=-1)


# ---------------------------------------------------------------------------
# Tabulated pixel-filter importance sampling (filter.cpp:22-44)

@lru_cache(maxsize=2)
def _bspline_table(table_size: int = 256, width: float = 4.0):
    """256x256 |radial cubic B-spline| table + its step-CDF rows/cols
    (bsplinefilter.h:30-42 eval; distribution1d.cpp:42-62 init).

    Returns (row_cdf (T, T+1), y_cdf (T+1,)) as float32 — the exact
    accumulation order of Distribution1D::init (serial float32 sums).
    """
    t = table_size
    idx = (np.arange(t, dtype=_F) + _F(0.5)) / _F(t) * _F(width) \
        - _F(width) * _F(0.5)
    px, py = np.meshgrid(idx, idx, indexing='xy')        # f[y][x]
    d = np.sqrt(px * px + py * py).astype(_F)
    near = _F(1.0) - d
    v_near = ((((_F(-3.0) * near) + _F(3.0)) * near + _F(3.0)) * near
              + _F(1.0)) / _F(6.0)
    far = _F(2.0) - d
    v_far = far * far * far / _F(6.0)
    f = np.where(d > 2.0, _F(0.0), np.where(d < 1.0, v_near, v_far))
    f = np.abs(f).astype(_F)

    def cdf_rows(vals):                 # serial f32 accumulation
        c = np.zeros(vals.shape[:-1] + (vals.shape[-1] + 1,), _F)
        for i in range(vals.shape[-1]):
            c[..., i + 1] = c[..., i] + vals[..., i]
        tot = c[..., -1:]
        with np.errstate(divide='ignore', invalid='ignore'):
            c = np.where(tot > 0, c / tot, c)
        c[..., -1] = 1.0
        return c.astype(_F)

    row_cdf = cdf_rows(f)                      # per y-row, over x
    y_cdf = cdf_rows(f.sum(axis=1, dtype=_F))  # over y (row sums)
    return row_cdf, y_cdf


def _cdf_invert(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Distribution1D::sample (distribution1d.cpp:65-74): upper_bound,
    then linear step-function refinement.  Exact division stands in for
    the reference's approximate SSE rcp (documented header divergence)."""
    size = cdf.shape[-1] - 1
    if cdf.ndim == 1:
        idx = np.clip(np.searchsorted(cdf, u, side='right') - 1,
                      0, size - 1)
        lo, hi = cdf[idx], cdf[idx + 1]
    else:                                   # per-row CDFs, row picked per u
        idx = np.empty(u.shape, np.int64)
        for i in range(u.shape[0]):         # rows vary per sample
            idx[i] = np.searchsorted(cdf[i], u[i], side='right') - 1
        idx = np.clip(idx, 0, size - 1)
        rows = np.arange(u.shape[0])
        lo, hi = cdf[rows, idx], cdf[rows, idx + 1]
    frac = (u - lo) / np.maximum(hi - lo, np.finfo(_F).tiny)
    return (idx.astype(_F) + frac.astype(_F)).astype(_F)


def bspline_warp(uv: np.ndarray, table_size: int = 256,
                 width: float = 4.0) -> np.ndarray:
    """Filter::sample (filter.cpp:37-44): u.y picks a table row via the
    y-CDF, u.x refines within the row; outputs in [-width/2, width/2)."""
    row_cdf, y_cdf = _bspline_table(table_size, width)
    sy = _cdf_invert(y_cdf, uv[:, 1].astype(_F))
    y_idx = np.clip(sy.astype(np.int64), 0, table_size - 1)
    sx = _cdf_invert(row_cdf[y_idx], uv[:, 0].astype(_F))
    w, hw = _F(width), _F(width) * _F(0.5)
    return np.stack([sx / _F(table_size) * w - hw,
                     sy / _F(table_size) * w - hw], axis=-1)


# ---------------------------------------------------------------------------
# SamplerFactory::init (sampler.cpp:85-160)

def build_tables(spp: int, iteration: int = 0, num_1d: int = 0,
                 num_2d: int = 0, sets: int = 64,
                 pixel_filter: str = 'bspline') -> dict:
    """Precompute `sets` sample sets for one iteration's spp chunk.

    Returns numpy float32 arrays: pixel (sets, spp2, 2) — filter applied
    (+0.5 pixel-center shift, integratorrenderer.cpp:157 consumes it as
    (x + pixel.x)/width), time (sets, spp2), lens (sets, spp2, 2),
    s1d (sets, spp2, num_1d), s2d (sets, spp2, num_2d, 2); spp2 =
    RoundUpPow2(spp).
    """
    spp2 = next_pow2(spp)
    chunk = max(spp2, 64)
    current = (iteration * spp2) // chunk
    off = (iteration * spp2) % chunk
    rng = Ran1()
    rng.set_seed(current * 5897)            # sampler.cpp:97

    pixel = np.empty((sets, spp2, 2), _F)
    time = np.empty((sets, spp2), _F)
    lens = np.empty((sets, spp2, 2), _F)
    s1d = np.empty((sets, spp2, num_1d), _F)
    s2d = np.empty((sets, spp2, num_2d, 2), _F)
    sel = slice(off, off + spp2)
    for s in range(sets):
        px = multi_jittered(chunk, rng)[sel]
        time[s] = jittered(chunk, rng)[sel]
        lens[s] = multi_jittered(chunk, rng)[sel]
        if pixel_filter == 'bspline':
            px = bspline_warp(px) + _F(0.5)     # sampler.cpp:119
        pixel[s] = px
        for d in range(num_1d):
            s1d[s, :, d] = jittered(chunk, rng)[sel]
        for d in range(num_2d):
            s2d[s, :, d] = multi_jittered(chunk, rng)[sel]
    return dict(pixel=pixel, time=time, lens=lens, s1d=s1d, s2d=s2d)


@lru_cache(maxsize=4)
def tile_set_ids(width: int, height: int, first_active_line: int = 0,
                 sets: int = 64, tile: int = 16) -> np.ndarray:
    """Per-pixel sample-set pick, (height*width,) int32.

    One tile-seeded RNG per 16x16 tile (integratorrenderer.cpp:134),
    one getInt(sets) per IN-BOUNDS pixel in tile scan order (cpp:149;
    out-of-bounds rows/cols are `continue`d before the draw)."""
    ids = np.zeros((height, width), np.int32)
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    for tyi in range(nty):
        for txi in range(ntx):
            tx, ty = txi * tile, tyi * tile
            rng = Ran1(tx * 91711 + ty * 81551
                       + 3433 * first_active_line)
            for dy in range(tile):
                y = ty + dy
                if y >= height:
                    continue
                for dx in range(tile):
                    x = tx + dx
                    if x >= width:
                        continue
                    ids[y, x] = rng.get_int(sets)
    return ids.reshape(-1)
