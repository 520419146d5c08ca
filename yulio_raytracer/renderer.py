"""Frame rendering: the RenderJob / renderTile pipeline as ray-batch passes.

The reference renders 16x16 tiles stolen off an atomic counter by a thread
pool (`renderers/integratorrenderer.cpp:63-185`).  Here the frame
renders as a sequence of dense ray *chunks* (pixels x samples),
each one jitted pass over the wavefront integrator; chunking bounds device
memory the way tiles bounded cache footprint.  Progressive refinement
("accumulate" mode, glutdisplay/outputMode) maps to film accumulation with
the iteration index salted into the RNG stream — deterministic and
resumable exactly like the reference's precomputed sample chunks
(`sampler.cpp:93-97`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .film import accum
from .integrator import pathtracer
from .sampling import patterns

# RNG dims reserved for the camera
DIM_PIXEL = 0
DIM_LENS = 1
DIM_TIME = 2   # motion-blur time sample (sampler.h getTime)


def _gen_rays(scene, camera, width, height, spp, pixel_ids, sample_ids,
              seed, pixel_filter: str = 'box', samples=None):
    """Camera-sample generation shared by the scan and compacted chunk
    paths: returns (org, dirn, uv, time, trace_samples).

    samples: optional precomputed sample-set tables (the reference's
    SamplerFactory mode, sampling/precomputed.py) — pixel/lens/time come
    from table gathers keyed by the pixel's tile-seeded set pick
    (integratorrenderer.cpp:149-160) instead of stateless hashing."""
    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)
    trace_samples = None
    if samples is not None:
        sset = samples['set_ids'][pixel_ids].astype(jnp.int32)
        sidx = (sample_ids - samples['base']).astype(jnp.int32)
        juv = samples['pixel'][sset, sidx]      # filter already applied
        lens = samples['lens'][sset, sidx]
        trace_samples = dict(set=sset, sidx=sidx,
                             s1d=samples['s1d'], s2d=samples['s2d'])
    elif pixel_filter == 'bspline':
        juv = patterns.pixel_sample_bspline(seed, pixel_ids, sample_ids,
                                            spp, DIM_PIXEL)
    else:
        juv = patterns.pixel_sample(seed, pixel_ids, sample_ids, spp,
                                    DIM_PIXEL)
    if samples is None:
        lens = patterns.sample_2d(seed, pixel_ids, sample_ids,
                                  jnp.uint32(DIM_LENS))
    uv = jnp.stack([(px + juv[:, 0]) / width,
                    (py + juv[:, 1]) / height], axis=-1)
    org, dirn = camera.ray(uv, lens)
    if 'mv0' in scene.geom:
        time = (samples['time'][sset, sidx] if samples is not None else
                patterns.sample_1d(seed, pixel_ids, sample_ids,
                                   jnp.uint32(DIM_TIME)))
    else:
        time = None
    return org, dirn, uv, time, trace_samples


def _trace_one_sample(scene, camera, params, width, height, spp,
                      pixel_ids, sample_ids, seed, backplate=None,
                      pixel_filter: str = 'box', samples=None):
    """Generate + integrate one camera sample per listed pixel."""
    org, dirn, uv, time, trace_samples = _gen_rays(
        scene, camera, width, height, spp, pixel_ids, sample_ids, seed,
        pixel_filter, samples)
    return pathtracer.trace(scene, params, org, dirn, seed,
                            pixel_ids, sample_ids, pixel_uv=uv,
                            backplate=backplate, time=time,
                            samples=trace_samples)


def _chunk_body(scene, camera, params, width, height, spp,
                pixel_ids, sample0, seed, backplate,
                spp_per_pass: int, pixel_filter: str, samples=None):
    """`spp_per_pass` camera samples for each listed pixel, accumulated
    on-device in a lax.scan (one dispatch renders the whole sample
    chunk).  Returns ((B, 3) radiance SUM, ray count)."""
    seed = jnp.uint32(seed)

    def body(carry, s):
        rgb_sum, nrays = carry
        rgb, nr = _trace_one_sample(scene, camera, params, width, height,
                                    spp, pixel_ids, sample0 + s, seed,
                                    backplate, pixel_filter, samples)
        return (rgb_sum + rgb, nrays + nr), None

    init = (jnp.zeros((pixel_ids.shape[0], 3)), jnp.zeros((), jnp.float32))
    (rgb_sum, nrays), _ = jax.lax.scan(
        body, init, jnp.arange(spp_per_pass, dtype=jnp.uint32))
    return rgb_sum, nrays


@partial(jax.jit, static_argnames=('params', 'width', 'height',
                                   'spp_per_pass', 'pixel_filter'))
def _render_chunk(scene, camera, params, width, height, spp,
                  pixel_ids, sample0, seed, backplate=None,
                  spp_per_pass: int = 1, pixel_filter: str = 'box',
                  samples=None):
    """One jitted single-device pass over _chunk_body.

    spp is TRACED — pass patterns.grid_scalars(spp) (a 4-scalar
    stratification grid), so one compiled graph serves an spp sweep
    (PARITY 'dynamic spp' item): the sampler consumes only the grid
    scalars, and they're f32-rounded on the host exactly like the old
    static path's constants, so results are bit-identical per spp."""
    return _chunk_body(scene, camera, params, width, height, spp,
                       pixel_ids, sample0, seed, backplate,
                       spp_per_pass, pixel_filter, samples)


@partial(jax.jit, static_argnames=('width', 'height', 'pixel_filter'))
def _raygen_jit(scene, camera, width, height, spp, pixel_ids, sample_ids,
                seed, pixel_filter: str = 'box', samples=None):
    """Jitted camera-sample generation for the compacted chunk path."""
    return _gen_rays(scene, camera, width, height, spp, pixel_ids,
                     sample_ids, seed, pixel_filter, samples)


def _render_chunk_compact(scene, camera, params, width, height, spp,
                          pixel_ids, sample0, seed, backplate=None,
                          pixel_filter: str = 'box', samples=None,
                          bounce_stats=None):
    """Host-driven chunk: one dispatch per bounce with live-ray
    compaction between bounces (pathtracer.trace_compacted — the
    wavefront analog of the reference's recursion simply stopping,
    pathtraceintegrator.cpp:169-182).  Contract of _render_chunk at
    spp_per_pass=1: returns ((B, 3) radiance sum, ray count)."""
    org, dirn, uv, time, trace_samples = _raygen_jit(
        scene, camera, width, height, spp, pixel_ids, sample0,
        np.uint32(seed), pixel_filter, samples)
    return pathtracer.trace_compacted(
        scene, params, org, dirn, seed, pixel_ids, sample0,
        pixel_uv=uv, backplate=backplate, time=time,
        samples=trace_samples, bounce_stats=bounce_stats)


@partial(jax.jit, static_argnames=('params', 'width', 'height',
                                   'spp_per_pass', 'pixel_filter', 'mesh'))
def _render_chunk_sharded(scene, camera, params, width, height, spp,
                          pixel_ids, sample0, seed, backplate=None,
                          spp_per_pass: int = 1, pixel_filter: str = 'box',
                          mesh=None, samples=None):
    """One jitted MULTI-DEVICE pass: the same _chunk_body shard_mapped
    over the mesh's 'px' axis (scene/camera replicated — the reference's
    one-time scene broadcast to render servers, network_device.cpp:100).

    The caller guarantees len(pixel_ids) divides by the px axis size.
    Rays are keyed by
    absolute (pixel, sample) ids, so renders are bit-identical across
    runs for a FIXED mesh; across device counts they agree to float
    association (XLA fuses per-shard shapes differently — observed max
    1 ulp on CPU)."""
    from jax.sharding import PartitionSpec as P

    def shard_fn(scene_l, camera_l, spp_l, pid, s0, bp, seed_l, samples_l):
        rgb, nrays = _chunk_body(scene_l, camera_l, params, width, height,
                                 spp_l, pid, s0, seed_l, bp,
                                 spp_per_pass, pixel_filter, samples_l)
        return rgb, jax.lax.psum(nrays, 'px')

    repl = lambda tree: jax.tree.map(lambda _: P(), tree)
    rgb, nrays = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(repl(scene), repl(camera), repl(spp), P('px'), P('px'),
                  repl(backplate), P(), repl(samples)),
        out_specs=(P('px'), P()),
        check_vma=False,
    )(scene, camera, spp, pixel_ids, sample0, backplate, jnp.uint32(seed),
      samples)
    return rgb, nrays


@lru_cache(maxsize=8)
def _tile_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Ray-order permutation: consecutive rays cover `tile` x `tile` pixel
    blocks, so neighbouring traversal lanes (a GPU warp, a kernel block)
    hold neighbouring camera rays that walk similar BVH paths.  The
    reference's 16x16 CPU tiles (integratorrenderer.cpp:63-185) exist for
    cache locality, the same idea one level up."""
    yy, xx = np.mgrid[0:height, 0:width]
    yy, xx = yy.ravel(), xx.ravel()
    tiles_x = (width + tile - 1) // tile
    tile_id = (yy // tile) * tiles_x + (xx // tile)
    order = np.lexsort((xx % tile, yy % tile, tile_id))
    return order.astype(np.uint32)


# Pass sizing: rays per pass (per device) start at the frame's own ray
# count, at most _MAX_PASS_RAYS, and halve until one bounce's compiled
# footprint (bounce_step memory_analysis: arguments + outputs +
# temporaries) fits _PASS_MEMORY_SHARE of the device's free memory.  A
# one-sample frame is probed at the width it then runs, so the
# persistent compilation cache serves its first bounce from the probe.
# The other half of free memory covers the film, the scene tables and
# the traversal's sorted copies.  Backends without memory statistics
# (the CPU) take the starting width.
_MAX_PASS_RAYS = 1 << 22
_MIN_PASS_RAYS = 1 << 16
_PASS_MEMORY_SHARE = 0.5
_budget_cache = {}


def _free_device_bytes():
    stats = jax.devices()[0].memory_stats()
    if not stats or 'bytes_limit' not in stats:
        return None
    return stats['bytes_limit'] - stats.get('bytes_in_use', 0)


def _pass_budget(scene, params, n_px: int, n_rays: int):
    """Per-pass ray budget.  Returns (max_rays_per_pass,
    spp_per_pass_cap or None); on a mesh the budget is per DEVICE
    times n_px.  n_rays is the frame's total (pixels x samples): frames
    at or below _MIN_PASS_RAYS need no probe.

    BVH path: memory-sized as above, one sample per pass (the compacted
    driver and the scan form both hold one bounce's state at a time).

    Dense path (no BVH): the triangle test materializes O(rays x
    tri_block) f32 temporaries — ~0.75 GB per (rays x tri_block) set at
    the formula below."""
    if scene.bvh is None:
        t_block = min(max(scene.num_triangles, 1), 2048)
        max_rays = int(min(1 << 21, max(1 << 14, (3 << 26) // t_block)))
        return max_rays * n_px, None
    max_rays = min(_MAX_PASS_RAYS, max(_MIN_PASS_RAYS, -(-n_rays // n_px)))
    free = _free_device_bytes() if n_rays > _MIN_PASS_RAYS else None
    if free is not None:
        skey = pathtracer.scene_key(scene)

        def bounce_bytes(w):
            # one compile per (scene shape, params, width) per process
            key = (skey, params, w)
            if key not in _budget_cache:
                _budget_cache[key] = pathtracer.bounce_bytes(scene, params,
                                                             w)
            return _budget_cache[key]

        while (max_rays // 2 >= _MIN_PASS_RAYS
               and bounce_bytes(max_rays) > _PASS_MEMORY_SHARE * free):
            max_rays //= 2
    return max_rays * n_px, 1


@dataclass
class FrameStats:
    num_rays: float = 0.0
    seconds: float = 0.0

    @property
    def mrps(self):
        return self.num_rays / max(self.seconds, 1e-9) / 1e6


def render_frame(scene, camera, params, width: int, height: int, spp: int,
                 film: Optional[accum.Film] = None, seed: int = 0,
                 iteration: int = 0, accumulate: bool = True,
                 max_rays_per_pass: Optional[int] = None,
                 spp_per_pass_cap: int = 8,
                 backplate=None, progress_cb=None, stop_flag=None,
                 pixel_filter: str = 'box', mesh=None,
                 sampler: str = 'stateless', compaction: str = 'auto',
                 bounce_stats=None):
    """Render spp samples/pixel into the film (creating it if needed).

    compaction: 'auto' (default) runs BVH-path single-device chunks as
    host-driven per-bounce dispatches with live-ray compaction between
    bounces (pathtracer.trace_compacted; bit-identical results) WHEN
    the config has bounces past the Russian-roulette start
    (max_depth > rr_depth) — that is where lanes die en masse and
    compaction pays; shallow configs have little to compact and keep
    the single-dispatch lax.scan form with its smaller compile family.
    'on' forces the compacted driver at any
    max_depth > 1;
    'off' keeps the scan form.  The sharded (mesh) and dense paths
    always use the scan form.  bounce_stats: optional list collecting
    per-bounce {'depth','width','live','seconds'} dicts from every
    compacted chunk (the production phase profile).

    sampler: 'stateless' (default — per-ray hashed stratification) or
    'precomputed' — the reference's 64-sample-set mode
    (sampler.cpp:85-160 sequences, bit-exact per
    sampling/precomputed.py), enabling sample-level A/B against a CPU
    build of the reference.  Precomputed tables cover
    RoundUpPow2(spp) samples; pass a power-of-two spp for exact parity.

    Deterministic per (scene, spp, seed, iteration).  Returns
    (film, FrameStats).  `progress_cb(fraction)` mirrors the reference's
    per-tile progress callback (integratorrenderer.cpp:178).

    Memory scaling: passes are sized from the device's free memory
    (_pass_budget) unless max_rays_per_pass overrides it.

    mesh: optional jax.sharding.Mesh with a 'px' axis — each pass is
    shard_mapped over it (pixel data parallelism, the production
    multi-chip path: the `-connect` render-server fan-out of
    renderer.cpp:948-956 expressed as shardings).  Results are
    bit-identical to the single-device path; chunking, progress, and
    stop work identically (per-pass budgets scale by the device count).
    """
    import time
    if compaction not in ('auto', 'on', 'off'):
        raise ValueError("compaction must be 'auto', 'on' or 'off', got "
                         f"{compaction!r}")
    compact_on = (compaction == 'on'
                  or (compaction == 'auto'
                      and params.max_depth > params.rr_depth))
    samples = None
    if sampler == 'precomputed':
        from .sampling import precomputed as pc
        tabs = pc.build_tables(spp, iteration,
                               num_1d=params.max_depth,
                               num_2d=1 + params.max_depth,
                               pixel_filter=pixel_filter)
        samples = {k: jnp.asarray(v) for k, v in tabs.items()}
        samples['set_ids'] = jnp.asarray(pc.tile_set_ids(width, height))
        samples['base'] = jnp.uint32(iteration * spp)
    elif sampler != 'stateless':
        raise ValueError("sampler must be 'stateless' or 'precomputed'")
    n_px = 1
    if mesh is not None:
        n_px = int(np.prod(list(mesh.shape.values())))
        if 'tri' in mesh.shape and mesh.shape['tri'] > 1:
            raise ValueError(
                "render_frame meshes are pixel-parallel; use "
                "parallel.sharding.render_frame_sharded for a tri axis")
        if n_px == 1:
            mesh = None
    if film is None or not accumulate:
        film = accum.create(height, width)
    npix = width * height
    if max_rays_per_pass is None:
        max_rays_per_pass, cap = _pass_budget(scene, params, n_px,
                                              npix * spp)
        if cap is not None:
            spp_per_pass_cap = cap

    # split the frame into pixel ranges; each pass renders as many samples
    # per pixel as the ray budget allows, fully on-device
    t0 = time.perf_counter()
    total_rays = jnp.zeros((), jnp.float32)
    rgb_flat = film.rgb_sum.reshape(npix, 3)

    pix_per_pass = max(min(npix, max_rays_per_pass), 1)
    # shard_map divisibility: every device gets the same ray count
    pix_per_pass = -(-pix_per_pass // n_px) * n_px
    n_splits = (npix + pix_per_pass - 1) // pix_per_pass
    # sample-major batching (BVH path): when the whole frame fits in one
    # pass with room to spare, fold several SAMPLES of every pixel into
    # one ray batch instead of dispatching per sample: fewer dispatches
    # and sorts, and a wider sorted wavefront for the bounce traversals.
    # k must divide spp so every batch keeps one compiled shape.
    samples_per_batch = 1
    if (scene.bvh is not None and n_splits == 1 and spp > 1
            and pix_per_pass == npix):
        # fold cap 16: at production sizes the ray budget already binds
        # below 16, so the constant only quantizes SMALL frames —
        # bounding an spp sweep's distinct batch shapes at {1,2,4,8,16}
        # instead of one per spp (dynamic-spp contract)
        samples_per_batch = max(1, min(spp, max_rays_per_pass // npix, 16))
        # quantize to a power of two that divides spp: an spp sweep then
        # reuses at most log2(cap) compiled shapes instead of one per spp
        samples_per_batch = 1 << (samples_per_batch.bit_length() - 1)
        while spp % samples_per_batch:
            samples_per_batch >>= 1
    # spp folding costs no extra memory (the scan reuses one sample's
    # buffers), it only amortizes dispatch overhead
    spp_per_pass = max(min(spp, spp_per_pass_cap), 1)
    # the compiled chunk is spp-independent (grid scalars traced through
    # the jit boundary); graph count is bounded by the distinct
    # (spp_per_pass, shapes) pairs, not by the spp values swept
    spp_grid = patterns.grid_scalars(spp)
    n_spp_chunks = (spp + spp_per_pass * samples_per_batch - 1) \
        // (spp_per_pass * samples_per_batch)
    work = [(c, k) for c in range(n_spp_chunks) for k in range(n_splits)]
    order = _tile_order(width, height)
    for wi, (c, k) in enumerate(work):
        if stop_flag is not None and stop_flag():
            break
        lo = k * pix_per_pass
        hi = min(lo + pix_per_pass, npix)
        count = hi - lo
        # pad the ragged tail to keep one compiled shape
        sel = lo + (np.arange(pix_per_pass, dtype=np.int64) % max(count, 1))
        s0 = c * spp_per_pass * samples_per_batch
        if samples_per_batch > 1:
            # duplicate every pixel samples_per_batch times; duplicate k
            # folds samples [s0 + k*nsamp, s0 + (k+1)*nsamp) so the
            # chunk covers nsamp*samples_per_batch distinct sample ids
            # per pixel, each exactly once (count == pix_per_pass here:
            # n_splits == 1, and samples_per_batch divides spp)
            nsamp = min(spp_per_pass, (spp - s0) // samples_per_batch)
            pixel_ids = jnp.asarray(np.tile(order[sel],
                                            samples_per_batch))
            sample0 = jnp.asarray(np.repeat(
                np.uint32(iteration * spp + s0)
                + np.arange(samples_per_batch, dtype=np.uint32) * nsamp,
                pix_per_pass))
        else:
            nsamp = min(spp_per_pass, spp - s0)
            pixel_ids = jnp.asarray(order[sel])
            sample0 = jnp.full((pix_per_pass,),
                               np.uint32(iteration * spp + s0))
        if mesh is not None:
            rgb, nrays = _render_chunk_sharded(
                scene, camera, params, width, height, spp_grid, pixel_ids,
                sample0, np.uint32(seed), backplate, spp_per_pass=nsamp,
                pixel_filter=pixel_filter, mesh=mesh, samples=samples)
        elif (compact_on and scene.bvh is not None and nsamp == 1
              and params.max_depth > 1):
            rgb, nrays = _render_chunk_compact(
                scene, camera, params, width, height, spp_grid, pixel_ids,
                sample0, np.uint32(seed), backplate,
                pixel_filter=pixel_filter, samples=samples,
                bounce_stats=bounce_stats)
        else:
            rgb, nrays = _render_chunk(scene, camera, params, width,
                                       height, spp_grid, pixel_ids, sample0,
                                       np.uint32(seed), backplate,
                                       spp_per_pass=nsamp,
                                       pixel_filter=pixel_filter,
                                       samples=samples)
        # scatter back by pixel id (rays run in tiled order; duplicated
        # ids from sample-major batches accumulate via scatter-add)
        if samples_per_batch > 1:
            rgb_flat = rgb_flat.at[pixel_ids].add(rgb)
        else:
            rgb_flat = rgb_flat.at[pixel_ids[:count]].add(rgb[:count])
        if progress_cb is not None:
            # the callback reports finished work: wait for this pass
            jax.block_until_ready(rgb_flat)
        total_rays = total_rays + nrays
        if progress_cb is not None:
            progress_cb((wi + 1) / len(work))

    new_film = accum.Film(rgb_flat.reshape(height, width, 3),
                          film.weight + float(spp))
    jax.block_until_ready(new_film.rgb_sum)
    dt = time.perf_counter() - t0
    return new_film, FrameStats(float(total_rays), dt)


def pick(scene, camera, x: float, y: float):
    """rtPick (singleray_device.cpp:692-708): trace one ray through pixel
    (x, y) in [0,1]^2 and return (hit: bool, p: (3,) world point) — used by
    the interactive display for navigation focus."""
    from .integrator.pathtracer import _intersect
    uv = jnp.asarray([[x, y]], jnp.float32)
    org, dirn = camera.ray(uv, jnp.full((1, 2), 0.5))
    hit = _intersect(scene, org, dirn, jnp.zeros((1,)),
                     jnp.full((1,), jnp.inf))
    p = org[0] + hit.t[0] * dirn[0]
    ok = bool(hit.valid[0])
    return ok, (np.asarray(p) if ok else np.zeros(3, np.float32))


def render_progressive(scene, camera, params, width: int, height: int,
                       spp_per_iteration: int, iterations: int,
                       checkpoint_path: Optional[str] = None, seed: int = 0,
                       progress_cb=None, stop_flag=None):
    """Progressive refinement with durable checkpoint/resume.

    The reference only kept in-memory accumulation (AccuBuffer +
    iteration-chunked sample sets, SURVEY.md section 5 'no persistent
    checkpointing'); here every iteration's film is serialized so a killed
    job resumes exactly (the sampler draws iteration-keyed chunks of the
    same deterministic sequence).  Returns (film, completed_iterations).
    """
    film = None
    start_iter = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        d = np.load(checkpoint_path)
        film = accum.Film(jnp.asarray(d['rgb_sum']),
                          jnp.asarray(d['weight']))
        start_iter = int(d['iteration'])
    for it in range(start_iter, iterations):
        if stop_flag is not None and stop_flag():
            break
        film, _ = render_frame(scene, camera, params, width, height,
                               spp_per_iteration, film=film, iteration=it,
                               seed=seed)
        if checkpoint_path:
            tmp = checkpoint_path + '.tmp.npz'
            np.savez(tmp[:-4],  # np.savez appends .npz
                     rgb_sum=np.asarray(film.rgb_sum),
                     weight=np.asarray(film.weight), iteration=it + 1)
            os.replace(tmp, checkpoint_path)
        if progress_cb is not None:
            progress_cb((it + 1) / iterations)
        start_iter = it + 1
    return film, start_iter
