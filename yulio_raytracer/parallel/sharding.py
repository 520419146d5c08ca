"""Multi-chip rendering: shard_map over a jax.sharding.Mesh.

The reference scales image-space over TCP row-bands — every API call
broadcast to N servers, each rendering every Nth 4-row band, merged by a
receive thread (`devices/device_network/`, SURVEY.md section 2.6).  Here
all of that collapses into shardings:

* scene arrays are *replicated* (the one-time `broadcast` of scene state);
* the pixel*sample axis is *sharded* over the `px` mesh axis (the row-band
  decomposition, but load-balanced by construction);
* optionally the triangle axis is sharded over a `tri` mesh axis — each
  device intersects a triangle subset and closest hits are combined with
  an `all_gather` + argmin (the "tensor parallel" analog, useful when the
  scene does not fit or to scale intersection FLOPs);
* the frame gather is the natural output sharding (no encode/decode tier;
  the device interconnect moves f32 sums directly).  On GPUs every card
  reaches every other at the same rate (NVLink), so the mesh is shaped by
  the algorithm alone.

Determinism: rays are keyed by (pixel, sample) ids, so the image is
bit-identical for any device count — stronger than the reference's
per-serverID seeding.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..integrator import pathtracer
from ..sampling import patterns
from ..film import accum
from .. import renderer as _renderer


def make_mesh(n_devices: Optional[int] = None, tri_parallel: int = 1):
    """Build a ('px', 'tri') device mesh. tri_parallel=1 -> pure pixel DP."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    assert n % tri_parallel == 0
    arr = np.asarray(devs).reshape(n // tri_parallel, tri_parallel)
    return Mesh(arr, ('px', 'tri'))


def _shard_tri_geom(geom: dict, n_tri: int) -> dict:
    """Pad the triangle axis so it splits evenly across 'tri'.
    The 'woop' matrix block carries triangles along axis 1 (3 cols/tri)."""
    if n_tri == 1:
        return geom
    t = geom['v0'].shape[0]
    tp = ((t + n_tri - 1) // n_tri) * n_tri
    if tp == t:
        return geom
    pad = tp - t
    out = {}
    for k, a in geom.items():
        if k == 'woop':
            out[k] = jnp.pad(a, [(0, 0), (0, 3 * pad)])
            continue
        w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        fill = False if a.dtype == jnp.bool_ else 0
        out[k] = jnp.pad(a, w, constant_values=fill)
    return out


def render_frame_sharded(scene, camera, params, width: int, height: int,
                         spp: int, mesh: Mesh, film=None, seed: int = 0,
                         iteration: int = 0):
    """One full-frame render step, sharded over the mesh.

    Returns an updated Film.  The whole step is a single jitted shard_map
    (pixels over 'px', triangles over 'tri'); the per-(scene, shape) compile
    is cached across calls.
    """
    npix = width * height
    n_px = mesh.shape['px']
    n_tri = mesh.shape['tri']
    # awkward sizes (e.g. a 1536^2 face on a 7-healthy-device mesh) pad
    # the pixel axis with redundant rays instead of asserting; the pad
    # re-renders the first pixels and is dropped before accumulation
    npix_pad = ((npix + n_px - 1) // n_px) * n_px
    if film is None:
        film = accum.create(height, width)

    geom = _shard_tri_geom(scene.geom, n_tri)
    # a BVH indexes the global triangle order, so a sharded triangle
    # axis tests each shard's triangles directly (ops/intersect woop)
    scene = scene.__class__(**{**scene.__dict__, 'geom': geom,
                               'bvh': None if n_tri > 1 else scene.bvh})
    tri_axis = 'tri' if n_tri > 1 else None
    params = pathtracer.PTParams(**{**params.__dict__,
                                    'tri_axis': tri_axis}) \
        if getattr(params, 'tri_axis', None) != tri_axis else params

    @partial(jax.jit, static_argnames=('spp_', 'width_', 'height_',
                                       'params_'))
    def step(scene_, camera_, film_rgb, params_, spp_, width_, height_,
             pixel_ids, sample_ids, seed_):
        geom_spec = {k: (P(None, 'tri') if k == 'woop' else P('tri'))
                     for k in scene_.geom}
        scene_specs = jax.tree.map(lambda _: P(), scene_)
        scene_specs = scene_specs.__class__(
            **{**scene_specs.__dict__, 'geom': geom_spec})

        def shard_fn(scene_l, camera_l, pid, sid, seed_l):
            rgb_l = jnp.zeros((pid.shape[0], 3))
            for s in range(spp_):
                sidc = sid + jnp.uint32(s)
                rgb, _ = _render_one(scene_l, camera_l, params_, width_,
                                     height_, spp_, pid, sidc, seed_l)
                rgb_l = rgb_l + rgb
            if tri_axis is not None:
                rgb_l = jax.lax.psum(rgb_l, tri_axis) / jax.lax.psum(
                    jnp.ones(()), tri_axis)
            return rgb_l

        rgb = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(scene_specs, jax.tree.map(lambda _: P(), camera_),
                      P('px'), P('px'), P()),
            out_specs=P('px'),
            check_vma=False,
        )(scene_, camera_, pixel_ids, sample_ids, seed_)
        rgb = rgb[:width_ * height_]
        return film_rgb + rgb.reshape(height_, width_, 3)

    pixel_ids = jnp.arange(npix_pad, dtype=jnp.uint32) % npix
    sample_ids = jnp.full((npix_pad,), np.uint32(iteration * spp))
    rgb_sum = step(scene, camera, film.rgb_sum, params, spp, width, height,
                   pixel_ids, sample_ids, jnp.uint32(seed))
    return accum.Film(rgb_sum, film.weight + float(spp))


def _render_one(scene, camera, params, width, height, spp, pixel_ids,
                sample_ids, seed):
    """One sample per listed pixel (same math as renderer._render_chunk)."""
    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)
    juv = patterns.pixel_sample(seed, pixel_ids, sample_ids, spp,
                                _renderer.DIM_PIXEL)
    uv = jnp.stack([(px + juv[:, 0]) / width,
                    (py + juv[:, 1]) / height], axis=-1)
    lens = patterns.sample_2d(seed, pixel_ids, sample_ids,
                              jnp.uint32(_renderer.DIM_LENS))
    org, dirn = camera.ray(uv, lens)
    return pathtracer.trace(scene, params, org, dirn, seed, pixel_ids,
                            sample_ids, pixel_uv=uv)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Multi-host bring-up (`jax.distributed.initialize`) — the analog of
    `network_server_main.cpp`'s listen loop + `-connect` handshake."""
    kwargs = {}
    if coordinator:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
