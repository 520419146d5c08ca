"""yulio_raytracer — a JAX stereoscopic path-tracing framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the
YulioTech/Yulio-Raytracer CPU renderer (Embree example renderer + Yulio's
stereoscopic cube-map VR extensions).  This is *not* a port: the recursive
per-pixel C++ integrator becomes a wavefront bounce loop over ray batches,
Embree's BVH becomes a flattened SoA BVH with a per-ray GPU traversal
kernel (Pallas through Triton) and batched Moller-Trumbore/Woop triangle
tests, and the distributed network device becomes `shard_map` over a
`jax.sharding.Mesh`.

Layer map (mirrors SURVEY.md section 7):
  core       math / counter-based RNG / color
  sampling   sample patterns, Distribution1D/2D importance sampling
  geometry   SoA meshes, BVH build + flatten, primitive tessellation
  ops        traversal and intersection (XLA + a Pallas GPU kernel)
  shading    lobe-table BSDFs ("CompositedBRDF" as masked tensor dispatch)
  lights     SoA light tables incl. the Yulio ambient-dome model
  cameras    pinhole / depth-of-field / stereoscopic cube-map ray-gen
  integrator wavefront path tracer (NEE, RR, media) + debug renderer
  film       accumulation buffers, tonemap, cube-strip assembly, watermark
  io         ECS / OBJ / XML / Collada scene ingestion, image codecs
  parallel   device-mesh sharding of the pixel*spp axis, multi-host
  api        async render sessions (StartRT-equivalent) + CLI
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level convenience exports (keeps bare `import
    yulio_raytracer` free of jax initialization)."""
    import importlib
    top = {
        'SceneBuilder': ('yulio_raytracer.scene', 'SceneBuilder'),
        'Scene': ('yulio_raytracer.scene', 'Scene'),
        'PTParams': ('yulio_raytracer.integrator.pathtracer',
                     'PTParams'),
        'render_frame': ('yulio_raytracer.renderer', 'render_frame'),
        'render_progressive': ('yulio_raytracer.renderer',
                               'render_progressive'),
        'pick': ('yulio_raytracer.renderer', 'pick'),
    }
    if name in top:
        mod, attr = top[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
