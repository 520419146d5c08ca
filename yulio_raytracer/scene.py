"""Scene assembly + commit: the analog of `rtCommit(scene)`.

The reference builds a `BackendSceneFlat` at commit: extract every shape
into Embree, build the BVH, collect lights, let lights create shapes
(area lights become visible geometry) and compute the scene bsphere for the
ambient dome (`api/scene_flat.h:87-136`).  Here commit produces one
immutable pytree (`Scene`) holding:

* BVH-permuted SoA triangle tables (device arrays),
* the flattened BVH (every scene with triangles; commit(force_bvh=False)
  leaves it out and every ray tests every triangle, ops/intersect.py),
* the material lobe table + texture atlas,
* the static light list (ambient lights get the scene bsphere here).

Two-level instancing (api/scene_instancing.h + api/instance.h): NOT
implemented, by decision.  The reference itself ships it disabled — the
"twolevel" backend is commented out at singleray_device.cpp:341 and every
scene goes through BackendSceneFlat ("no support for instancing, best
render performance", scene_flat.h:25).  Loader-level instancing (the only
kind the front-ends emit) is covered: every rtTransformPrimitive /
re-instanced <ref> bakes its transform into vertices here (one flat SoA
table; a traversal-time transform per instance would add per-ray matrix
gathers to the hot traversal loop).  Flattening costs device memory only
in proportion to the instanced triangle count.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .geometry import mesh as gmesh
from .geometry import bvh as gbvh
from .geometry import primitives
from .shading import materials as gmat
from .shading import textures as gtex
from .lights import lights as glights

# at or below this triangle count a scene keeps no BVH and every ray
# tests every triangle (ops/intersect.intersect_woop).  On the H100 the
# BVH + traversal kernel beat the Woop test even on the 128-triangle
# cornell box (PERF.md), so every scene with triangles gets a BVH;
# commit(force_bvh=False) still selects the dense test.
BRUTE_FORCE_MAX_TRIS = 0
# the reference's -accel names (renderer.cpp -rtcore accel=); every one
# runs the same binary BVH here, 'bvh4mb' additionally demands motion
# geometry (models/sphere_motion.ecs)
ACCEL_NAMES = ('default', 'bvh2', 'bvh4', 'bvh4mb')


@dataclass
class SceneBuilder:
    """Mutable host-side staging area (the Device-API equivalent:
    rtNewShape/rtNewMaterial/rtNewLight calls land here)."""
    meshes: list = field(default_factory=list)        # HostMesh
    materials: list = field(default_factory=list)     # MaterialSpec
    lights: list = field(default_factory=list)        # light dicts
    textures: gtex.TextureTableBuilder = field(
        default_factory=gtex.TextureTableBuilder)

    def add_material(self, spec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_mesh(self, m: gmesh.HostMesh) -> int:
        self.meshes.append(m)
        return len(self.meshes) - 1

    def add_light(self, light: dict) -> int:
        """Area lights also create their emissive geometry
        (TriangleLight::createShape via scene_flat.h:133-135)."""
        self.lights.append(light)
        lid = len(self.lights) - 1
        if light['kind'] == 'triangle':
            mat = self.add_material(gmat.make_material(
                'matte', {'reflectance': (1.0, 1.0, 1.0)}))
            # the visible shape's Ng must match the light's emission normal
            # (shapes/triangle.h:43 uses cross(v2-v0, v1-v0) == light Ng),
            # so emit the mesh with swapped winding
            tri = primitives.single_triangle(
                np.asarray(light['v0']), np.asarray(light['v2']),
                np.asarray(light['v1']), material=mat, light=lid)
            self.add_mesh(tri)
        return lid

    def has_billboards(self) -> bool:
        return any(getattr(m, 'face_camera', False) for m in self.meshes)

    def commit(self, force_bvh: Optional[bool] = None,
               leaf_size: int = 8, view_pos=None,
               view_up=(0.0, 1.0, 0.0),
               quality: str = 'high',
               accel: str = 'default') -> "Scene":
        """Commit the staged scene. When camera-aligned billboards exist,
        view_pos orients them toward that camera origin (the per-view
        rtUpdatePrimitive + rtCommit of renderer.cpp:550-559).

        quality='high' is the role RTC_SCENE_HIGH_QUALITY plays in the
        reference's every commit (scene_flat.h:90-96): the native
        builder's row-aligned leaf packing (geometry/bvh.py::build);
        'high-spatial' adds SBVH spatial splits; 'normal' is the plain
        object-split binned-SAH build (also the build for motion scenes).

        leaf_size: most triangles per BVH leaf.  The default is the
        GPU's choice (PERF.md); the XLA traversal gathers a window this
        wide per loop step, the GPU kernel loops over each leaf's count.

        accel: the reference's -accel flag (ACCEL_NAMES).  One binary BVH
        serves every value; 'bvh4mb' requires motion geometry and
        unknown values raise."""
        from .utils import hostmem
        hostmem.tune_malloc()   # commit's big temporaries reuse the arena
        if accel not in ACCEL_NAMES:
            raise ValueError(
                f"unknown accel {accel!r}: expected one of {ACCEL_NAMES}")
        meshes = []
        for m in self.meshes:
            if getattr(m, 'face_camera', False) and m.orig_transform is not None:
                if view_pos is not None:
                    xfm = gmesh.billboard_transform(m.orig_transform,
                                                    view_pos, view_up)
                else:
                    xfm = m.orig_transform
                meshes.append(m.transformed(xfm))
            else:
                meshes.append(m)
        packed = gmesh.pack_meshes(meshes)
        n_tris = packed.num_triangles
        has_motion = packed.mv0 is not None
        if accel == 'bvh4mb' and not has_motion:
            raise ValueError(
                "accel='bvh4mb' requires motion geometry (meshes with "
                "motion vertex buffers, trianglemesh_full.cpp:29-33)")
        n_live = int(np.count_nonzero(packed.valid))
        use_bvh = n_live > 0 and (force_bvh if force_bvh is not None
                                  else n_live > BRUTE_FORCE_MAX_TRIS)

        host = {k: getattr(packed, k) for k in gbvh._PER_TRIANGLE_KEYS
                if getattr(packed, k) is not None}
        bvh_dev = None
        if use_bvh:
            # motion scenes: union-of-endpoint bounds (the bvh4mb analog,
            # exact for the linear motion of trianglemesh_full.cpp:29-33)
            mb_bounds = (gbvh.motion_bounds(
                packed.v0, packed.e1, packed.e2, packed.mv0, packed.me1,
                packed.me2) if has_motion else None)
            tree = gbvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                              leaf_size=leaf_size, bounds=mb_bounds,
                              quality=quality if not has_motion else 'normal')
            host = gbvh.permute_geom(host, tree.order)
            bvh_dev = gbvh.to_device(tree)
        host['woop'] = gmesh.woop_matrices(host['v0'], host['e1'],
                                           host['e2'], host['valid'])
        geom = {k: jnp.asarray(v)
                for k, v in gmesh.add_shade_table(host).items()}

        lights = [glights.set_scene_bounds(l, packed.bbox_lo, packed.bbox_hi)
                  for l in self.lights]
        light_arrays, light_static = _split_lights(lights)

        return Scene(
            geom=geom,
            bvh=bvh_dev,
            materials=gmat.build_table(self.materials),
            textures=self.textures.build(),
            light_arrays=light_arrays,
            light_static=light_static,
            leaf_size=leaf_size,
            bbox_lo=tuple(float(x) for x in packed.bbox_lo),
            bbox_hi=tuple(float(x) for x in packed.bbox_hi),
            num_triangles=n_tris,
            lobe_types=tuple(sorted({lo.type for ms in self.materials
                                     for lo in ms.lobes})),
        )


def _split_lights(lights):
    """Split light dicts into (array side, hashable static side) so a
    Scene flattens into a clean jit pytree.  Array leaves move to the
    device HERE, once — light builders are host-side numpy."""
    def _dev(v):
        if isinstance(v, (np.ndarray, np.floating, np.integer)):
            return jnp.asarray(v)
        return jax.tree_util.tree_map(jnp.asarray, v) \
            if isinstance(v, (tuple, list)) else v

    arrays, statics = [], []
    for l in lights:
        a, s = {}, {}
        for k, v in l.items():
            if isinstance(v, (str, bool, int, float)):
                s[k] = v
            else:
                a[k] = _dev(v)
        arrays.append(a)
        statics.append(tuple(sorted(s.items())))
    return arrays, tuple(statics)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Scene:
    """Committed immutable scene: a jit-able pytree (device arrays as data,
    light kinds / layout parameters as static metadata)."""
    geom: dict
    bvh: Optional[dict]
    materials: dict
    textures: dict
    light_arrays: list
    light_static: tuple = field(metadata=dict(static=True))
    leaf_size: int = field(metadata=dict(static=True))
    bbox_lo: tuple = field(metadata=dict(static=True))
    bbox_hi: tuple = field(metadata=dict(static=True))
    num_triangles: int = field(metadata=dict(static=True))
    # static set of lobe type ids used by any material — lets the shader
    # compile away unused BSDF families (shading/lobes.py sample_lobes)
    lobe_types: Optional[tuple] = field(metadata=dict(static=True),
                                        default=None)

    @property
    def lights(self):
        return [dict(**a, **dict(s))
                for a, s in zip(self.light_arrays, self.light_static)]

    @property
    def env_lights(self):
        return [l for l in self.lights if glights.is_env(l)]
