import os

import numpy as np
import jax.numpy as jnp
import pytest

from yulio_raytracer.io import ecs, image, obj, builtin_scenes
from yulio_raytracer.scene import SceneBuilder
from yulio_raytracer.shading import lobes as lb

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'scenes')


def test_ppm_roundtrip(tmp_path):
    img = np.random.RandomState(0).rand(8, 12, 3).astype(np.float32)
    p = str(tmp_path / "t.ppm")
    image.store(p, img)
    back = image.load(p)
    assert back.shape == (8, 12, 3)
    np.testing.assert_allclose(back, img, atol=1 / 255.0 + 1e-6)


def test_pfm_roundtrip(tmp_path):
    img = (np.random.RandomState(1).rand(6, 9, 3) * 100).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    image.store(p, img)
    back = image.load(p)
    np.testing.assert_allclose(back, img, rtol=1e-6)


def test_png_roundtrip(tmp_path):
    img = np.random.RandomState(2).rand(5, 7, 3).astype(np.float32)
    p = str(tmp_path / "t.png")
    image.store(p, img)
    back = image.load(p)
    np.testing.assert_allclose(back, img, atol=1 / 255.0 + 1e-6)


def test_parse_cornell_ecs():
    settings, sb = ecs.parse_ecs(os.path.join(ASSETS, 'cornell_box.ecs'))
    assert settings.depth == 2
    assert settings.fov == 37.0
    assert settings.cam_pos == (278.0, 273.0, -800.0)
    # quadlight -> two triangle lights (+their emissive geometry)
    kinds = [l['kind'] for l in sb.lights]
    assert kinds == ['triangle', 'triangle']
    scene = sb.commit()
    # 5 walls * 2 + 2 boxes * 5 quads * 2 + 2 light tris = 32 live tris
    # (BVH leaves may repeat a triangle as row padding: count distinct)
    valid = np.asarray(scene.geom['valid'])
    tris = np.concatenate([np.asarray(scene.geom[k])[valid]
                           for k in ('v0', 'e1', 'e2')], axis=1)
    assert len(np.unique(tris, axis=0)) == 32


def test_obj_materials_mapped():
    sb = SceneBuilder()
    obj.load_obj(os.path.join(ASSETS, 'cornell_box.obj'), sb)
    # materials: default matte + white/red/green
    assert len(sb.materials) == 4
    types = np.asarray(sb.commit().materials['lobe_type'])
    assert (types[:, 0] == lb.NONE).sum() == 0  # every material has a lobe


def test_parse_sphere_glass_xml():
    settings = ecs.RenderSettings()
    sb = SceneBuilder()
    ecs.load_scene_file(os.path.join(ASSETS, 'sphere_glass.xml'),
                        settings, sb)
    kinds = [l['kind'] for l in sb.lights]
    assert kinds == ['ambient']
    scene = sb.commit()
    assert scene.num_triangles > 4000       # tessellated sphere + floor
    # glass material present with medium interface
    assert bool(np.asarray(scene.materials['media']).any())
    # textured floor material has a texture bound
    assert int(np.asarray(scene.materials['lobe_tex']).max()) >= 0


def test_ecs_include_recursion(tmp_path):
    inner = tmp_path / "view.ecs"
    inner.write_text("-vp 1 2 3 -fov 45\n")
    outer = tmp_path / "main.ecs"
    outer.write_text(f"-c view.ecs\n-spp 4 # comment\n")
    settings, sb = ecs.parse_ecs(str(outer))
    assert settings.cam_pos == (1.0, 2.0, 3.0)
    assert settings.fov == 45.0
    assert settings.spp == 4


def test_renderer_block_sampler_mode(tmp_path):
    """`-renderer pathtracer { sampler = precomputed }` selects the
    reference's 64-sample-set mode (sampler.cpp:85-160)."""
    f = tmp_path / "r.ecs"
    f.write_text("-renderer pathtracer { sampler = precomputed spp = 2 }\n")
    settings, _ = ecs.parse_ecs(str(f))
    assert settings.sampler == 'precomputed'
    assert settings.spp == 2
    f2 = tmp_path / "r2.ecs"
    f2.write_text("-renderer pathtracer { sampler = stateless }\n")
    settings2, _ = ecs.parse_ecs(str(f2))
    assert settings2.sampler == 'stateless'


def test_unknown_tag_raises():
    ts = ecs.TokenStream("-bogus 1")
    with pytest.raises(ValueError, match="unknown command-line tag"):
        ecs.parse(ts, ecs.RenderSettings(), SceneBuilder())


def test_reference_model_ecs_parses_if_available():
    """The actual golden .ecs files from the reference tree must parse
    (pure data; the geometry blobs they reference may be stripped)."""
    ref = "/root/reference/models"
    if not os.path.isdir(ref):
        pytest.skip("reference models not present")
    settings, sb = ecs.parse_ecs(os.path.join(ref, 'sphere_glass.ecs'))
    assert settings.renderer == 'pathtracer'
    assert [l['kind'] for l in sb.lights].count('hdrilight') == 0
    # scene contains the glass sphere + floor + HDRI light
    kinds = [l['kind'] for l in sb.lights]
    assert 'hdri' in kinds


def test_all_reference_ecs_parse():
    """Every golden .ecs in the reference tree parses (geometry blobs may
    be stripped — scene files that reference them are skipped)."""
    ref = "/root/reference/models"
    if not os.path.isdir(ref):
        pytest.skip("reference models not present")
    parsed = 0
    for fn in sorted(os.listdir(ref)):
        if not fn.endswith('.ecs'):
            continue
        path = os.path.join(ref, fn)
        try:
            settings, sb = ecs.parse_ecs(path)
            parsed += 1
        except FileNotFoundError:
            continue   # references a stripped blob (e.g. cornell_box.obj)
    assert parsed >= 5


def test_reference_xml_scenes_load():
    ref = "/root/reference/models"
    if not os.path.isdir(ref):
        pytest.skip("reference models not present")
    from yulio_raytracer.io import xml_scene
    ok = 0
    for fn in ('sphere_glass.xml', 'sphere_mirror.xml',
               'sphere_carpaint.xml', 'cornell_box_spheres.xml',
               'test_stereo.xml', 'test_transmissive.xml',
               'sphere_motion.xml'):
        path = os.path.join(ref, fn)
        if not os.path.exists(path):
            continue
        sb = SceneBuilder()
        xml_scene.load_xml(path, sb)
        assert len(sb.meshes) > 0 or len(sb.lights) > 0, fn
        ok += 1
    assert ok >= 5


def test_exr_roundtrip_zip(tmp_path):
    """HALF RGB zip round-trip through the native EXR codec
    (common/image/exr.cpp parity: scanline HALF storage)."""
    from yulio_raytracer.io import exr
    rs = np.random.RandomState(3)
    img = (rs.rand(37, 53, 3).astype(np.float32) * 8.0) ** 2
    p = str(tmp_path / "t.exr")
    exr.store_exr(p, img, compression='zip')
    back = exr.load_exr(p)
    assert back.shape == (37, 53, 3)
    # HALF storage: ~1e-3 relative precision
    np.testing.assert_allclose(back, img, rtol=2e-3, atol=1e-4)
    # and through the image-cache dispatch layer
    image.clear_cache()
    np.testing.assert_array_equal(image.load(p), back)


def test_exr_variants(tmp_path):
    from yulio_raytracer.io import exr
    rs = np.random.RandomState(4)
    img = rs.rand(20, 31, 4).astype(np.float32)
    for compression in ('none', 'zips', 'zip'):
        p = str(tmp_path / f"t_{compression}.exr")
        exr.store_exr(p, img, compression=compression)
        back = exr.load_exr(p)
        assert back.shape == (20, 31, 4)
        np.testing.assert_allclose(back, img, rtol=2e-3, atol=1e-4)
    # 17 rows: ragged final 16-line zip block
    img2 = rs.rand(17, 8, 3).astype(np.float32)
    p2 = str(tmp_path / "ragged.exr")
    exr.store_exr(p2, img2, compression='zip')
    np.testing.assert_allclose(exr.load_exr(p2), img2, rtol=2e-3,
                               atol=1e-4)


def test_exr_hdri_in_scene(tmp_path):
    """An .exr HDRI drives an environment light end-to-end (the
    reference's common HDRI-dome workflow, exr.cpp + hdrilight.cpp)."""
    from yulio_raytracer.io import exr
    from yulio_raytracer.lights import lights as glights
    img = np.zeros((8, 16, 3), np.float32)
    img[:4] = (4.0, 2.0, 1.0)       # bright upper hemisphere
    p = str(tmp_path / "env.exr")
    exr.store_exr(p, img)
    image.clear_cache()
    tex = image.load(p)
    l = glights.hdri(tex)
    up = jnp.asarray([[0.0, 1.0, 0.0]])
    le = glights.le_env(l, -up)     # wo points away; ray dir = +up
    assert float(le[0, 0]) > 1.0


def test_xml_nested_include_and_tangents(tmp_path):
    """<xml src> includes under the current transform
    (xml_loader.cpp:558-561) and per-vertex tangent_x/tangent_y arrays
    (trianglemesh_full.cpp:39-47)."""
    from yulio_raytracer.io import xml_scene
    inner = tmp_path / "inner.xml"
    inner.write_text("""<scene>
      <TriangleMesh>
        <material><code>"matte"</code>
          <parameters><float3 name="reflectance">0.5 0.5 0.5</float3>
          </parameters></material>
        <positions>0 0 0  1 0 0  0 1 0</positions>
        <tangent_x>0 0 1  0 0 1  0 0 1</tangent_x>
        <tangent_y>0 1 0  0 1 0  0 1 0</tangent_y>
        <triangles>0 1 2</triangles>
      </TriangleMesh>
    </scene>""")
    outer = tmp_path / "outer.xml"
    outer.write_text("""<scene>
      <Transform>
        <AffineSpace translate="10 0 0"/>
        <xml src="inner.xml"/>
      </Transform>
    </scene>""")
    sb = SceneBuilder()
    xml_scene.load_xml(str(outer), sb)
    assert len(sb.meshes) == 1
    m = sb.meshes[0]
    # include inherited the translate
    np.testing.assert_allclose(m.positions[0], [10, 0, 0], atol=1e-6)
    # tangents survived the transform (pure translation)
    np.testing.assert_allclose(m.tangent_x[0], [0, 0, 1], atol=1e-6)
    # and reach the committed shade table as the authored frame
    scene = sb.commit()
    tab = np.asarray(scene.geom['shade_tab'])
    valid = np.asarray(scene.geom['valid'])
    # (BVH leaves may repeat the triangle as row padding)
    np.testing.assert_allclose(np.unique(tab[valid][:, 22:25], axis=0),
                               [[0, 0, 1]], atol=1e-5)
    np.testing.assert_allclose(np.unique(tab[valid][:, 25:28], axis=0),
                               [[0, 1, 0]], atol=1e-5)


def test_xml_assign_scene_ref(tmp_path):
    """<assign type="scene"> + <ref> re-instance a named subgraph
    (xml_loader.cpp:551-553,573-577)."""
    from yulio_raytracer.io import xml_scene
    f = tmp_path / "refs.xml"
    f.write_text("""<scene>
      <assign type="scene" id="ball">
        <Sphere>
          <material><code>"matte"</code><parameters/></material>
          <position>0 0 0</position><radius>1</radius>
          <numTheta>4</numTheta><numPhi>4</numPhi>
        </Sphere>
      </assign>
      <Transform><AffineSpace translate="5 0 0"/><ref id="ball"/></Transform>
      <Transform><AffineSpace translate="-5 0 0"/><ref id="ball"/></Transform>
    </scene>""")
    sb = SceneBuilder()
    xml_scene.load_xml(str(f), sb)
    assert len(sb.meshes) == 2
    c0 = sb.meshes[0].positions.mean(axis=0)
    c1 = sb.meshes[1].positions.mean(axis=0)
    assert c0[0] > 4.0 and c1[0] < -4.0


@pytest.mark.parametrize("ecs_name,xml_name", [
    ('sphere_mirror.ecs', 'sphere_mirror.xml'),
    ('sphere_gold.ecs', 'sphere_carpaint.xml'),
    ('cornell_box_spheres.ecs', 'cornell_box_spheres.xml'),
    ('sphere_motion.ecs', 'sphere_motion.xml'),
    (None, 'test_stereo.xml'),
    (None, 'test_transmissive.xml'),
])
def test_golden_scene_assets_load_and_render(ecs_name, xml_name):
    """Every golden scene asset mirrored from the reference's models/
    directory (SURVEY 2.9) parses and renders finite at thumbnail size
    through the public ECS pipeline."""
    from yulio_raytracer.scene import SceneBuilder
    from yulio_raytracer.integrator import pathtracer as pt
    from yulio_raytracer import renderer
    from yulio_raytracer.film import accum
    from yulio_raytracer.cameras import cameras as cam
    from yulio_raytracer.api import output as goutput

    if ecs_name is not None:
        settings, sb = ecs.parse_ecs(os.path.join(ASSETS, ecs_name))
    else:
        settings = ecs.RenderSettings()
        sb = SceneBuilder()
        ecs.load_scene_file(os.path.join(ASSETS, xml_name), settings, sb)
        settings.cam_pos = (-200.0, 100.0, 200.0)
        settings.cam_look_at = (0.0, 100.0, 200.0)
        if xml_name == 'test_stereo.xml':
            # lit by the sky-color ambient of test_stereo_view.ecs
            # (its embedded HDRI is intentionally zero)
            from yulio_raytracer.lights import lights as gl
            sb.add_light(gl.ambient((0.83, 0.95, 0.98)))
    assert sb.meshes, xml_name
    scene = sb.commit(view_pos=np.asarray(settings.cam_pos, np.float64))
    camera = goutput.mono_camera(settings)
    # depth -1 is the 'integrator default' sentinel — bounce at least
    # twice so mirror/transmission/motion bounce paths are exercised
    depth = 3 if settings.depth < 0 else min(settings.depth, 3)
    p = pt.PTParams(max_depth=depth)
    film, _ = renderer.render_frame(scene, camera, p, 16, 16, spp=2,
                                    seed=0)
    img = np.asarray(accum.resolve(film))
    assert np.isfinite(img).all(), xml_name
    if xml_name != 'test_transmissive.xml':   # filters only: may be dark
        assert img.max() > 0.0, xml_name


def test_accel_flag_plumbed(tmp_path):
    """`-accel bvh4` reaches commit(accel=...) (io/ecs.py must not
    discard the token); bvh4mb stays motion-only and unknown values
    raise."""
    import pytest
    from yulio_raytracer.io.ecs import TokenStream, RenderSettings
    from yulio_raytracer.io import ecs as gecs

    for tok, want in (('bvh4', 'bvh4'), ('bvh4.triangle4', 'bvh4'),
                      ('bvh4mb', 'bvh4mb'), ('default', 'default'),
                      ('bvh2', 'bvh2')):
        settings = RenderSettings()
        gecs.parse(TokenStream(f'-accel {tok}'), settings, SceneBuilder(),
                   str(tmp_path))
        assert settings.accel == want, tok
    with pytest.raises(ValueError):
        gecs.parse(TokenStream('-accel kdtree'), RenderSettings(),
                   SceneBuilder(), str(tmp_path))

    # sphere_motion.ecs (the reference model's flag) parses to bvh4mb
    # and commits: the motion geometry it demands is there
    settings, sb = ecs.parse_ecs(os.path.join(ASSETS, 'sphere_motion.ecs'))
    assert settings.accel == 'bvh4mb'
    scene = sb.commit(accel=settings.accel)
    assert 'mv0' in scene.geom
    # every accel name on a static scene commits the same binary BVH
    trees = []
    for accel in ('default', 'bvh2', 'bvh4'):
        _, sb2 = ecs.parse_ecs(os.path.join(ASSETS, 'cornell_box.ecs'))
        trees.append(sb2.commit(force_bvh=True, accel=accel).bvh)
    for t in trees[1:]:
        for k in trees[0]:
            np.testing.assert_array_equal(np.asarray(t[k]),
                                          np.asarray(trees[0][k]))
    # bvh4mb without motion geometry is a loud error, not a side effect
    _, sb3 = ecs.parse_ecs(os.path.join(ASSETS, 'cornell_box.ecs'))
    with pytest.raises(ValueError):
        sb3.commit(accel='bvh4mb')
    with pytest.raises(ValueError):
        sb3.commit(accel='bvh8')
