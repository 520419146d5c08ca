#!/usr/bin/env python3
"""Embree-XML -> OBJ converter (tools/xml2obj equivalent)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) != 2:
        print("usage: xml2obj.py input.xml output.obj", file=sys.stderr)
        return 1
    from yulio_raytracer.io import xml_scene
    from yulio_raytracer.scene import SceneBuilder

    src, dst = argv
    sb = SceneBuilder()
    xml_scene.load_xml(src, sb)
    with open(dst, 'w') as f:
        f.write(f"# converted from {os.path.basename(src)}\n")
        base = 1
        for i, m in enumerate(sb.meshes):
            f.write(f"g mesh{i}\n")
            for p in m.positions:
                f.write("v %g %g %g\n" % tuple(p))
            if m.normals is not None:
                for n in m.normals:
                    f.write("vn %g %g %g\n" % tuple(n))
            if m.texcoords is not None:
                for t in m.texcoords:
                    f.write("vt %g %g\n" % tuple(t))
            has_n = m.normals is not None
            has_t = m.texcoords is not None
            for tri in m.triangles:
                idx = [base + int(v) for v in tri]
                if has_n and has_t:
                    f.write("f %d/%d/%d %d/%d/%d %d/%d/%d\n" % (
                        idx[0], idx[0], idx[0], idx[1], idx[1], idx[1],
                        idx[2], idx[2], idx[2]))
                elif has_n:
                    f.write("f %d//%d %d//%d %d//%d\n" % (
                        idx[0], idx[0], idx[1], idx[1], idx[2], idx[2]))
                else:
                    f.write("f %d %d %d\n" % tuple(idx))
            base += len(m.positions)
    print(f"wrote {dst} ({len(sb.meshes)} meshes)")
    return 0


if __name__ == '__main__':
    sys.exit(main())
