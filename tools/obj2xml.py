#!/usr/bin/env python3
"""OBJ -> Embree-XML converter (tools/obj2xml equivalent).

Emits an XML scene with one <TriangleMesh> per material group and a .bin
sidecar holding the vertex/index arrays (the reference's obj2xml.cpp:8-19
writes the same pair)."""
import os
import struct
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))

import numpy as np


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) != 2:
        print("usage: obj2xml.py input.obj output.xml", file=sys.stderr)
        return 1
    from yulio_raytracer.io import obj as gobj
    from yulio_raytracer.scene import SceneBuilder

    src, dst = argv
    sb = SceneBuilder()
    gobj.load_obj(src, sb)
    bin_path = os.path.splitext(dst)[0] + '.bin'

    with open(bin_path, 'wb') as binf, open(dst, 'w') as xmlf:
        xmlf.write('<?xml version="1.0"?>\n<scene>\n <Group>\n')
        for m in sb.meshes:
            def put(arr):
                ofs = binf.tell()
                a = np.ascontiguousarray(arr)
                binf.write(a.tobytes())
                return ofs, len(a)
            p_ofs, p_n = put(m.positions.astype(np.float32))
            t_ofs, t_n = put(m.triangles.astype(np.int32))
            xmlf.write('  <TriangleMesh>\n')
            xmlf.write('   <material><code>"matte"</code><parameters>'
                       '<float3 name="reflectance">0.5 0.5 0.5</float3>'
                       '</parameters></material>\n')
            xmlf.write(f'   <positions ofs="{p_ofs}" size="{p_n}"/>\n')
            if m.normals is not None:
                n_ofs, n_n = put(m.normals.astype(np.float32))
                xmlf.write(f'   <normals ofs="{n_ofs}" size="{n_n}"/>\n')
            if m.texcoords is not None:
                u_ofs, u_n = put(m.texcoords.astype(np.float32))
                xmlf.write(f'   <texcoords ofs="{u_ofs}" size="{u_n}"/>\n')
            xmlf.write(f'   <triangles ofs="{t_ofs}" size="{t_n}"/>\n')
            xmlf.write('  </TriangleMesh>\n')
        xmlf.write(' </Group>\n</scene>\n')
    print(f"wrote {dst} + {bin_path} ({len(sb.meshes)} meshes)")
    return 0


if __name__ == '__main__':
    sys.exit(main())
