"""Progressive display loop (the GLUTDisplay analog) in file mode."""
import os

import numpy as np

from yulio_raytracer.api import display
from yulio_raytracer.io import builtin_scenes
from yulio_raytracer.integrator import pathtracer as pt
from yulio_raytracer.film import accum


def test_display_loop_refines_and_reacts(tmp_path):
    scene = builtin_scenes.cornell_box(with_boxes=False).commit()
    cam0 = builtin_scenes.cornell_camera(16, 16)
    out = str(tmp_path / "view.png")
    events = []

    def cb(frame, img, stats):
        events.append((frame, img.mean()))
        if frame == 1:
            # camera move restarts accumulation (cameraMoved semantics)
            return builtin_scenes.cornell_camera(16, 16), True
        return None, frame < 3

    film = display.display_loop(scene, cam0, pt.PTParams(max_depth=2),
                                16, 16, spp_per_frame=2, max_frames=10,
                                out_path=out, seed=4, frame_cb=cb,
                                use_matplotlib=False)
    assert os.path.exists(out)
    assert len(events) == 4            # stopped by callback at frame 3
    # refinement accumulated until the camera move reset it
    assert float(film.weight[0, 0]) == 4.0   # frames 2..3 after reset
    imgs = [e[1] for e in events]
    assert all(np.isfinite(m) for m in imgs)
