"""Interactive/progressive display loop — the GLUTDisplay analog.

The reference's display mode (`devices/renderer/glutdisplay.cpp:342-441`)
renders progressively refined frames into a window with fps stats, camera
drag, and keys (space=screenshot, r=refine toggle).  Headless hosts
get the same loop writing to a PNG (or driving a matplotlib window when a
display is available): each iteration adds spp, prints the rolling-average
fps/mrps line, and a callback can move the camera or stop the loop.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np

from ..film import accum, tonemap
from ..integrator import pathtracer as pt
from .. import renderer as grenderer


def display_loop(scene, camera, params: pt.PTParams, width: int, height: int,
                 spp_per_frame: int = 1, max_frames: int = 0,
                 out_path: str = 'display.png', gamma: float = 1.0,
                 refine: bool = True, seed: int = 0,
                 frame_cb: Optional[Callable] = None,
                 use_matplotlib: Optional[bool] = None):
    """Progressive render loop.

    frame_cb(frame_index, image, stats) -> (camera | None, keep_going):
    return a new camera to move the view (resets accumulation, like the
    reference's cameraMoved flag) or None to keep refining; keep_going=False
    stops.  Returns the final Film.
    """
    if use_matplotlib is None:
        use_matplotlib = bool(os.environ.get('DISPLAY'))
    plt_img = None
    if use_matplotlib:
        try:
            import matplotlib.pyplot as plt
            plt.ion()
            fig, ax = plt.subplots()
        except Exception:
            use_matplotlib = False

    film = None
    frame = 0
    fps_avg = None
    while max_frames <= 0 or frame < max_frames:
        t0 = time.perf_counter()
        film, stats = grenderer.render_frame(
            scene, camera, params, width, height, spp_per_frame,
            film=film if refine else None, iteration=frame,
            accumulate=refine, seed=seed)
        dt = time.perf_counter() - t0
        fps = 1.0 / max(dt, 1e-9)
        # rolling average like glutdisplay.cpp:404-427
        fps_avg = fps if fps_avg is None else 0.8 * fps_avg + 0.2 * fps
        img = np.asarray(tonemap.to_srgb_u8(
            tonemap.tonemap(accum.resolve(film), gamma=gamma)))
        print(f"frame {frame}: {fps:.2f} fps (avg {fps_avg:.2f}), "
              f"{dt * 1000:.1f} ms, {stats.mrps:.2f} mrps", flush=True)

        if use_matplotlib:
            if plt_img is None:
                plt_img = ax.imshow(img)
            else:
                plt_img.set_data(img)
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
        elif out_path:
            from ..io import image as gimage
            gimage.store(out_path, img)

        if frame_cb is not None:
            new_cam, keep = frame_cb(frame, img, stats)
            if new_cam is not None:
                camera = new_cam
                film = None          # camera moved -> restart accumulation
            if not keep:
                break
        frame += 1
    return film
