"""Stereo cube-map output: watermark compositing + 12-face strip assembly.

Reproduces the Yulio outputMode pipeline (`renderer.cpp:508-736`) as array
ops over the 12 rendered faces:

* watermark: alpha-blended, centered, only on the four side faces
  (front/right/back/left — face%6 < 4, renderer.cpp:636-654);
* strip: 12W x H image in segment order left,right,up,down,back,front —
  6 segments per eye — with the reference's **eye-swap quirk**: segment
  group 0 takes the RIGHT-eye faces (eyeIndex = segment/6==0 ? 1 : 0,
  renderer.cpp:677);
* per-face debug filenames `<scene>_<camera>_<face>_image_<eye>.jpg`
  (renderer.cpp:587-620).
"""
from __future__ import annotations

import numpy as np

# strip segment -> cube face offset (renderer.cpp:684-714)
_SEGMENT_TO_FACE = [3, 1, 4, 5, 2, 0]   # left right up down back front
FACE_NAMES = ['front', 'right', 'back', 'left', 'top', 'bottom']


def apply_watermark(face_img: np.ndarray, watermark: np.ndarray,
                    face_index: int) -> np.ndarray:
    """Alpha-blend the watermark centered on a face (renderer.cpp:636-654).

    face_img: (H, W, 3|4) float; watermark: (h, w, 4) float with alpha.
    Only faces with face_index % 6 < 4 are watermarked.
    """
    if face_index % 6 >= 4 or watermark is None:
        return face_img
    out = np.array(face_img, copy=True)
    h, w = face_img.shape[:2]
    wh, ww = watermark.shape[:2]
    x0 = int((w - ww) * 0.5)
    y0 = int((h - wh) * 0.5)
    xs0, ys0 = max(0, x0), max(0, y0)
    xs1, ys1 = min(w, x0 + ww), min(h, y0 + wh)
    if xs1 <= xs0 or ys1 <= ys0:
        return out
    sub = out[ys0:ys1, xs0:xs1]
    wm = watermark[ys0 - y0:ys1 - y0, xs0 - x0:xs1 - x0]
    a = wm[..., 3:4]
    out[ys0:ys1, xs0:xs1, :3] = (1.0 - a) * sub[..., :3] + a * wm[..., :3]
    if out.shape[-1] == 4:
        out[ys0:ys1, xs0:xs1, 3:4] = (1.0 - a) * sub[..., 3:4] + a * a
    return out


def assemble_strip(faces: list) -> np.ndarray:
    """Assemble the 12 face images (indexed 0..11 = 6 left-eye then 6
    right-eye, face order front,right,back,left,up,down) into the final
    12W x H strip (renderer.cpp:665-716), including the eye-swap quirk."""
    assert len(faces) == 12
    h, w = faces[0].shape[:2]
    segments = []
    for segment in range(12):
        eye_index = 1 if segment // 6 == 0 else 0     # the quirk (:677)
        face = 6 * eye_index + _SEGMENT_TO_FACE[segment % 6]
        segments.append(faces[face])
    return np.concatenate(segments, axis=1)


def face_filename(scene_base: str, camera_name: str, face_index: int) -> str:
    """Per-face debug JPEG name (renderer.cpp:587-620)."""
    eye = 'left' if face_index < 6 else 'right'
    return (f"{scene_base}_{camera_name}_"
            f"{FACE_NAMES[face_index % 6]}_image_{eye}.jpg")


def strip_filename(scene_base: str, camera_name: str) -> str:
    """Final cube-map strip name `<scene>_<camera>.jpg` (renderer.cpp:717)."""
    return f"{scene_base}_{camera_name}.jpg"


def load_watermark() -> np.ndarray:
    """The packaged PNG watermark resource: the analog of the DLL's
    embedded watermarkwhitetrasp_100x100.png decoded from memory via
    FreeImage (renderer.cpp:48-97).  Here the 100x100 RGBA PNG ships as
    package data (our own glyph, not the reference's logo bitmap) and is
    decoded by io/image.read_png; the procedural glyph remains the
    fallback if package data is missing."""
    import os
    from ..io import image as gimage
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'resources', 'watermark_100x100.png')
    try:
        wm = gimage.read_png(path)
    except OSError:
        return default_watermark()
    rgba = gimage.to_float_rgb(wm)
    if rgba.shape[2] == 3:
        rgba = np.concatenate([rgba, np.ones_like(rgba[..., :1])], -1)
    return rgba


def default_watermark(size: int = 100) -> np.ndarray:
    """Procedural fallback for the packaged PNG resource (see
    load_watermark): a translucent white 'Y' glyph on a transparent
    background, 100x100."""
    wm = np.zeros((size, size, 4), np.float32)
    c = size // 2
    for y in range(size):
        for x in range(size):
            # stem
            if abs(x - c) < size * 0.06 and y > c:
                wm[y, x] = (1, 1, 1, 0.35)
            # arms
            dy = y - size * 0.2
            if 0 <= dy <= c * 0.7:
                if abs((x - c) + (dy - c * 0.35)) < size * 0.07 \
                        or abs((x - c) - (dy - c * 0.35)) < size * 0.07:
                    wm[y, x] = (1, 1, 1, 0.35)
    return wm
