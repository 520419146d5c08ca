"""Vector / affine-space math over batched arrays.

Replacement for the reference's `common/math/{vec3,affinespace,
bbox,bsphere}.h`: instead of scalar Vector3f classes, every helper operates on
`(..., 3)` float arrays so the whole image's rays are one tensor and XLA
vectorizes them (the reference needed hand-written SSE/AVX wrappers in
`common/simd/` for the same effect).

Affine spaces follow the reference convention (`common/math/affinespace.h`):
a 3x3 linear part `l` with column vectors (vx, vy, vz) plus a translation `p`.
We store them as a single (..., 4, 3) array: rows 0..2 are vx, vy, vz and
row 3 is p.  `xfm_point(A, x) = x @ A[:3] + A[3]`.  Every product here runs
at HIGHEST precision: a GPU would otherwise round f32 matmul operands to
TF32 (about three decimal digits), which moves camera rays and light
frames visibly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


def _vecmat(x, m):
    """x (..., 3) times m (..., 3, 3) in full f32."""
    return jnp.einsum('...i,...ij->...j', x, m, precision=_HI)


# --------------------------------------------------------------------------
# vec3 helpers (broadcast over leading dims)
# --------------------------------------------------------------------------

def vec3(x, y, z, dtype=jnp.float32):
    return jnp.stack([jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                      jnp.asarray(z, dtype)], axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a, eps=1e-20):
    return a / jnp.maximum(length(a), eps)[..., None]


def safe_rsqrt(x, eps=1e-20):
    return 1.0 / jnp.sqrt(jnp.maximum(x, eps))


def distance(a, b):
    return length(a - b)


def reflect(v, n, cos_i=None):
    """Reflect viewing vector v about normal n (reference optics.h:30-39).

    Note the reference convention: v points *away* from the surface and the
    result also points away: r = 2*dot(v,n)*n - v.
    """
    if cos_i is None:
        cos_i = dot(v, n)
    return 2.0 * cos_i[..., None] * n - v


def refract(v, n, eta, cos_i):
    """Refract v about n with relative IOR eta (reference optics.h:80-87).

    v and n point to the same side.  Returns (direction, valid, cos_t).
    On total internal reflection valid=False and direction is zeros.
    """
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    valid = k >= 0.0
    cos_t = jnp.sqrt(jnp.maximum(k, 0.0))
    d = eta[..., None] * (cos_i[..., None] * n - v) - cos_t[..., None] * n
    return jnp.where(valid[..., None], d, 0.0), valid, cos_t


def face_forward(n, d):
    """Flip n so it faces against direction d (dot(n, d) <= 0)."""
    return jnp.where(dot(n, d)[..., None] > 0.0, -n, n)


def luminance(c):
    """Luminance weight used by CompositedBRDF::sample (compositedbrdf.h:150)
    — the reference uses the plain channel sum r+g+b, not Rec.709."""
    return jnp.sum(c, axis=-1)


# --------------------------------------------------------------------------
# orthonormal frames
# --------------------------------------------------------------------------

def frame(n):
    """Build an orthonormal frame around unit normal n.

    Matches the reference's `frame(N)` (common/math/linearspace3.h): pick the
    smallest component axis to avoid degeneracy.  Returns (dx, dy, n).
    """
    a = jnp.abs(n)
    # choose helper axis = unit vector of the smallest |component|
    smallest = jnp.argmin(a, axis=-1)
    helper = jnp.eye(3, dtype=n.dtype)[smallest]
    dx = normalize(cross(helper, n))
    dy = cross(n, dx)
    return dx, dy, n


# --------------------------------------------------------------------------
# affine spaces: (..., 4, 3) arrays [vx; vy; vz; p]
# --------------------------------------------------------------------------

def affine(vx, vy, vz, p):
    return jnp.stack([vx, vy, vz, p], axis=-2)


def affine_identity(dtype=jnp.float32):
    return jnp.concatenate([jnp.eye(3, dtype=dtype),
                            jnp.zeros((1, 3), dtype=dtype)], axis=0)


def xfm_point(a, x):
    """Transform points x (..., 3) by affine a (..., 4, 3)."""
    return _vecmat(x, a[..., :3, :]) + a[..., 3, :]


def xfm_vector(a, x):
    """Transform direction x (no translation)."""
    return _vecmat(x, a[..., :3, :])


def xfm_normal(a, n):
    """Transform a normal: n' = n @ inv(l) transposed appropriately."""
    l = a[..., :3, :]
    linv = jnp.linalg.inv(jnp.swapaxes(l, -1, -2))
    return _vecmat(n, jnp.swapaxes(linv, -1, -2))


def affine_compose(a, b):
    """Compose: (a * b)(x) = a(b(x)) — matches AffineSpace3f operator*."""
    lb = b[..., :3, :]
    pb = b[..., 3, :]
    la = a[..., :3, :]
    pa = a[..., 3, :]
    l = jnp.matmul(lb, la, precision=_HI)
    p = _vecmat(pb, la) + pa
    return jnp.concatenate([l, p[..., None, :]], axis=-2)


def affine_translate(t):
    t = jnp.asarray(t, jnp.float32)
    return jnp.concatenate([jnp.eye(3, dtype=jnp.float32), t[None, :]], axis=0)


def affine_rotate(center, axis, angle):
    """Rotation about an axis through a center point (AffineSpace3f::rotate)."""
    center = jnp.asarray(center, jnp.float32)
    axis = jnp.asarray(axis, jnp.float32)
    u = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-20)
    c, s = jnp.cos(angle), jnp.sin(angle)
    x, y, z = u[0], u[1], u[2]
    # Rodrigues rotation in row-vector convention (x' = x @ L, L = R^T)
    l = jnp.stack([
        jnp.stack([c + x * x * (1 - c), x * y * (1 - c) + z * s, x * z * (1 - c) - y * s]),
        jnp.stack([y * x * (1 - c) - z * s, c + y * y * (1 - c), y * z * (1 - c) + x * s]),
        jnp.stack([z * x * (1 - c) + y * s, z * y * (1 - c) - x * s, c + z * z * (1 - c)]),
    ]).astype(jnp.float32)
    rot = jnp.concatenate([l, jnp.zeros((1, 3), jnp.float32)], axis=0)
    # translate(-center) then rotate then translate(center)
    return affine_compose(affine_compose(affine_translate(center), rot),
                          affine_translate(-center))


def rotate_about_axis(v, u, angle):
    """Rodrigues rotation of vectors v (..., 3) about unit axis u by angle
    (broadcastable): v' = v cos + (u x v) sin + u (u.v)(1 - cos).
    Matches affine_rotate's handedness."""
    c = jnp.cos(angle)[..., None]
    s = jnp.sin(angle)[..., None]
    ub = jnp.broadcast_to(u, v.shape)
    return (v * c + cross(ub, v) * s
            + ub * (dot(ub, v) * (1.0 - c[..., 0]))[..., None])


def affine_inverse(a):
    l = a[..., :3, :]
    p = a[..., 3, :]
    linv = jnp.linalg.inv(l)
    pinv = -_vecmat(p, linv)
    return jnp.concatenate([linv, pinv[..., None, :]], axis=-2)


# --------------------------------------------------------------------------
# bounding volumes (host-side numpy: scene build time)
# --------------------------------------------------------------------------

def bbox_union_np(vertices: np.ndarray):
    """(lower, upper) of an (N, 3) vertex array; empty -> +inf/-inf."""
    if vertices.size == 0:
        return (np.full(3, np.inf, np.float32), np.full(3, -np.inf, np.float32))
    return (vertices.min(axis=0).astype(np.float32),
            vertices.max(axis=0).astype(np.float32))


def bsphere_of_bbox(lower, upper):
    """Bounding sphere of a bbox (reference getBSphere, used by AmbientLight
    — ambientlight.h:43-47 multiplies the radius by 1.5)."""
    center = 0.5 * (np.asarray(lower) + np.asarray(upper))
    radius = float(np.linalg.norm(np.asarray(upper) - center))
    return center.astype(np.float32), np.float32(radius)


def ray_sphere_tfar(org, direction, center, radius):
    """Distance to the far intersection of a ray with a sphere, for the
    ambient dome's shadow-ray tMax (ambientlight.h:67-80).

    Returns (hit, t_far); org may be inside the sphere (the common case).
    """
    oc = org - center
    b = dot(direction, oc)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    hit = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_far = -b + sq
    return hit & (t_far > 0.0), t_far


# --------------------------------------------------------------------------
# misc scalar helpers
# --------------------------------------------------------------------------

def smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def deg2rad(x):
    return x * (np.pi / 180.0)


def rad2deg(x):
    return x * (180.0 / np.pi)
