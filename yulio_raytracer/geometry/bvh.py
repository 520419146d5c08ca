"""Host-side BVH build + flattening for stackless traversal.

Replaces Embree's BVH4 construction (`rtcCommit`, scene_flat.h:108).  The
build runs once at scene-commit time on the host (binned SAH); the
*layout* serves both traversals (ops/traverse.py, ops/traverse_triton.py):

* depth-first order with **skip pointers**: an interior hit continues to
  node i+1, a miss (or finished leaf) jumps to skip[i].  Traversal needs no
  stack — every ray's state is a single int32, so a whole wavefront walks
  the tree in lockstep inside one `lax.while_loop`.
* a leaf-size cap chosen by the caller (scene.commit's default is the
  GPU's measured choice, PERF.md).
* leaf triangle ranges are contiguous in a permuted triangle order; the
  packed geometry arrays are permuted once at commit so traversal needs no
  extra indirection.

A C++ builder (native/bvh_builder.cpp) accelerates large scenes.  It is
built from source on first use (`make -C native libyrt_native.so`); when
that fails, a warning names the cause and the numpy build below — the
reference implementation — takes over.
"""
from __future__ import annotations

from dataclasses import dataclass

import os

import numpy as np


@dataclass
class FlatBVH:
    lo: np.ndarray      # (N, 3) f32
    hi: np.ndarray      # (N, 3) f32
    start: np.ndarray   # (N,) i32  leaf: first triangle (in permuted order)
    count: np.ndarray   # (N,) i32  leaf: #tris; 0 for interior nodes
    skip: np.ndarray    # (N,) i32  next node on miss / after leaf (N = done)
    # (R,) i64 gather list new position -> old triangle index.  Object
    # builds: a permutation (R == T).  Spatial-split (SBVH) builds:
    # straddling triangles are referenced by several leaves, so R >= T
    # and per-triangle arrays must be GATHERED, not permuted
    # (permute_geom does exactly that).
    order: np.ndarray
    num_nodes: int

    @property
    def num_refs(self) -> int:
        return int(len(self.order))


def _sah_split(lo, hi, cent, idx, nbins=16):
    """Binned SAH split of triangle subset idx. Returns (axis, left_idx,
    right_idx) or None if no good split."""
    clo = cent[idx].min(axis=0)
    chi = cent[idx].max(axis=0)
    ext = chi - clo
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-30:
        return None
    # bin by centroid
    scale = nbins * (1.0 - 1e-6) / ext[axis]
    b = ((cent[idx, axis] - clo[axis]) * scale).astype(np.int32)
    b = np.clip(b, 0, nbins - 1)

    # per-bin counts and bounds
    counts = np.zeros(nbins, np.int64)
    blo = np.full((nbins, 3), np.inf, np.float64)
    bhi = np.full((nbins, 3), -np.inf, np.float64)
    for k in range(nbins):
        sel = b == k
        counts[k] = sel.sum()
        if counts[k]:
            blo[k] = lo[idx[sel]].min(axis=0)
            bhi[k] = hi[idx[sel]].max(axis=0)

    def area(l, h):
        d = np.maximum(h - l, 0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    # sweep: cost of splitting after bin k
    llo = np.minimum.accumulate(blo, axis=0)
    lhi = np.maximum.accumulate(bhi, axis=0)
    rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
    rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
    lcnt = np.cumsum(counts)
    rcnt = np.cumsum(counts[::-1])[::-1]
    cost = np.full(nbins - 1, np.inf)
    for k in range(nbins - 1):
        if lcnt[k] == 0 or rcnt[k + 1] == 0:
            continue
        cost[k] = (lcnt[k] * area(llo[k], lhi[k])
                   + rcnt[k + 1] * area(rlo[k + 1], rhi[k + 1]))
    k = int(np.argmin(cost))
    if not np.isfinite(cost[k]):
        # fallback: median split on the widest axis
        med = np.median(cent[idx, axis])
        left = idx[cent[idx, axis] <= med]
        right = idx[cent[idx, axis] > med]
        if len(left) == 0 or len(right) == 0:
            half = len(idx) // 2
            srt = idx[np.argsort(cent[idx, axis], kind='stable')]
            left, right = srt[:half], srt[half:]
        return axis, left, right
    sel = b <= k
    return axis, idx[sel], idx[~sel]


_native = None
_native_checked = False
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'native')


def _build_native_lib(so: str) -> str | None:
    """Build native/libyrt_native.so from its tracked source.  Returns
    None on success, else the cause.  A file lock keeps concurrent
    processes (test workers) from building over each other."""
    import fcntl
    import subprocess
    with open(os.path.join(_NATIVE_DIR, '.build.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return None
        try:
            r = subprocess.run(['make', '-C', _NATIVE_DIR,
                                'libyrt_native.so'], capture_output=True,
                               text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f'make failed to run: {e}'
        if r.returncode != 0:
            return ('make exited %d: %s' % (
                r.returncode, (r.stderr or r.stdout).strip()[-400:]))
    return None


def _load_native():
    """ctypes binding to native/libyrt_native.so (the C++ binned-SAH
    builder — the native-code analog of Embree's rtcCommit build),
    building it on first use."""
    global _native, _native_checked
    if _native_checked:
        return _native
    _native_checked = True
    import ctypes
    from ..utils import logging as glog
    so = os.path.join(_NATIVE_DIR, 'libyrt_native.so')
    cause = None if os.path.exists(so) else _build_native_lib(so)
    if cause is not None:
        glog.warning('native BVH builder unavailable (%s); using the '
                     'slower numpy builder' % cause)
        return None
    try:
        lib = ctypes.CDLL(so)
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C')
        u8p = np.ctypeslib.ndpointer(np.uint8, flags='C')
        i32p = np.ctypeslib.ndpointer(np.int32, flags='C')
        i64p = np.ctypeslib.ndpointer(np.int64, flags='C')
        lib.yrt_build_bvh.restype = ctypes.c_int64
        lib.yrt_build_bvh.argtypes = [
            f32p, f32p, f32p, u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, f32p, f32p, i32p, i32p, i32p, i64p,
            ctypes.c_int64]
        lib.yrt_build_sbvh.restype = ctypes.c_int64
        lib.yrt_build_sbvh.argtypes = [
            f32p, f32p, f32p, u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.c_float, f32p, f32p, i32p, i32p,
            i32p, i64p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags='C')]
        _native = lib
    except (OSError, AttributeError) as e:
        glog.warning('native BVH builder %s failed to load (%s); using '
                     'the slower numpy builder' % (so, e))
        _native = None
    return _native


def build_native(v0, e1, e2, valid, leaf_size=64, nbins=16):
    """Build via the C++ library; returns None if unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    t = len(v0)
    max_nodes = max(2 * t + 8, 64)
    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    start = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    skip = np.empty(max_nodes, np.int32)
    order = np.empty(t, np.int64)
    n = lib.yrt_build_bvh(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        np.ascontiguousarray(valid, np.uint8),
        t, leaf_size, nbins, lo, hi, start, count, skip, order, max_nodes)
    if n < 0:
        return None
    n = int(n)
    return FlatBVH(lo[:n].copy(), hi[:n].copy(), start[:n].copy(),
                   count[:n].copy(), skip[:n].copy(), order, n)


def build_native_sbvh(v0, e1, e2, valid, leaf_size=64, nbins=16,
                      alpha=1e-5, max_refs_factor=2.0, spatial=True,
                      align_rows=True, c_trav=-1.0):
    """High-quality build via the C++ library — the RTC_SCENE_HIGH_QUALITY
    analog (scene_flat.h:93: the reference commits every scene with
    spatial splits enabled).  Three quality mechanisms, separately
    toggleable for ablation:

    * spatial: SBVH spatial splits — straddling triangles are duplicated
      into both children (budget: max_refs_factor x T).
    * align_rows: leaf starts aligned to multiples of 8 triangles via
      tail padding (invalid padding triangles).
    * c_trav >= 0: row-quantized SAH leaf termination (adaptive leaf
      sizes below leaf_size; c_trav = interior-visit cost in row units).

    The returned `order` is a gather list with len(order) >= T.  Returns
    None if the library is unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    t = len(v0)
    max_refs = int(np.ceil(max_refs_factor * max(t, 1))) + 64
    max_nodes = max(2 * max_refs + 8, 64)
    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    start = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    skip = np.empty(max_nodes, np.int32)
    order = np.empty(max_refs, np.int64)
    nrefs = np.zeros(1, np.int64)
    flags = (1 if spatial else 0) | (2 if align_rows else 0)
    n = lib.yrt_build_sbvh(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        np.ascontiguousarray(valid, np.uint8),
        t, leaf_size, nbins, np.float32(alpha), flags,
        np.float32(c_trav), lo, hi, start, count,
        skip, order, max_nodes, max_refs, nrefs)
    if n < 0:
        return None
    n = int(n)
    r = int(nrefs[0])
    return FlatBVH(lo[:n].copy(), hi[:n].copy(), start[:n].copy(),
                   count[:n].copy(), skip[:n].copy(), order[:r].copy(), n)


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
          valid: np.ndarray | None = None,
          leaf_size: int = 64, nbins: int = 16,
          use_native: bool = True, bounds=None,
          quality: str = 'normal') -> FlatBVH:
    """Build a flattened skip-pointer BVH over triangles (v0, v0+e1, v0+e2).

    quality levels (the RTC_SCENE_HIGH_QUALITY analog, scene_flat.h:93):
      'normal'       object-split binned SAH.
      'high'         object-split + row-aligned leaf packing (leaf starts
                     padded to multiples of 8 triangles).
      'high-spatial' SBVH spatial splits + aligned packing (Embree's
                     actual high-quality mechanism, kept for parity and
                     for scenes whose overlap pathology outweighs the
                     duplicated references).

    Invalid (padding/degenerate) triangles are packed into the final leaf's
    tail positions with empty bounds so they are never hit.  `bounds`
    overrides the per-triangle boxes (motion blur builds over the union
    of the t=0 and t=1 boxes — the bvh4mb analog); the override always
    uses the numpy builder.
    """
    t = len(v0)
    if valid is None:
        valid = np.ones(t, bool)
    if use_native and bounds is None:
        if quality in ('high', 'high-spatial'):
            nat = build_native_sbvh(v0, e1, e2, valid, leaf_size, nbins,
                                    spatial=quality == 'high-spatial')
            if nat is not None:
                return nat
            # no native lib: fall through to the numpy object-split build
            # (capability-correct, lower tree quality)
        nat = build_native(v0, e1, e2, valid, leaf_size, nbins)
        if nat is not None:
            return nat
    if bounds is not None:
        lo = np.asarray(bounds[0], np.float64).copy()
        hi = np.asarray(bounds[1], np.float64).copy()
    else:
        p1 = v0 + e1
        p2 = v0 + e2
        lo = np.minimum(np.minimum(v0, p1), p2).astype(np.float64)
        hi = np.maximum(np.maximum(v0, p1), p2).astype(np.float64)
    if valid is None:
        valid = np.ones(t, bool)
    cent = 0.5 * (lo + hi)
    cent[~valid] = 0.0
    # degenerate/padding tris get empty boxes so they never traverse
    lo[~valid] = np.inf
    hi[~valid] = -np.inf
    live = np.nonzero(valid)[0]
    dead = np.nonzero(~valid)[0]

    nodes = []      # list of [lo, hi, start, count]
    is_leaf = []
    order = []

    def emit(idx) -> int:
        """Iteratively emit subtrees in DFS order (explicit stack — large
        scenes would blow Python's recursion limit).  Returns root id."""
        root_id = len(nodes)
        stack = [np.asarray(idx)]
        while stack:
            sub = stack.pop()
            me = len(nodes)
            if len(sub):
                nlo = lo[sub].min(axis=0)
                nhi = hi[sub].max(axis=0)
            else:
                nlo = np.full(3, np.inf)
                nhi = np.full(3, -np.inf)
            split = None
            if len(sub) > leaf_size:
                split = _sah_split(lo, hi, cent, sub, nbins)
            if split is None:
                nodes.append([nlo, nhi, len(order), len(sub)])
                is_leaf.append(True)
                order.extend(sub.tolist())
            else:
                _, left, right = split
                nodes.append([nlo, nhi, 0, 0])
                is_leaf.append(False)
                # DFS order: left subtree immediately follows, so push
                # right first
                stack.append(right)
                stack.append(left)
        return root_id

    emit(live)
    n = len(nodes)

    # skip pointers: node i's subtree occupies [i, end); skip[i] = end.
    # In DFS order, end(leaf) = i+1 and end(interior) = end(right child)
    # = end(end(left child)) — computable right-to-left with a stack.
    skip = np.zeros(n, np.int32)
    stack: list[int] = []
    for i in range(n - 1, -1, -1):
        if is_leaf[i]:
            skip[i] = i + 1
            stack.append(i + 1)
        else:
            # children of i are i+1 (left) and the subtree after it (right);
            # end(i) == end(right). Pop the two subtree-ends produced by the
            # children; the later one is end(i).
            end_left = stack.pop()
            end_right = stack.pop()
            # end_left was pushed by node i+1, end_right by the right child;
            # end(i) is the right child's end
            skip[i] = end_right
            stack.append(end_right)

    order.extend(dead.tolist())
    order_arr = np.asarray(order, np.int64)
    assert len(order_arr) == t

    return FlatBVH(
        lo=np.stack([nd[0] for nd in nodes]).astype(np.float32),
        hi=np.stack([nd[1] for nd in nodes]).astype(np.float32),
        start=np.asarray([nd[2] for nd in nodes], np.int32),
        count=np.asarray([nd[3] for nd in nodes], np.int32),
        skip=skip,
        order=order_arr,
        num_nodes=n,
    )


def motion_bounds(v0, e1, e2, mv0, me1, me2):
    """Per-triangle union bounds over t in [0, 1] (linear motion: the
    union of the t=0 and t=1 triangle boxes is exact)."""
    cs = [v0, v0 + e1, v0 + e2]
    cs += [c + m for c, m in zip(cs, (mv0, mv0 + me1, mv0 + me2))]
    lo = np.min(np.stack(cs), axis=0)
    hi = np.max(np.stack(cs), axis=0)
    return lo.astype(np.float64), hi.astype(np.float64)


_PER_TRIANGLE_KEYS = frozenset({
    'v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id', 'cull',
    'illum_mask', 'shadow_mask', 'valid', 'mv0', 'me1', 'me2',
    'ptx', 'pty'})


def permute_geom(geom: dict, order: np.ndarray) -> dict:
    """Apply the BVH triangle permutation to the per-triangle arrays of a
    geometry dict (host numpy or device jnp)."""
    return {k: (a[order] if k in _PER_TRIANGLE_KEYS else a)
            for k, a in geom.items()}


def to_device(bvh: FlatBVH) -> dict:
    import jax.numpy as jnp
    return {
        'lo': jnp.asarray(bvh.lo),
        'hi': jnp.asarray(bvh.hi),
        'start': jnp.asarray(bvh.start),
        'count': jnp.asarray(bvh.count),
        'skip': jnp.asarray(bvh.skip),
    }
