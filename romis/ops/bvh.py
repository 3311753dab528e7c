"""BVH build (host-side) and flattened threaded layout for traversal.

This replaces Embree's acceleration structure (reference:
src/ray_tracing/embree_interface.cpp:30-51, RTC_BUILD_QUALITY_HIGH). The
build runs once per scene on the host:

- preferred: the native C++ binned-SAH builder (native/bvh_builder.cpp,
  compiled into native/build/ at first use — or by ``make -C native`` — and
  called through ctypes),
- fallback when no C++ compiler is present: a NumPy median-split builder
  with identical output layout. ``builder_name()`` says which one runs.

Layout is *threaded* (stackless skip-link) in DFS preorder:
- inner node at index i has its first child at i+1 and a ``miss_link`` to
  jump to when the ray misses its box (the node after its subtree),
- leaves own a contiguous [first, first+count) range of the *reordered*
  triangle arrays (we physically permute the geometry so tri_order is the
  identity — leaf tests become contiguous gathers),
- traversal state per ray is a single int cursor → a wavefront with no
  per-ray stack (see ops/traverse.py).

All node columns are stored as separate [N_nodes] arrays (image-minor gather
discipline, see core/vec.py).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import warnings

import numpy as np
import jax.numpy as jnp

from ..core.types import pytree_dataclass

MAX_LEAF = 4  # static unroll bound in the traversal kernels


@pytree_dataclass
class BVH:
    # Node columns [N_nodes] (DFS preorder; first child = parent + 1).
    bmin_x: jnp.ndarray
    bmin_y: jnp.ndarray
    bmin_z: jnp.ndarray
    bmax_x: jnp.ndarray
    bmax_y: jnp.ndarray
    bmax_z: jnp.ndarray
    miss_link: jnp.ndarray  # int32, -1 terminates traversal
    leaf_first: jnp.ndarray  # int32, -1 for inner nodes
    leaf_count: jnp.ndarray  # int32, 0 for inner nodes

    @property
    def n_nodes(self) -> int:
        return self.bmin_x.shape[0]


_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_NATIVE_LIB = os.path.join(_NATIVE_DIR, "build", "libromis_native.so")


def _compile_native() -> str | None:
    """Build native/build/libromis_native.so from native/bvh_builder.cpp
    with the system C++ compiler. Returns an error text, or None on
    success."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return "no C++ compiler found"
    os.makedirs(os.path.dirname(_NATIVE_LIB), exist_ok=True)
    tmp = f"{_NATIVE_LIB}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
           os.path.join(_NATIVE_DIR, "bvh_builder.cpp")]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as err:
        return f"{' '.join(cmd)} failed: {getattr(err, 'stderr', err)}"
    os.replace(tmp, _NATIVE_LIB)  # atomic: concurrent builders never race
    return None


@functools.cache
def native_builder():
    """The ctypes handle of the native SAH builder, compiling it on first
    use; None (with a warning saying why) when it cannot be built."""
    lib = None
    err = None
    if not os.path.exists(_NATIVE_LIB):
        err = _compile_native()
    if err is None:
        try:
            lib = ctypes.CDLL(os.path.abspath(_NATIVE_LIB))
        except OSError as e:
            err = str(e)
    if lib is not None:
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bvh_build_sah.restype = ctypes.c_int32
        lib.bvh_build_sah.argtypes = [f32p, f32p, f32p, ctypes.c_int32,
                                      ctypes.c_int32,
                                      f32p, f32p, i32p, i32p, i32p, i32p,
                                      i32p]
    else:
        warnings.warn(f"native BVH builder unavailable ({err}); using the "
                      "NumPy median-split builder")
    return lib


def builder_name() -> str:
    """Which BVH builder build_bvh uses in this process."""
    if native_builder() is not None:
        return f"native binned SAH ({os.path.abspath(_NATIVE_LIB)})"
    return "NumPy median split"


def _build_arrays_native(v0, e1, e2, max_leaf):
    n = len(v0)
    cap = 2 * n
    bmin = np.zeros((cap, 3), np.float32)
    bmax = np.zeros((cap, 3), np.float32)
    left = np.zeros(cap, np.int32)
    right = np.zeros(cap, np.int32)
    lfirst = np.zeros(cap, np.int32)
    lcount = np.zeros(cap, np.int32)
    order = np.zeros(n, np.int32)

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def pi(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    n_nodes = native_builder().bvh_build_sah(
        p32(v0), p32(e1), p32(e2), n, max_leaf,
        p32(bmin), p32(bmax), pi(left), pi(right), pi(lfirst), pi(lcount),
        pi(order))
    if n_nodes < 0:
        raise RuntimeError("native BVH build failed")
    return (bmin[:n_nodes], bmax[:n_nodes], left[:n_nodes], right[:n_nodes],
            lfirst[:n_nodes], lcount[:n_nodes], order)


def _build_arrays_numpy(v0, e1, e2, max_leaf):
    """Median-split fallback with the same DFS-preorder output contract."""
    n = len(v0)
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    cent = 0.5 * (lo + hi)

    bmin, bmax, left, right, lfirst, lcount = [], [], [], [], [], []
    order = np.arange(n, dtype=np.int32)

    def build(idxs):
        node = len(bmin)
        bmin.append(lo[idxs].min(axis=0))
        bmax.append(hi[idxs].max(axis=0))
        left.append(-1)
        right.append(-1)
        if len(idxs) <= max_leaf:
            lfirst.append(-2)  # patched below: position in final order
            lcount.append(len(idxs))
            build.leaves.append((node, idxs))
            return node
        lfirst.append(-1)
        lcount.append(0)
        ext = cent[idxs].max(axis=0) - cent[idxs].min(axis=0)
        axis = int(np.argmax(ext))
        med = np.argsort(cent[idxs, axis], kind="stable")
        half = len(idxs) // 2
        l = build(idxs[med[:half]])
        r = build(idxs[med[half:]])
        left[node] = l
        right[node] = r
        return node

    build.leaves = []
    build(order)

    final_order = []
    for node, idxs in build.leaves:
        lfirst[node] = len(final_order)
        final_order.extend(idxs.tolist())
    return (np.asarray(bmin, np.float32), np.asarray(bmax, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(lfirst, np.int32), np.asarray(lcount, np.int32),
            np.asarray(final_order, np.int32))


def _thread_links(left, right):
    """miss_link per node for DFS-preorder skip traversal."""
    n = len(left)
    miss = np.full(n, -1, np.int32)

    def assign(node, miss_of_node):
        miss[node] = miss_of_node
        l, r = left[node], right[node]
        if l >= 0:
            assign(l, r)  # after the left subtree comes the right child
            assign(r, miss_of_node)

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 100))
    try:
        assign(0, -1)
    finally:
        sys.setrecursionlimit(old)
    return miss


def build_bvh(geometry, max_leaf: int = MAX_LEAF):
    """Build a BVH over the *active* triangles of ``geometry`` and return
    (BVH, geometry with triangles permuted so leaves are contiguous).

    The native SAH builder is used when available; leaf ranges never touch
    the padded (inactive) triangles, which are moved to the tail."""
    active = np.asarray(geometry.active)
    act_idx = np.nonzero(active)[0]
    pad_idx = np.nonzero(~active)[0]
    v0 = np.ascontiguousarray(np.asarray(geometry.v0)[act_idx])
    e1 = np.ascontiguousarray(np.asarray(geometry.e1)[act_idx])
    e2 = np.ascontiguousarray(np.asarray(geometry.e2)[act_idx])

    if native_builder() is not None:
        bmin, bmax, left, right, lfirst, lcount, order = _build_arrays_native(
            v0, e1, e2, max_leaf)
    else:
        bmin, bmax, left, right, lfirst, lcount, order = _build_arrays_numpy(
            v0, e1, e2, max_leaf)

    miss = _thread_links(left, right)

    # Verify the contracts the threaded traversal relies on (both
    # builders): DFS preorder — every inner node's left child directly
    # follows it — and leaf ranges partitioning [0, n_active) in node order.
    inner = left >= 0
    assert np.array_equal(left[inner], np.nonzero(inner)[0] + 1), (
        "BVH builder violated DFS preorder (left child != parent + 1)")
    starts = lfirst[~inner]
    ends = starts + lcount[~inner]
    assert (len(starts) > 0 and starts[0] == 0
            and np.array_equal(starts[1:], ends[:-1])
            and int(ends[-1]) == len(v0)), (
        "BVH leaf ranges do not partition [0, n) in preorder")

    perm = np.concatenate([act_idx[order], pad_idx]).astype(np.int32)
    geometry = geometry.replace(
        **{f: jnp.asarray(np.asarray(getattr(geometry, f))[perm])
           for f in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1",
                     "uv2", "mat_id", "geom_id", "active")})
    from ..scene.scene import repack_rows

    geometry = repack_rows(geometry)  # keep packed row tables in sync

    bvh = BVH(
        bmin_x=jnp.asarray(bmin[:, 0]), bmin_y=jnp.asarray(bmin[:, 1]),
        bmin_z=jnp.asarray(bmin[:, 2]), bmax_x=jnp.asarray(bmax[:, 0]),
        bmax_y=jnp.asarray(bmax[:, 1]), bmax_z=jnp.asarray(bmax[:, 2]),
        miss_link=jnp.asarray(miss), leaf_first=jnp.asarray(lfirst),
        leaf_count=jnp.asarray(lcount),
    )
    return bvh, geometry


def with_bvh(geometry, max_leaf: int = MAX_LEAF):
    """Attach a BVH to a Geometry: builds over the active triangles, permutes
    them leaf-contiguously, and stores the BVH on geometry.bvh so every
    ops.intersect entry point dispatches to the wavefront traversal."""
    bvh, geometry = build_bvh(geometry, max_leaf)
    return geometry.replace(bvh=bvh)


def sah_cost(bvh: BVH) -> float:
    """Total SAH cost (for build-quality tests/diagnostics)."""
    bmin = np.stack([np.asarray(bvh.bmin_x), np.asarray(bvh.bmin_y),
                     np.asarray(bvh.bmin_z)], -1)
    bmax = np.stack([np.asarray(bvh.bmax_x), np.asarray(bvh.bmax_y),
                     np.asarray(bvh.bmax_z)], -1)
    d = np.maximum(bmax - bmin, 0)
    area = 2 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    counts = np.asarray(bvh.leaf_count)
    root = max(area[0], 1e-12)
    return float((area * np.maximum(counts, 1)).sum() / root)
