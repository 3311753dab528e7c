"""Device-side scene representation (SoA) and prebuilt scenes.

Reference analogs: Scene/loadScenePrebuilt (src/scene/scene.{h,cpp}) and the
Embree geometry upload (src/ray_tracing/embree_interface.cpp:30-51). Instead
of per-mesh geometry objects handed to a BVH library, all submeshes are fused
into one flat triangle-soup SoA pytree with per-triangle material and submesh
ids.

Triangle arrays are padded to a multiple of ``TRI_PAD`` with degenerate
(zero-area) triangles so the intersector's triangle blocks divide evenly.

The prebuilt scenes are generated here from a seed (see PARITY.md for where
each departs from the reference's OBJ asset); user OBJ files load through
``load_scene_from_file``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..core.types import pytree_dataclass
from .objloader import Material, SubMesh, load_obj, normalize_submeshes
from .lights import LightListBuilder, LightTable, regular_light_grid

# Triangle-count padding granularity: the brute-force intersector streams
# triangle blocks, so block-size divisibility (8) is all that's needed.
TRI_PAD = 8


@pytree_dataclass
class Geometry:
    """Flattened triangle soup + material table + texture stack.

    ``bvh`` is an optional acceleration structure (ops/bvh.BVH). When set,
    ops.intersect dispatches to the stackless wavefront traversal
    (ops/traverse.py) instead of the brute-force block scan; build it with
    ``romis.ops.bvh.with_bvh(geometry)``. None (the default) is the
    right choice for small scenes (< ~1k triangles)."""

    # Triangles [T, ...] (T padded to TRI_PAD)
    v0: jnp.ndarray  # [T, 3] first vertex
    e1: jnp.ndarray  # [T, 3] v1 - v0 (Möller–Trumbore edge)
    e2: jnp.ndarray  # [T, 3] v2 - v0
    n0: jnp.ndarray  # [T, 3] per-vertex shading normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # [T, 2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    mat_id: jnp.ndarray  # [T] int32
    geom_id: jnp.ndarray  # [T] int32 submesh id (reference geometryId)
    active: jnp.ndarray  # [T] bool (False on padding)

    # Material table [M, ...] (reference Material, framework mesh.h:22-34)
    mat_kd: jnp.ndarray  # [M, 3]
    mat_ks: jnp.ndarray  # [M, 3]
    mat_shininess: jnp.ndarray  # [M]
    mat_tex_id: jnp.ndarray  # [M] int32, -1 = no texture

    # Texture stack [NT, TH, TW, 3] (all textures padded to common size)
    tex_data: jnp.ndarray
    tex_size: jnp.ndarray  # [NT, 2] int32 (height, width)

    # Packed row tables — ONE row-gather per index instead of 20+ scalar
    # component gathers:
    # tri_rows  [T, 12]: v0(3) e1(3) e2(3) active pad(2)   (traversal leaves)
    # attr_rows [T, 24]: n0 n1 n2 (9) uv0 uv1 uv2 (6) mat_id geom_id pad(7)
    # mat_rows  [M, 8]:  kd(3) ks(3) shininess tex_id      (shading context)
    tri_rows: jnp.ndarray
    attr_rows: jnp.ndarray
    mat_rows: jnp.ndarray

    # Optional acceleration structure (ops/bvh.BVH pytree or None).
    bvh: object = None

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


@dataclass
class Scene:
    """Host-side scene bundle handed to the renderer."""

    geometry: Geometry
    lights: LightTable
    num_lights: int
    name: str = "scene"


def _load_texture(texture) -> np.ndarray:
    """An RGB float image in [0, 1]: ``texture`` is either an [H, W, 3]
    array (procedural scenes) or the path of an image file named by a
    user's MTL file, decoded with pillow."""
    if isinstance(texture, np.ndarray):
        return np.asarray(texture, np.float32)
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(
            f"decoding the texture {texture!r} needs pillow (PIL), which is "
            "not installed") from err
    with Image.open(texture) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0


def build_geometry(submeshes: list[SubMesh]) -> Geometry:
    """Fuse submeshes into the flat SoA layout.

    Reference analog: EmbreeInterface::initScene
    (src/ray_tracing/embree_interface.cpp:30-51) — one geometry per submesh
    with a geomID→Material map becomes per-triangle (geom_id, mat_id) columns.
    """
    tri_rows = []
    mats = []
    textures: list[np.ndarray] = []
    tex_paths: dict = {}

    for gid, sm in enumerate(submeshes):
        m = sm.material
        tex_id = -1
        if m.kd_texture is not None:
            tex_key = (m.kd_texture if isinstance(m.kd_texture, str)
                       else id(m.kd_texture))
            if tex_key not in tex_paths:
                tex_paths[tex_key] = len(textures)
                textures.append(_load_texture(m.kd_texture))
            tex_id = tex_paths[tex_key]
        mats.append((m.kd, m.ks, m.shininess, tex_id))
        mat_id = len(mats) - 1
        p, n, uv, t = sm.positions, sm.normals, sm.texcoords, sm.triangles
        for tri in t:
            i0, i1, i2 = int(tri[0]), int(tri[1]), int(tri[2])
            tri_rows.append(
                (p[i0], p[i1] - p[i0], p[i2] - p[i0],
                 n[i0], n[i1], n[i2],
                 uv[i0], uv[i1], uv[i2], mat_id, gid)
            )

    n_tris = len(tri_rows)
    n_pad = max(TRI_PAD, -(-n_tris // TRI_PAD) * TRI_PAD)

    def col(i, dim):
        a = np.zeros((n_pad, dim), np.float32)
        if n_tris:
            a[:n_tris] = np.asarray([r[i] for r in tri_rows], np.float32)
        return a

    mat_kd = np.asarray([m[0] for m in mats], np.float32).reshape(-1, 3)
    mat_ks = np.asarray([m[1] for m in mats], np.float32).reshape(-1, 3)
    mat_sh = np.asarray([m[2] for m in mats], np.float32).reshape(-1)
    mat_tx = np.asarray([m[3] for m in mats], np.int32).reshape(-1)

    if textures:
        th = max(t.shape[0] for t in textures)
        tw = max(t.shape[1] for t in textures)
        tex = np.zeros((len(textures), th, tw, 3), np.float32)
        sizes = np.zeros((len(textures), 2), np.int32)
        for i, t in enumerate(textures):
            tex[i, : t.shape[0], : t.shape[1]] = t
            sizes[i] = (t.shape[0], t.shape[1])
    else:
        tex = np.zeros((1, 1, 1, 3), np.float32)
        sizes = np.ones((1, 2), np.int32)

    active = np.zeros((n_pad,), bool)
    active[:n_tris] = True
    ids = np.zeros((n_pad,), np.int32)
    if n_tris:
        ids[:n_tris] = [r[9] for r in tri_rows]
    gids = np.zeros((n_pad,), np.int32)
    if n_tris:
        gids[:n_tris] = [r[10] for r in tri_rows]

    g = Geometry(
        v0=jnp.asarray(col(0, 3)), e1=jnp.asarray(col(1, 3)),
        e2=jnp.asarray(col(2, 3)), n0=jnp.asarray(col(3, 3)),
        n1=jnp.asarray(col(4, 3)), n2=jnp.asarray(col(5, 3)),
        uv0=jnp.asarray(col(6, 2)), uv1=jnp.asarray(col(7, 2)),
        uv2=jnp.asarray(col(8, 2)),
        mat_id=jnp.asarray(ids), geom_id=jnp.asarray(gids),
        active=jnp.asarray(active),
        mat_kd=jnp.asarray(mat_kd), mat_ks=jnp.asarray(mat_ks),
        mat_shininess=jnp.asarray(mat_sh), mat_tex_id=jnp.asarray(mat_tx),
        tex_data=jnp.asarray(tex), tex_size=jnp.asarray(sizes),
        tri_rows=jnp.zeros(()), attr_rows=jnp.zeros(()),
        mat_rows=jnp.zeros(()),
    )
    return repack_rows(g)


def pack_tri_rows(v0, e1, e2, active):
    n = v0.shape[0]
    return jnp.concatenate(
        [v0, e1, e2, active.astype(jnp.float32)[:, None],
         jnp.zeros((n, 2), jnp.float32)], axis=1)


def pack_attr_rows(n0, n1, n2, uv0, uv1, uv2, mat_id, geom_id):
    n = n0.shape[0]
    return jnp.concatenate(
        [n0, n1, n2, uv0, uv1, uv2,
         mat_id.astype(jnp.float32)[:, None],
         geom_id.astype(jnp.float32)[:, None],
         jnp.zeros((n, 7), jnp.float32)], axis=1)


def pack_mat_rows(mat_kd, mat_ks, mat_shininess, mat_tex_id):
    return jnp.concatenate(
        [mat_kd, mat_ks, mat_shininess[:, None],
         mat_tex_id.astype(jnp.float32)[:, None]], axis=1)


def repack_rows(g: Geometry) -> Geometry:
    """(Re)build the packed row tables from the component columns. Must be
    called after replacing any packed column (diff/grad.apply_params does)."""
    return g.replace(
        tri_rows=pack_tri_rows(g.v0, g.e1, g.e2, g.active),
        attr_rows=pack_attr_rows(g.n0, g.n1, g.n2, g.uv0, g.uv1, g.uv2,
                                 g.mat_id, g.geom_id),
        mat_rows=pack_mat_rows(g.mat_kd, g.mat_ks, g.mat_shininess,
                               g.mat_tex_id),
    )


# ---------------------------------------------------------------------------
# Prebuilt scenes (reference: loadScenePrebuilt, src/scene/scene.cpp:68-132),
# generated from a seed. PARITY.md records where each departs from the
# reference's OBJ asset.
# ---------------------------------------------------------------------------

_WHITE = Material(name="white", kd=(0.73, 0.73, 0.73))


def _quads(origin, edge_u, edge_v, material, toward, nu=1, nv=1,
           uv=False) -> SubMesh:
    """An nu x nv grid of flat quads (2 triangles each) spanning
    origin + s*edge_u + t*edge_v, with its normal turned toward the point
    ``toward``. ``uv``: texture coordinates (s, t) over the whole grid."""
    o, eu, ev = (np.asarray(a, np.float32) for a in (origin, edge_u, edge_v))
    n = np.cross(eu, ev)
    n /= np.linalg.norm(n)
    flip = float(np.dot(n, np.asarray(toward, np.float32)
                        - (o + 0.5 * eu + 0.5 * ev))) < 0.0
    if flip:
        n = -n
    s = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    t = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    ss, tt = np.meshgrid(s, t, indexing="ij")  # [nu+1, nv+1]
    pos = o + ss[..., None] * eu + tt[..., None] * ev
    idx = np.arange((nu + 1) * (nv + 1)).reshape(nu + 1, nv + 1)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    if flip:
        tris = tris[:, ::-1]
    return SubMesh(
        positions=pos.reshape(-1, 3),
        normals=np.tile(n, (pos.shape[0] * pos.shape[1], 1)),
        texcoords=(np.stack([ss, tt], -1).reshape(-1, 2) if uv else
                   np.zeros((idx.size, 2), np.float32)),
        triangles=tris.astype(np.int32), material=material)


def _box(center, size, material, yaw=0.0, bottom=True, uv=False):
    """The faces of a box (5 without its bottom) rotated by ``yaw``
    radians about the vertical axis, normals outward."""
    c = np.asarray(center, np.float32)
    cy, sy = np.cos(yaw), np.sin(yaw)
    ax = np.asarray([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]], np.float32)
    half = [0.5 * np.float32(s) * ax[i] for i, s in enumerate(size)]
    faces = []
    for i in range(3):
        if i == 1 and not bottom:
            signs = (1.0,)
        else:
            signs = (-1.0, 1.0)
        j, k = [a for a in range(3) if a != i]
        for sgn in signs:
            fc = c + sgn * half[i]
            faces.append(_quads(fc - half[j] - half[k], 2 * half[j],
                                2 * half[k], material, fc + sgn * half[i],
                                uv=uv))
    return faces


def _cornell_submeshes():
    """Cornell-style room (32 triangles): floor, ceiling and back wall in
    white, red left and green right walls, a ceiling light panel and two
    rotated 5-faced boxes, one of them glossy."""
    red = Material(name="red", kd=(0.63, 0.065, 0.05))
    green = Material(name="green", kd=(0.14, 0.45, 0.091))
    panel = Material(name="panel", kd=(0.78, 0.78, 0.78))
    glossy = Material(name="glossy", kd=(0.5, 0.5, 0.5), ks=(0.4, 0.4, 0.4),
                      shininess=8.0)
    inside = (0.0, 1.0, 0.0)
    lo, hi, top = -1.0, 1.0, 2.0
    subs = [
        _quads((lo, 0, lo), (2, 0, 0), (0, 0, 2), _WHITE, inside),  # floor
        _quads((lo, top, lo), (2, 0, 0), (0, 0, 2), _WHITE, inside),
        _quads((lo, 0, hi), (2, 0, 0), (0, top, 0), _WHITE, inside),  # back
        _quads((hi, 0, lo), (0, 0, 2), (0, top, 0), red, inside),
        _quads((lo, 0, lo), (0, 0, 2), (0, top, 0), green, inside),
        _quads((-0.3, top - 0.01, -0.25), (0.6, 0, 0), (0, 0, 0.5), panel,
               inside),
    ]
    subs += _box((-0.35, 0.3, -0.3), (0.6, 0.6, 0.6), _WHITE, yaw=-0.29,
                 bottom=False)
    subs += _box((0.35, 0.6, 0.35), (0.6, 1.2, 0.6), glossy, yaw=0.31,
                 bottom=False)
    normalize_submeshes(subs)  # as load_obj(center_and_normalize=True)
    return subs


def _checker(size=64, checks=8):
    cell = (np.arange(size) * checks // size)
    odd = (cell[:, None] + cell[None, :]) % 2 == 1
    return np.where(odd[..., None], np.float32([0.9, 0.85, 0.2]),
                    np.float32([0.15, 0.3, 0.8])).astype(np.float32)


def _nightclub_submeshes(rng):
    """A club room (166 triangles) around the 512-light grid of
    nightclub_lights: a wall behind each light grid, a tessellated floor
    and ceiling, a low stage and seven pillars that cast shadows. Every
    material shares the integer shininess 250."""
    def mat(name, kd, ks=0.3):
        return Material(name=name, kd=kd, ks=(ks, ks, ks), shininess=250.0)

    x0, x1, z0, z1, top = -9.0, 9.5, -9.5, 9.0, 7.0
    inside = (0.0, 3.0, 0.0)
    subs = [
        _quads((x0, 0, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0),
               mat("floor", (0.35, 0.3, 0.28)), inside, 4, 4),
        _quads((x0, top, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0),
               mat("ceiling", (0.2, 0.2, 0.25), 0.05), inside, 2, 2),
        _quads((x0, 0, z0), (0, 0, z1 - z0), (0, top, 0),
               mat("wall_right", (0.55, 0.5, 0.6)), inside, 4, 2),
        _quads((x0, 0, z1), (x1 - x0, 0, 0), (0, top, 0),
               mat("wall_back", (0.6, 0.55, 0.5)), inside, 4, 2),
    ]
    subs += _box((5.5, 0.3, 5.5), (5.0, 0.6, 4.0),
                 mat("stage", (0.4, 0.15, 0.1)), bottom=False)
    colors = rng.uniform(0.2, 0.9, (7, 3))
    for i in range(7):
        pos = (rng.uniform(-6.5, 6.5), 2.5, rng.uniform(-6.5, 6.5))
        subs += _box(pos, (0.8, 5.0, 0.8),
                     mat(f"pillar{i}", tuple(float(c) for c in colors[i])),
                     yaw=float(rng.uniform(0.0, np.pi / 2)))
    return subs


def _blob_submesh(rng, n_lon=32, n_lat=16) -> SubMesh:
    """A closed, smooth-shaded bumpy sphere of 2 * n_lon * (n_lat - 1)
    triangles (960 by default) and radius about 0.8; its bumps are a few
    seeded low-frequency waves."""
    theta = np.pi * np.arange(1, n_lat) / n_lat  # ring polar angles
    phi = 2.0 * np.pi * np.arange(n_lon) / n_lon
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    dirs = np.concatenate([[[0.0, 1.0, 0.0]], dirs, [[0.0, -1.0, 0.0]]])
    freq = rng.normal(size=(4, 3)) * 2.0
    phase = rng.uniform(0.0, 2.0 * np.pi, 4)
    bump = np.sin(dirs @ freq.T + phase).sum(-1)
    pos = (0.8 * (1.0 + 0.08 * bump))[:, None] * dirs
    ring = lambda r, j: 1 + r * n_lon + (j % n_lon)  # noqa: E731
    south = len(dirs) - 1
    tris = []
    for j in range(n_lon):
        tris.append((0, ring(0, j + 1), ring(0, j)))
        tris.append((south, ring(n_lat - 2, j), ring(n_lat - 2, j + 1)))
        for r in range(n_lat - 2):
            a, b = ring(r, j), ring(r, j + 1)
            c, d = ring(r + 1, j + 1), ring(r + 1, j)
            tris += [(a, b, c), (a, c, d)]
    tris = np.asarray(tris, np.int32)
    # Smooth normals: area-weighted face normals summed at each vertex,
    # turned outward.
    p0, p1, p2 = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    fn *= np.sign((fn * (p0 + p1 + p2)).sum(-1, keepdims=True))
    vn = np.zeros_like(pos)
    for i in range(3):
        np.add.at(vn, tris[:, i], fn)
    vn /= np.linalg.norm(vn, axis=-1, keepdims=True)
    return SubMesh(positions=pos.astype(np.float32),
                   normals=vn.astype(np.float32),
                   texcoords=np.zeros((len(pos), 2), np.float32),
                   triangles=tris,
                   material=Material(name="blob", kd=(0.8, 0.55, 0.35),
                                     ks=(0.2, 0.2, 0.2), shininess=20.0))


def nightclub_lights(builder: LightListBuilder) -> LightListBuilder:
    """The Cornell Nightclub's 512 wall lights. Reference:
    constructNightClubLights (src/scene/scene.cpp:30-66)."""
    counts = (16, 16)
    free = 0.30
    # Right wall, color 0.65
    regular_light_grid(builder, (-8.7, 6.4, -9.1), counts,
                       (0.0, 0.0, 17.0), (0.0, -6.0, 0.0),
                       (0.65, 0.65, 0.65), free)
    # Back wall, color 0.4
    regular_light_grid(builder, (9.2, 6.4, 8.6), counts,
                       (-17.0, 0.0, 0.0), (0.0, -6.0, 0.0),
                       (0.4, 0.4, 0.4), free)
    return builder


PREBUILT_SCENES = ("single_triangle", "cube", "cube_textured", "cornell_box",
                   "cornell_box_parallelogram_light", "cornell_nightclub",
                   "blob")


def load_prebuilt(name: str, seed: int = 0) -> Scene:
    """One of PREBUILT_SCENES, generated in memory; ``seed`` drives the
    scenes with random parts (the nightclub's pillars, the blob's bumps).
    Reference: loadScenePrebuilt (src/scene/scene.cpp:68-132), including
    the hardcoded per-scene lights."""
    rng = np.random.default_rng(seed)
    lights = LightListBuilder()
    if name == "single_triangle":
        submeshes = [SubMesh(
            positions=np.float32([[-0.8, -0.6, 0], [0.8, -0.6, 0],
                                  [0, 0.8, 0]]),
            normals=np.tile(np.float32([0, 0, -1]), (3, 1)),
            texcoords=np.zeros((3, 2), np.float32),
            triangles=np.int32([[0, 1, 2]]), material=Material())]
        lights.add_point((-1, 1, -1), (1, 1, 1))
    elif name in ("cube", "cube_textured"):
        textured = name == "cube_textured"
        mat = (Material(name="checker", kd_texture=_checker()) if textured
               else _WHITE)
        submeshes = _box((0, 0, 0), (0.8, 0.8, 0.8), mat, uv=textured)
        if textured:
            lights.add_point((-1.0, 1.5, -1.0), (1, 1, 1))
        else:
            lights.add_segment((1.5, 0.5, -0.6), (-1, 0.5, -0.5),
                               (0.9, 0.2, 0.1), (0.2, 1, 0.3))
    elif name in ("cornell_box", "cornell_box_parallelogram_light"):
        submeshes = _cornell_submeshes()
        if name == "cornell_box":
            lights.add_point((0, 0.58, 0), (1, 1, 1))
        else:
            lights.add_parallelogram(
                (-0.2, 0.5, 0), (0.4, 0, 0), (0.0, 0.0, 0.4),
                (1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (0.5, 0.5, 0.5),
                (1.0, 1.0, 1.0))
    elif name == "cornell_nightclub":
        submeshes = _nightclub_submeshes(rng)
        nightclub_lights(lights)
    elif name == "blob":
        submeshes = [_blob_submesh(rng)]
        lights.add_point((-1, 1, -1), (1, 1, 1))
        lights.add_point((1, -1, -1), (1, 1, 1))
    else:
        raise ValueError(
            f"unknown prebuilt scene {name!r}; one of {PREBUILT_SCENES}")
    return Scene(geometry=build_geometry(submeshes), lights=lights.build(),
                 num_lights=len(lights), name=name)


def load_blob_field(n: int = 5, seed: int = 0) -> Scene:
    """n x n grid of blobs (n*n*960 + 2 triangles; 24,002 at n=5) on a
    ground quad under a parallelogram sky light and 2 point lights: the
    large-scene workload for the BVH traversal (ops/traverse.py). Not a
    reference scene."""
    blob = _blob_submesh(np.random.default_rng(seed))
    submeshes = []
    half = (n - 1) / 2.0
    for gi in range(n):
        for gj in range(n):
            off = np.float32([(gi - half) * 2.2, 0.0, (gj - half) * 2.2])
            submeshes.append(dataclasses.replace(
                blob, positions=blob.positions + off))
    ext = 1.4 * n
    submeshes.append(_quads((-ext, -0.8, -ext), (2 * ext, 0, 0),
                            (0, 0, 2 * ext), _WHITE, (0, 1, 0)))

    lights = LightListBuilder()
    lights.add_parallelogram(
        (-0.3 * n, 1.5 * n, -0.3 * n), (0.6 * n, 0, 0), (0, 0, 0.6 * n),
        (40.0, 40.0, 40.0), (40.0, 40.0, 40.0), (40.0, 40.0, 40.0),
        (40.0, 40.0, 40.0))
    lights.add_point((-ext, 2.0, -ext), (30, 30, 30))
    lights.add_point((ext, 2.0, ext), (30, 30, 30))
    return Scene(geometry=build_geometry(submeshes), lights=lights.build(),
                 num_lights=len(lights), name=f"blob_field_{n}x{n}")


def _resolve_obj_path(path: str, data_dir: str | None = None) -> str:
    """``path`` itself when it exists, else ``path`` under ``data_dir`` or
    the ROMIS_DATA_DIR environment variable."""
    if os.path.exists(path):
        return path
    tried = [path]
    for base in (data_dir, os.environ.get("ROMIS_DATA_DIR")):
        if base:
            cand = os.path.join(base, path)
            if os.path.exists(cand):
                return cand
            tried.append(cand)
    raise FileNotFoundError(f"OBJ file not found; tried {tried}")


def load_scene_from_file(path: str, lights: LightListBuilder,
                         center_and_normalize: bool = False,
                         data_dir: str | None = None) -> Scene:
    """A user's OBJ file (see _resolve_obj_path). Reference:
    loadSceneFromFile (src/scene/scene.cpp:134-140)."""
    path = _resolve_obj_path(path, data_dir)
    submeshes = load_obj(path, center_and_normalize=center_and_normalize)
    return Scene(geometry=build_geometry(submeshes), lights=lights.build(),
                 num_lights=len(lights),
                 name=os.path.splitext(os.path.basename(path))[0])
