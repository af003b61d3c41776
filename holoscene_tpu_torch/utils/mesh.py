"""Host-side mesh container + I/O + topology utilities.

The port's own copy of holoscene_tpu/utils/mesh.py: the port
imports nothing of the JAX package.

Replaces the reference's trimesh/open3d/pymeshlab dependencies for the
operations the pipeline needs: PLY/OBJ read/write, connected components,
component filtering, bbox computation, vertex/face bookkeeping
(reference: utils/general.py mesh-utility layer, SURVEY.md §2 #19).
"""

from __future__ import annotations

import os
import struct

import numpy as np


class Mesh:
    """Minimal triangle mesh: verts [V,3] f64, faces [F,3] i64, optional
    per-vertex colors [V,3] u8 and UVs [V,2]."""

    def __init__(self, vertices, faces, vertex_colors=None, uvs=None):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        self.vertex_colors = (
            None if vertex_colors is None else np.asarray(vertex_colors)
        )
        self.uvs = None if uvs is None else np.asarray(uvs)

    # -- derived quantities ------------------------------------------------
    @property
    def bounds(self) -> np.ndarray:
        """[2,3] min/max."""
        if len(self.vertices) == 0:
            return np.zeros((2, 3))
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    @property
    def face_normals(self) -> np.ndarray:
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        n = np.cross(v1 - v0, v2 - v0)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(norm, 1e-12)

    @property
    def face_areas(self) -> np.ndarray:
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)

    @property
    def vertex_normals(self) -> np.ndarray:
        vn = np.zeros_like(self.vertices)
        fn = self.face_normals * self.face_areas[:, None]
        for k in range(3):
            np.add.at(vn, self.faces[:, k], fn)
        norm = np.linalg.norm(vn, axis=-1, keepdims=True)
        return vn / np.maximum(norm, 1e-12)

    def copy(self) -> "Mesh":
        return Mesh(
            self.vertices.copy(),
            self.faces.copy(),
            None if self.vertex_colors is None else self.vertex_colors.copy(),
            None if self.uvs is None else self.uvs.copy(),
        )

    # -- topology ----------------------------------------------------------
    def connected_components(self) -> np.ndarray:
        """Label per face [F]: the components of the faces' shared-vertex
        graph, numbered in the order of each component's smallest vertex
        index (the labels of the reference's min-label propagation, which
        took minutes on the multi-million-face meshes of a 512^3 grid;
        scipy's csgraph takes one linear pass)."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        n_v = len(self.vertices)
        edges = np.concatenate([self.faces[:, [0, 1]], self.faces[:, [1, 2]]])
        graph = coo_matrix((np.ones(len(edges), dtype=np.int8),
                            (edges[:, 0], edges[:, 1])), shape=(n_v, n_v))
        _, labels = connected_components(graph, directed=False)
        # scipy numbers components from vertex 0 upward, so renumbering
        # the faces' labels keeps the order of their smallest vertices
        _, face_labels = np.unique(labels[self.faces[:, 0]],
                                   return_inverse=True)
        return face_labels.reshape(-1)

    def decimate(self, max_faces: int) -> "Mesh":
        """Vertex-clustering decimation to <= max_faces (uniform-grid
        cluster + averaged positions + degenerate/duplicate-face drop).
        Coarse but O(V) — meant for Stage-2's view-selection / visibility /
        stability machinery where pixel-level silhouettes are all that
        matter (the reference leans on pymeshlab simplification for the
        same role); final geometry is never decimated."""
        if len(self.faces) <= max_faces:
            return self
        v, f = self.vertices, self.faces
        vc = self.vertex_colors
        lo = v.min(0)
        ext = np.maximum(v.max(0) - lo, 1e-9)
        g = max(int(np.sqrt(max_faces)), 8)
        best = None
        while g >= 4:
            cell = np.clip(
                np.floor((v - lo) / ext * g).astype(np.int64), 0, g - 1)
            key = (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
            uniq, inv = np.unique(key, return_inverse=True)
            nv = np.zeros((len(uniq), 3))
            cnt = np.zeros(len(uniq))
            np.add.at(nv, inv, v)
            np.add.at(cnt, inv, 1)
            nv /= cnt[:, None]
            nvc = None
            if vc is not None:
                # carry colors through the clustering (stage-4 seeds
                # gaussian colors from baked vertex colors)
                acc = np.zeros((len(uniq), 3))
                np.add.at(acc, inv, np.asarray(vc, np.float64)[:, :3])
                nvc = (acc / cnt[:, None]).astype(vc.dtype)
            nf = inv[f]
            keep = ((nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2])
                    & (nf[:, 0] != nf[:, 2]))
            nf = nf[keep]
            if len(nf):  # drop duplicate faces (orientation-insensitive)
                skey = np.sort(nf, axis=1)
                _, first = np.unique(
                    (skey[:, 0] * len(uniq) + skey[:, 1]) * len(uniq)
                    + skey[:, 2], return_index=True)
                nf = nf[np.sort(first)]
            best = Mesh(nv, nf, nvc)
            if len(nf) <= max_faces:
                return best
            g = min(int(g / 1.3), g - 1)
        return best

    def submesh(self, face_mask: np.ndarray) -> "Mesh":
        faces = self.faces[face_mask]
        used = np.unique(faces)
        remap = np.full(len(self.vertices), -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        return Mesh(
            self.vertices[used],
            remap[faces],
            None if self.vertex_colors is None else self.vertex_colors[used],
            None if self.uvs is None else self.uvs[used],
        )

    def largest_component(self) -> "Mesh":
        if len(self.faces) == 0:
            return self.copy()
        labels = self.connected_components()
        counts = np.bincount(labels)
        return self.submesh(labels == counts.argmax())

    def remove_small_components(self, min_faces: int) -> "Mesh":
        if len(self.faces) == 0:
            return self.copy()
        labels = self.connected_components()
        counts = np.bincount(labels)
        keep = np.isin(labels, np.flatnonzero(counts >= min_faces))
        return self.submesh(keep)

    def sample_surface(self, n: int, rng=None) -> np.ndarray:
        """Uniform area-weighted surface samples [n,3] (empty mesh -> [0,3])."""
        rng = rng or np.random.default_rng(0)
        if len(self.faces) == 0:
            return np.zeros((0, 3))
        areas = self.face_areas
        p = areas / max(areas.sum(), 1e-12)
        fi = rng.choice(len(self.faces), n, p=p)
        u = rng.random((n, 1))
        v = rng.random((n, 1))
        flip = (u + v) > 1
        u = np.where(flip, 1 - u, u)
        v = np.where(flip, 1 - v, v)
        v0 = self.vertices[self.faces[fi, 0]]
        v1 = self.vertices[self.faces[fi, 1]]
        v2 = self.vertices[self.faces[fi, 2]]
        return v0 + u * (v1 - v0) + v * (v2 - v0)

    def apply_translation(self, t) -> "Mesh":
        out = self.copy()
        out.vertices = out.vertices + np.asarray(t)[None, :]
        return out


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------


def write_ply(path: str, mesh: Mesh) -> None:
    """Binary little-endian PLY with optional uchar vertex colors."""
    v = mesh.vertices.astype("<f4")
    f = mesh.faces.astype("<i4")
    has_color = mesh.vertex_colors is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(v)}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {len(f)}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        if has_color:
            colors = np.asarray(mesh.vertex_colors)
            if colors.dtype != np.uint8:
                colors = np.clip(colors * 255, 0, 255).astype(np.uint8)
            rec = np.empty(len(v), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = v
            rec["rgb"] = colors
            fh.write(rec.tobytes())
        else:
            fh.write(v.tobytes())
        rec = np.empty(len(f), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = f
        fh.write(rec.tobytes())


def read_ply(path: str) -> Mesh:
    """Reads ascii and binary-LE PLY (positions + optional uchar colors)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode().splitlines()
    body = data[header_end:]

    fmt = "ascii"
    n_vert = n_face = 0
    vert_props: list[tuple[str, str]] = []
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    if fmt == "ascii":
        text = body.decode().split()
        stride = len(vert_props)
        vals = np.array(text[: n_vert * stride], dtype=np.float64).reshape(
            n_vert, stride
        )
        names = [p[0] for p in vert_props]
        verts = vals[:, [names.index(c) for c in "xyz"]]
        colors = None
        if "red" in names:
            colors = vals[
                :, [names.index(c) for c in ("red", "green", "blue")]
            ].astype(np.uint8)
        pos = n_vert * stride
        faces = []
        i = pos
        for _ in range(n_face):
            cnt = int(text[i])
            faces.append([int(x) for x in text[i + 1 : i + 1 + cnt]][:3])
            i += 1 + cnt
        return Mesh(verts, np.array(faces, dtype=np.int64), colors)

    dtype = np.dtype([(name, type_map[t]) for name, t in vert_props])
    vrec = np.frombuffer(body, dtype=dtype, count=n_vert)
    verts = np.stack([vrec["x"], vrec["y"], vrec["z"]], axis=-1)
    colors = None
    if "red" in dtype.names:
        colors = np.stack(
            [vrec["red"], vrec["green"], vrec["blue"]], axis=-1
        ).astype(np.uint8)
    offset = n_vert * dtype.itemsize
    faces = np.empty((n_face, 3), dtype=np.int64)
    pos = offset
    for i in range(n_face):
        cnt = body[pos]
        faces[i] = struct.unpack_from("<3i", body, pos + 1)
        pos += 1 + 4 * cnt
    return Mesh(verts, faces, colors)


def write_obj(path: str, mesh: Mesh, mtl_name: str | None = None,
              texture_png: str | None = None) -> None:
    """OBJ (+MTL with diffuse texture) writer, reference Stage-3 output
    format (surface_{i}.obj/.mtl/.png)."""
    def cols(a, n):
        a = np.asarray(a)
        return [a[:, k].tolist() for k in range(n)]

    # one str.format a line over whole columns (the same text as a loop
    # over rows, a few times faster on a baked mesh's millions of lines)
    lines = []
    if mtl_name:
        lines.append(f"mtllib {mtl_name}")
    lines.extend(map("v {:.6f} {:.6f} {:.6f}".format,
                     *cols(mesh.vertices, 3)))
    if mesh.uvs is not None:
        lines.extend(map("vt {:.6f} {:.6f}".format, *cols(mesh.uvs, 2)))
    if mtl_name:
        lines.append("usemtl material_0")
    face_cols = cols(np.asarray(mesh.faces) + 1, 3)
    if mesh.uvs is not None:
        lines.extend(map("f {0}/{0} {1}/{1} {2}/{2}".format, *face_cols))
    else:
        lines.extend(map("f {} {} {}".format, *face_cols))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if mtl_name:
        mtl_path = os.path.join(os.path.dirname(path), mtl_name)
        with open(mtl_path, "w") as fh:
            fh.write("newmtl material_0\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\n")
            if texture_png:
                fh.write(f"map_Kd {texture_png}\n")


def read_obj(path: str) -> Mesh:
    verts, uvs, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                faces.append(idx)
    return Mesh(
        np.array(verts),
        np.array(faces, dtype=np.int64),
        uvs=np.array(uvs) if uvs else None,
    )
