"""Minimal mesh container + PLY read/write (host-side numpy; port of
neural_graph_mapping_tpu.utils.meshio, kept as the port's own copy).

- binary + ascii PLY reading (vertices, vertex colors, triangle/quad faces;
  quads are triangulated on load);
- binary-little-endian PLY writing with optional float vertex colors;
- area-weighted surface sampling (mesh metrics);
- vertex normals + midpoint subdivision to a max edge length (culling);
- vertex-clustering simplification.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Tuple

import numpy as np


class Mesh:
    """Triangle mesh: vertices (V, 3) f32, faces (T, 3) i32, optional colors."""

    def __init__(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        vertex_colors: Optional[np.ndarray] = None,
    ) -> None:
        self.vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int32).reshape(-1, 3)
        self.vertex_colors = (
            None if vertex_colors is None else np.asarray(vertex_colors, np.float32)
        )

    # -- geometry ------------------------------------------------------------

    def face_areas(self) -> np.ndarray:
        v = self.vertices
        a, b, c = v[self.faces[:, 0]], v[self.faces[:, 1]], v[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)

    def face_normals(self) -> np.ndarray:
        v = self.vertices
        a, b, c = v[self.faces[:, 0]], v[self.faces[:, 1]], v[self.faces[:, 2]]
        n = np.cross(b - a, c - a)
        return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-20)

    def vertex_normals(self) -> np.ndarray:
        n = np.zeros_like(self.vertices)
        fn = self.face_normals() * self.face_areas()[:, None]
        for k in range(3):
            np.add.at(n, self.faces[:, k], fn)
        return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-20)

    def sample_surface(
        self, num_points: int, seed: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Area-weighted uniform surface samples. Returns (points, face_idx)."""
        rng = np.random.RandomState(seed)
        areas = self.face_areas()
        probs = areas / max(areas.sum(), 1e-20)
        face_idx = rng.choice(len(self.faces), size=num_points, p=probs)
        u = rng.rand(num_points, 2)
        flip = u.sum(axis=1) > 1.0
        u[flip] = 1.0 - u[flip]
        v = self.vertices
        f = self.faces[face_idx]
        pts = (
            v[f[:, 0]]
            + u[:, :1] * (v[f[:, 1]] - v[f[:, 0]])
            + u[:, 1:] * (v[f[:, 2]] - v[f[:, 0]])
        )
        return pts.astype(np.float32), face_idx

    def subdivide_to_size(self, max_edge: float, max_iterations: int = 10) -> "Mesh":
        """Midpoint-subdivide faces until no edge exceeds max_edge
        (trimesh.remesh.subdivide_to_size equivalent, mesh_culling.py:258)."""
        mesh = self
        for _ in range(max_iterations):
            v, f = mesh.vertices, mesh.faces
            e = v[f] - v[f[:, [1, 2, 0]]]
            longest = np.linalg.norm(e, axis=-1).max(axis=-1)
            split = longest > max_edge
            if not split.any():
                return mesh
            keep_f = f[~split]
            sub_f = f[split]
            # midpoint subdivision 1->4 for oversized faces
            a, b, c = sub_f[:, 0], sub_f[:, 1], sub_f[:, 2]
            mab = 0.5 * (v[a] + v[b])
            mbc = 0.5 * (v[b] + v[c])
            mca = 0.5 * (v[c] + v[a])
            base = len(v)
            nm = len(sub_f)
            iab = base + np.arange(nm)
            ibc = base + nm + np.arange(nm)
            ica = base + 2 * nm + np.arange(nm)
            new_v = np.concatenate([v, mab, mbc, mca])
            new_f = np.concatenate(
                [
                    keep_f,
                    np.stack([a, iab, ica], 1),
                    np.stack([iab, b, ibc], 1),
                    np.stack([ica, ibc, c], 1),
                    np.stack([iab, ibc, ica], 1),
                ]
            )
            colors = mesh.vertex_colors
            if colors is not None:
                colors = np.concatenate(
                    [
                        colors,
                        0.5 * (colors[a] + colors[b]),
                        0.5 * (colors[b] + colors[c]),
                        0.5 * (colors[c] + colors[a]),
                    ]
                )
            mesh = Mesh(new_v, new_f.astype(np.int32), colors)
        return mesh

    def simplify(self, voxel_size: float) -> "Mesh":
        """Vertex-clustering simplification (open3d simplify_vertex_clustering
        equivalent, slam_dataset.py:59-61)."""
        keys = np.floor(self.vertices / voxel_size).astype(np.int64)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        n = len(uniq)
        new_v = np.zeros((n, 3), np.float64)
        counts = np.zeros((n,), np.int64)
        np.add.at(new_v, inverse, self.vertices)
        np.add.at(counts, inverse, 1)
        new_v /= counts[:, None]
        new_f = inverse[self.faces]
        degenerate = (
            (new_f[:, 0] == new_f[:, 1])
            | (new_f[:, 1] == new_f[:, 2])
            | (new_f[:, 0] == new_f[:, 2])
        )
        colors = None
        if self.vertex_colors is not None:
            colors = np.zeros((n, self.vertex_colors.shape[1]), np.float64)
            np.add.at(colors, inverse, self.vertex_colors)
            colors /= counts[:, None]
        return Mesh(new_v.astype(np.float32), new_f[~degenerate], colors)

    def transform(self, t: np.ndarray) -> "Mesh":
        v = self.vertices @ t[:3, :3].T + t[:3, 3]
        return Mesh(v, self.faces, self.vertex_colors)


# ---------------------------------------------------------------------------
# PLY IO
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "float": "f4", "double": "f8", "float32": "f4", "float64": "f8",
}


def save_ply(path, mesh: Mesh, colors_as_uint8: bool = False) -> None:
    """Binary-little-endian PLY writer (replaces pytorch3d _save_ply)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    v = mesh.vertices.astype("<f4")
    f = mesh.faces.astype("<i4")
    has_color = mesh.vertex_colors is not None
    with open(path, "wb") as fp:
        header = ["ply", "format binary_little_endian 1.0"]
        header.append(f"element vertex {len(v)}")
        header += ["property float x", "property float y", "property float z"]
        if has_color:
            ctype = "uchar" if colors_as_uint8 else "float"
            header += [
                f"property {ctype} red",
                f"property {ctype} green",
                f"property {ctype} blue",
            ]
        header.append(f"element face {len(f)}")
        header.append("property list uchar int vertex_indices")
        header.append("end_header")
        fp.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            if colors_as_uint8:
                c = np.clip(mesh.vertex_colors, 0, 255).astype("<u1")
                rec = np.zeros(len(v), dtype=[("v", "<f4", 3), ("c", "<u1", 3)])
            else:
                c = mesh.vertex_colors.astype("<f4")
                rec = np.zeros(len(v), dtype=[("v", "<f4", 3), ("c", "<f4", 3)])
            rec["v"] = v
            rec["c"] = c
            fp.write(rec.tobytes())
        else:
            fp.write(v.tobytes())
        face_rec = np.zeros(len(f), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face_rec["n"] = 3
        face_rec["idx"] = f
        fp.write(face_rec.tobytes())


def load_ply(path) -> Mesh:
    """PLY reader: ascii + binary little/big endian, tri/quad faces."""
    with open(path, "rb") as fp:
        if fp.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', idx_t, cnt_t, name)])
        while True:
            line = fp.readline().strip().decode("ascii")
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif line == "end_header":
                break
        body = fp.read()

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    verts = None
    colors = None
    faces = []

    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                ncols = len(props)
                arr = np.array(
                    tokens[pos : pos + count * ncols], dtype=np.float64
                ).reshape(count, ncols)
                pos += count * ncols
                verts, colors = _extract_vertex_props(arr, props)
            elif name == "face":
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    idx = [int(tokens[pos + i]) for i in range(n)]
                    pos += n
                    _append_face(faces, idx)
            else:
                # skip unknown ascii elements conservatively
                for _ in range(count):
                    pos += len(props)
    else:
        offset = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[0], endian + _PLY_DTYPES[p[1]]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                verts = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float32)
                names = [p[0] for p in props]
                if {"red", "green", "blue"} <= set(names):
                    colors = np.stack(
                        [arr["red"], arr["green"], arr["blue"]], axis=-1
                    ).astype(np.float32)
                    if props[names.index("red")][1] in ("uchar", "uint8"):
                        colors /= 255.0
            elif name == "face":
                cnt_t = endian + _PLY_DTYPES[props[0][1]]
                idx_t = endian + _PLY_DTYPES[props[0][2]]
                cnt_size = np.dtype(cnt_t).itemsize
                idx_size = np.dtype(idx_t).itemsize
                # fast path: constant face arity (peek the first count)
                first_n = int(np.frombuffer(body, cnt_t, 1, offset)[0])
                stride = cnt_size + first_n * idx_size
                if offset + count * stride <= len(body):
                    block = np.frombuffer(body, np.uint8, count * stride, offset)
                    ns = block.reshape(count, stride)[:, :cnt_size].copy().view(cnt_t)[:, 0]
                    if (ns == first_n).all():
                        idx = (
                            block.reshape(count, stride)[:, cnt_size:]
                            .copy()
                            .view(idx_t)
                            .reshape(count, first_n)
                        )
                        offset += count * stride
                        for face in ([ (0,1,2) ] if first_n == 3 else [(0,1,2),(0,2,3)]):
                            faces.append(idx[:, face])
                        faces = [np.concatenate(faces)] if len(faces) > 1 else faces
                        continue
                # slow path: variable arity
                for _ in range(count):
                    n = int(np.frombuffer(body, cnt_t, 1, offset)[0])
                    offset += cnt_size
                    idx = np.frombuffer(body, idx_t, n, offset).astype(np.int64)
                    offset += n * idx_size
                    _append_face(faces, idx.tolist())

    face_arr = (
        np.concatenate([np.atleast_2d(f) for f in faces]).astype(np.int32)
        if faces
        else np.zeros((0, 3), np.int32)
    )
    return Mesh(verts, face_arr, colors)


def _extract_vertex_props(arr, props):
    names = [p[0] for p in props]
    verts = arr[:, [names.index("x"), names.index("y"), names.index("z")]].astype(
        np.float32
    )
    colors = None
    if {"red", "green", "blue"} <= set(names):
        colors = arr[
            :, [names.index("red"), names.index("green"), names.index("blue")]
        ].astype(np.float32)
        if props[names.index("red")][1] in ("uchar", "uint8"):
            colors /= 255.0
    return verts, colors


def _append_face(faces, idx):
    if len(idx) == 3:
        faces.append(np.asarray([idx], np.int64))
    elif len(idx) == 4:  # quad -> two triangles
        faces.append(np.asarray([[idx[0], idx[1], idx[2]], [idx[0], idx[2], idx[3]]]))
    elif len(idx) > 4:  # fan
        fan = [[idx[0], idx[i], idx[i + 1]] for i in range(1, len(idx) - 1)]
        faces.append(np.asarray(fan, np.int64))
