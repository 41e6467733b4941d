"""Mesh-based surface-reconstruction accuracy (the ICL-NUIM protocol; port
of ``hrbffusion3d_tpu/eval/mesh.py``).

The reference's reconstruction numbers are measured against the ICL-NUIM
ground-truth MESH (SURVEY §6; the living-room .ply distributed with the
dataset).  ``load_ply_mesh`` / ``save_ply_mesh`` and ``scene_to_mesh`` (the
analytic synthetic scenes tessellated, so the same mesh code path runs
without dataset files) are the JAX package's numpy.  The exact
point-to-triangle distance is an N x F brute force, chunked over the
points, in torch float64 on the points' device (the map's: the card's FP64
units on the H100), with the JAX package's formulas and float64 semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.tensors import host


class TriMesh(NamedTuple):
    vertices: np.ndarray   # (V,3) float32
    faces: np.ndarray      # (F,3) int32


# --------------------------------------------------------------------------- #
# PLY mesh IO (ascii / binary_little_endian, vertex xyz + face lists)
# --------------------------------------------------------------------------- #

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply_mesh(path: str) -> TriMesh:
    """Minimal PLY mesh reader (the ICL-NUIM GT mesh is ascii xyz+faces)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ("list", idx_t, elt_t, name)])
        while True:
            line = f.readline().strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elements.append((name, int(cnt), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif line == "end_header":
                break
        verts, faces = None, []
        for name, cnt, props in elements:
            if fmt == "ascii":
                if name == "vertex":
                    rows = [f.readline().split() for _ in range(cnt)]
                    arr = np.asarray(rows, np.float64)
                    cols = [p[0] for p in props]
                    verts = arr[:, [cols.index("x"), cols.index("y"),
                                    cols.index("z")]].astype(np.float32)
                elif name == "face":
                    for _ in range(cnt):
                        vals = [int(v) for v in f.readline().split()]
                        k, idx = vals[0], vals[1:]
                        for j in range(1, k - 1):  # fan-triangulate
                            faces.append((idx[0], idx[j], idx[j + 1]))
                else:
                    for _ in range(cnt):
                        f.readline()
            else:  # binary_little_endian
                if name == "vertex":
                    dt = np.dtype([(p[0], "<" + _PLY_TYPES[p[1]])
                                   for p in props])
                    arr = np.frombuffer(f.read(cnt * dt.itemsize), dt)
                    verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                     -1).astype(np.float32)
                elif name == "face":
                    assert props[0][0] == "list"
                    it = np.dtype("<" + _PLY_TYPES[props[0][1]])
                    et = np.dtype("<" + _PLY_TYPES[props[0][2]])
                    for _ in range(cnt):
                        k = int(np.frombuffer(f.read(it.itemsize), it)[0])
                        idx = np.frombuffer(f.read(k * et.itemsize), et)
                        for j in range(1, k - 1):
                            faces.append((int(idx[0]), int(idx[j]),
                                          int(idx[j + 1])))
                else:
                    raise ValueError(f"unsupported binary element {name}")
        return TriMesh(verts, np.asarray(faces, np.int32))


def save_ply_mesh(path: str, mesh: TriMesh) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {mesh.vertices.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {mesh.faces.shape[0]}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in mesh.vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in mesh.faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


# --------------------------------------------------------------------------- #
# analytic scene -> mesh (exercises the mesh path without dataset files)
# --------------------------------------------------------------------------- #

def scene_to_mesh(scene, sphere_res: int = 64, room_half: float = 8.0) -> TriMesh:
    """Tessellate an eval.synth.Scene (its tensors on any device): UV spheres, large quads for the
    (infinite) planes, two triangles per bounded quad.  Plane quads overshoot
    the room — harmless for distance queries, the walls intersect there."""
    vs: list[np.ndarray] = []
    fs: list[tuple[int, int, int]] = []

    def add_quad(c, e1, e2):
        base = sum(v.shape[0] for v in vs)
        vs.append(np.asarray(
            [c - e1 - e2, c + e1 - e2, c + e1 + e2, c - e1 + e2], np.float32))
        fs.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])

    planes = host(scene.planes)
    for n_, d_ in zip(planes[:, :3], planes[:, 3]):
        n_ = n_ / np.linalg.norm(n_)
        c = n_ * d_
        a = np.array([1.0, 0, 0]) if abs(n_[0]) < 0.9 else np.array([0, 1.0, 0])
        e1 = np.cross(n_, a)
        e1 = e1 / np.linalg.norm(e1) * room_half
        e2 = np.cross(n_, e1 / room_half) * room_half
        add_quad(c, e1, e2)

    if getattr(scene, "quads", None) is not None:
        for q in host(scene.quads):
            add_quad(q[0:3], q[3:6], q[6:9])

    spheres = host(scene.spheres)
    for cx, cy, cz, r in spheres:
        nu, nv = sphere_res, sphere_res // 2
        base = sum(v.shape[0] for v in vs)
        u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
        v = np.linspace(0, np.pi, nv + 1)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        pts = np.stack([cx + r * np.sin(vv) * np.cos(uu),
                        cy + r * np.sin(vv) * np.sin(uu),
                        cz + r * np.cos(vv)], -1).reshape(-1, 3)
        vs.append(pts.astype(np.float32))
        for i in range(nu):
            i2 = (i + 1) % nu
            for j in range(nv):
                a0 = base + i * (nv + 1) + j
                a1 = base + i2 * (nv + 1) + j
                fs.extend([(a0, a1, a0 + 1), (a1, a1 + 1, a0 + 1)])

    V = np.concatenate(vs, 0)
    F = np.asarray(fs, np.int32)
    # drop degenerate (zero-area) triangles — the UV-sphere poles produce
    # them, and a zero normal corrupts point-to-plane distances
    area2 = np.linalg.norm(
        np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]]), axis=-1)
    return TriMesh(V, F[area2 > 1e-12])


# --------------------------------------------------------------------------- #
# exact point-to-mesh distance (chunked brute force; eval-path only)
# --------------------------------------------------------------------------- #

def point_to_mesh_distance(points, mesh: TriMesh, chunk: int = 2048) -> torch.Tensor:
    """Unsigned distance of (N,3) points (a tensor, or numpy for the CPU)
    to the closest triangle: float64 (N,) on the points' device.  Exact:
    plane distance where the foot lies inside the triangle, else the min
    distance to the three edge segments."""
    device = points.device if isinstance(points, torch.Tensor) else "cpu"
    P_all = torch.as_tensor(points).to(device=device, dtype=torch.float64)
    V = torch.as_tensor(mesh.vertices).to(device=device, dtype=torch.float64)
    Fc = torch.as_tensor(np.asarray(mesh.faces, np.int64)).to(device)
    A, B, C = V[Fc[:, 0]], V[Fc[:, 1]], V[Fc[:, 2]]            # (F,3)
    AB, AC = B - A, C - A
    n = torch.linalg.cross(AB, AC, dim=-1)
    nn = torch.clamp(torch.linalg.vector_norm(n, dim=-1), min=1e-30)
    d00 = (AB * AB).sum(-1)
    d01 = (AB * AC).sum(-1)
    d11 = (AC * AC).sum(-1)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-30)
    # degenerate triangles (zero area) fall through to the edge path
    proper = nn > 1e-12

    def seg_dist2(P, S, E):
        """(n,1,3) points vs (F,3) segments -> (n,F) squared distances."""
        d = E - S
        dd = torch.clamp((d * d).sum(-1), min=1e-30)
        t = torch.clamp(((P - S) * d).sum(-1) / dd, 0.0, 1.0)
        r = P - (S + t[..., None] * d)
        return (r * r).sum(-1)

    out = torch.empty(P_all.shape[0], dtype=torch.float64, device=device)
    for lo in range(0, P_all.shape[0], chunk):
        P = P_all[lo:lo + chunk, None, :]                         # (n,1,3)
        AP = P - A
        # barycentric of the plane foot
        d20 = (AP * AB).sum(-1)
        d21 = (AP * AC).sum(-1)
        v = (d11 * d20 - d01 * d21) / denom
        w = (d00 * d21 - d01 * d20) / denom
        inside = (v >= 0) & (w >= 0) & (v + w <= 1) & proper
        plane_d2 = ((AP * n).sum(-1) / nn) ** 2
        edge_d2 = torch.minimum(torch.minimum(seg_dist2(P, A, B), seg_dist2(P, B, C)),
                                seg_dist2(P, C, A))
        d2 = torch.where(inside, plane_d2, edge_d2)
        out[lo:lo + chunk] = torch.sqrt(d2.min(-1).values)
    return out


def map_accuracy_mesh(m, mesh: TriMesh, conf_threshold: float = 0.0) -> dict:
    """Reconstruction accuracy of a surfel map vs a GT mesh (the ICL-NUIM
    metric): mean/median/rmse/p95 point-to-mesh distance in meters.  The
    distances are computed on the map's device, the statistics on the
    host."""
    cnt = int(m.count)
    pos = m.pos[:cnt]
    pos = pos[m.conf[:cnt] >= conf_threshold]
    if pos.shape[0] == 0:
        return dict(mean=np.inf, median=np.inf, rmse=np.inf, p95=np.inf, n=0)
    d = host(point_to_mesh_distance(pos, mesh))
    return dict(mean=float(d.mean()), median=float(np.median(d)),
                rmse=float(np.sqrt((d ** 2).mean())),
                p95=float(np.percentile(d, 95)), n=int(d.size))
