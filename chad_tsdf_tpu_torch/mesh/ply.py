"""PLY mesh I/O — a numpy copy of ``chad_tsdf_tpu/mesh/ply.py`` (importing
that module would import jax through its package).

The reference ends its pipeline in ``lvr2::ModelFactory::saveModel``
(reference: src/chad/detail/lvr2.cpp:317-320) which picks the format from the
filename extension; all in-repo callers write ``.ply``.  This is the
compatibility surface for mesh-RMSE comparison, so the writer emits standard
binary little-endian PLY with positions, normals and triangle faces; a
reader is included for round-trip tests and for comparing against meshes
produced by the C++ reference.
"""

from __future__ import annotations

import numpy as np

from .mc import TriangleMesh


def write_ply(path: str, mesh: TriangleMesh, binary: bool = True) -> None:
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    n = np.ascontiguousarray(mesh.vertex_normals, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.int32)
    fmt = "binary_little_endian" if binary else "ascii"
    header = "\n".join([
        "ply",
        f"format {fmt} 1.0",
        "comment chad_tsdf_tpu_torch",
        f"element vertex {v.shape[0]}",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        f"element face {f.shape[0]}",
        "property list uchar int vertex_indices",
        "end_header",
    ]) + "\n"
    with open(path, "wb") as fh:
        fh.write(header.encode())
        if binary:
            inter = np.empty((v.shape[0], 6), np.float32)
            inter[:, :3] = v
            inter[:, 3:] = n
            fh.write(inter.tobytes())
            rec = np.empty(f.shape[0],
                           dtype=[("n", "u1"), ("i", "<i4", (3,))])
            rec["n"] = 3
            rec["i"] = f
            fh.write(rec.tobytes())
        else:
            for i in range(v.shape[0]):
                fh.write((" ".join(f"{x:.6f}" for x in (*v[i], *n[i])) +
                          "\n").encode())
            for i in range(f.shape[0]):
                fh.write(f"3 {f[i,0]} {f[i,1]} {f[i,2]}\n".encode())


def read_ply(path: str) -> TriangleMesh:
    """Minimal reader for the formats this module writes (plus plain
    x/y/z-only vertex elements, e.g. meshes from the C++ reference)."""
    with open(path, "rb") as fh:
        data = fh.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    body = data[end:]
    binary = any("binary_little_endian" in ln for ln in header)
    counts = {}
    props: dict[str, list] = {}
    cur = None
    for ln in header:
        parts = ln.split()
        if not parts:
            continue
        if parts[0] == "element":
            cur = parts[1]
            counts[cur] = int(parts[2])
            props[cur] = []
        elif parts[0] == "property" and cur is not None:
            props[cur].append(parts[1:])
    nv, nf = counts.get("vertex", 0), counts.get("face", 0)
    vprops = props.get("vertex", [])
    vdim = len(vprops)
    if binary:
        vdata = np.frombuffer(body, "<f4", count=nv * vdim).reshape(nv, vdim)
        off = nv * vdim * 4
        rec = np.frombuffer(body[off:], dtype=[("n", "u1"), ("i", "<i4", (3,))],
                            count=nf)
        faces = rec["i"].astype(np.int32)
    else:
        lines = body.decode().splitlines()
        vdata = np.array([[float(x) for x in ln.split()[:vdim]]
                          for ln in lines[:nv]], np.float32)
        faces = np.array([[int(x) for x in ln.split()[1:4]]
                          for ln in lines[nv:nv + nf]], np.int32)
    names = [p[-1] for p in vprops]
    xyz = vdata[:, [names.index("x"), names.index("y"), names.index("z")]]
    if "nx" in names:
        nrm = vdata[:, [names.index("nx"), names.index("ny"),
                        names.index("nz")]]
    else:
        nrm = np.zeros_like(xyz)
    return TriangleMesh(np.ascontiguousarray(xyz, np.float32), faces,
                        np.ascontiguousarray(nrm, np.float32))
