"""Map-scale ``save`` of the port — ``scripts/mesh_scale_bench.py`` on
``chad_tsdf_tpu_torch``.

    python3 -m chad_tsdf_tpu_torch.scripts.mesh_scale --host     # on a card
    python3 -m chad_tsdf_tpu_torch.scripts.mesh_scale --device cpu --scans 4

Forty synthetic ~120k-point LiDAR scans (``io/kitti.py``
``synthetic_lidar_scan``, seed = scan index) 1.5 m apart go into one
``TSDFMap`` at ``MapConfig(block_capacity=1 << 17, touched_capacity=1 << 15,
max_points=1 << 17, packed_ingest=True, submap_distance=6.0)``, so about ten
submaps accumulate; then ``save`` is timed in parts, as the JAX script
does: ``sub_fin_ms`` (drain of the pending rotations and the active
snapshot), ``voxel_samples_ms`` (DAG walk and fusion), ``mc_ms`` (marching
cubes, normals included), and a whole ``save_ms`` with ``last_metrics``'
split and the peak device memory of the save (and what the map held
before it, and ``n_blocks``, the 512-voxel blocks device marching cubes
lays out).  ``max_pending_stubs`` is the most rotated-out maps that
waited undrained: each pins a 512 MiB pool here, so the map's 1 GiB byte
bound lets two wait where the count would let four.  ``--host`` also meshes the same samples with the host marching
cubes, times a host ``save``, and requires both meshes to be equal.  The
last line is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..config import MapConfig
from ..core.map import TSDFMap
from ..io.kitti import synthetic_lidar_scan
from ..mesh import mc

N_SCANS = 40
SPACING_M = 1.5


def scale_config(**overrides) -> MapConfig:
    """The JAX script's configuration.  It meshes through device marching
    cubes by name: ``auto`` does so on a card, and on the CPU a dry run
    then runs the same torch ops there."""
    return dataclasses.replace(
        MapConfig(block_capacity=1 << 17, touched_capacity=1 << 15,
                  max_points=1 << 17, packed_ingest=True,
                  submap_distance=6.0, mesh_impl="device"), **overrides)


def mesh_difference(a, b) -> dict:
    """How far two meshes of the same samples are apart: the largest vertex
    distance (vertex sets in the same order) and whether the face sets
    (each face's sorted corners, as a set) and face counts are equal."""
    same_v = a.vertices.shape == b.vertices.shape
    faces = [np.unique(np.sort(m.faces, axis=1), axis=0) for m in (a, b)]
    return {
        "max_vertex_diff_m": (float(np.abs(a.vertices - b.vertices).max(
            initial=0.0)) if same_v else None),
        "same_face_set": (faces[0].shape == faces[1].shape and
                          bool((faces[0] == faces[1]).all())),
        "same_face_count": a.n_faces == b.n_faces}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n_scans: int = N_SCANS, device="cuda", host: bool = False) -> dict:
    m = TSDFMap(config=scale_config(), device=device)
    dev = m.device
    t0 = time.perf_counter()
    total, max_pending = 0, 0
    for i in range(n_scans):
        pts = synthetic_lidar_scan([SPACING_M * i, 0.0, 0.0], seed=i)
        m.insert(pts, np.float32([SPACING_M * i, 0.0, 1.7]))
        max_pending = max(max_pending, len(m._pending))
        total += len(pts)
    sync(dev)
    t_stream = time.perf_counter() - t0

    t0 = time.perf_counter()
    subs = m._all_submaps()                 # drain + active snapshot
    t_fin = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes, sd = m.voxel_samples(subs)
    t_vox = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = m.extract_mesh()
    t_mesh = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        base = None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        m.save(os.path.join(tmp, "mesh_scale.ply"))
        t_save = time.perf_counter() - t0
        split = {k: m.last_metrics[k] for k in (
            "sub_fin_ms", "voxel_samples_ms", "mc_ms", "normals_ms",
            "ply_ms")}
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        out = {
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "n_scans": n_scans, "n_points": total, "n_submaps": len(subs),
            "max_pending_stubs": max_pending,
            "n_voxels": int(len(codes)),
            "n_blocks": int(np.unique(codes >> np.uint64(9)).shape[0]),
            "n_vertices": int(mesh.n_vertices),
            "n_faces": int(mesh.n_faces),
            "stream_s": t_stream, "sub_fin_ms": t_fin * 1e3,
            "voxel_samples_ms": t_vox * 1e3, "mesh_total_ms": t_mesh * 1e3,
            "mc_ms": (t_mesh - t_vox) * 1e3, "save_ms": t_save * 1e3,
            "save_split_ms": split, "save_peak_device_bytes": peak,
            "device_bytes_before_save": base}
        if host:
            t0 = time.perf_counter()
            host_mesh = mc.marching_cubes(codes, sd, m.sdf_res)
            out["host_mc_ms"] = (time.perf_counter() - t0) * 1e3
            diff = mesh_difference(mesh, host_mesh)
            if not (diff["same_face_set"] and diff["same_face_count"] and
                    diff["max_vertex_diff_m"] is not None and
                    diff["max_vertex_diff_m"] <= 1e-6):
                raise SystemExit(f"device and host meshes differ: {diff}")
            out["device_vs_host"] = diff
            m.config = dataclasses.replace(m.config, mesh_impl="host")
            t0 = time.perf_counter()
            m.save(os.path.join(tmp, "mesh_scale_host.ply"))
            out["host_save_ms"] = (time.perf_counter() - t0) * 1e3
            out["host_save_split_ms"] = {k: m.last_metrics[k]
                                         for k in split}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=N_SCANS)
    ap.add_argument("--host", action="store_true",
                    help="also mesh on the host and compare")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    out = run(args.scans, args.device, args.host)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
