"""Where the time of one insert goes, on one device.

    python3 -m chad_tsdf_tpu_torch.profile_insert            # on the H100
    python3 -m chad_tsdf_tpu_torch.profile_insert --device cpu --points 8192
    python3 -m chad_tsdf_tpu_torch.profile_insert --workload kitti
    python3 -m chad_tsdf_tpu_torch.profile_insert --workload kitti \
        --sparse-impl sample_tile

Three measurements of the 2^20-point r = 5 m sphere insert (bench.py's
cloud, seed 420) at the default ``MapConfig``:

1. ``torch.profiler`` over ``--reps`` inserts after two warm-up inserts: the
   operators by device time, and the device's busy share (the summed time
   of its kernels and copies over the span from the first to the last);
2. per-stage times of one insert, median of 5, with CUDA events (host clock
   on the CPU): keys + sort, normals (K2), K1, directory + plan + K3, and
   the deferred fallback's flag (``integrate.FallbackTail``: the pinned
   copy of ``tile_ovf`` and its event; no host read);
3. K2 against its plain version on a dense-voxel cloud: ``--points``
   points in clusters of ``--segment`` points that each lie in one voxel,
   so one segment spans many of K2's 1024-point tiles at every depth.

``--workload kitti`` takes 1 and 2 on one KITTI-shaped scan
(``io/kitti.py`` ``synthetic_lidar_scan``, seed 0) at the streaming
configuration of ``scripts/kitti_stream.py``, dispatched to the sparse
backend as on the card (``--sparse-impl``, ``seg`` unless said; ``--device
cpu`` forces it).  On the card ``TSDFMap.insert`` replays its CUDA graph,
so 1 profiles the replays; the stages of 2 are those of the graph's step
run eagerly (a graph replays no Python, so nothing marks them there):
everything ``TSDFMap.insert`` does before the step (the density estimate,
the upload into the graph's buffers), keys + sort (after the padding and
packing on the device), normals (K2), DDA + payload (under ``seg`` the
``seg_samples`` kernel), then under ``seg`` the 2-key sort, the segmented
sum, compaction, directory and scatter, under ``sample_tile`` the sample
sort, K4 and the K3 merge (its fallback, which the eager step runs
unconditionally, follows the last stage and counts in no stage), marked
through ``core.integrate.STAGE_HOOK``.  Beside them, on the host clock:
the host's steps of the graph insert one by one (padding, the density
estimate, packing) and the whole graph insert, to its return and to the
end of its device work.

The last line is a JSON object with the numbers of 1-3.  The module also
holds the test clouds and K5's input tables that ``chip_smoke.py`` and the
scripts share.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import numpy as np
import torch

from .config import MapConfig
from .core import integrate
from .core.map import TSDFMap
from .core.state import create_state, origin_blocks_for_position
from .ops import accumulate, fused_integrate, normals, normals_cuda
from .utils.timing import StageTimer

INT32_MAX = 2**31 - 1


def sphere(n: int, r: float, seed: int) -> np.ndarray:
    """bench.py's cloud: uniform cube directions, normalized, radius r."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def voxel_clusters(n: int, segment: int, res: float, seed: int) -> np.ndarray:
    """``n // segment`` clusters of ``segment`` points, each a planar patch
    (+-1.5 cm, 0.2 mm noise) centred in one voxel on the r = 5 m sphere."""
    rng = np.random.default_rng(seed)
    k = max(1, n // segment)
    d = rng.normal(size=(k, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = (np.floor(d * 5.0 / res) + 0.5) * res
    t1 = np.cross(d, [0.0, 0.0, 1.0])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(d, t1)
    uv = rng.uniform(-0.015, 0.015, (k, segment, 2))
    h = rng.normal(0.0, 2e-4, (k, segment, 1))
    p = (c[:, None] + uv[..., :1] * t1[:, None] + uv[..., 1:] * t2[:, None]
         + h * d[:, None])
    return p.reshape(-1, 3)[:n].astype(np.float32)


def k5_clouds(cfg: MapConfig) -> dict:
    """The three clouds K5 is measured on, by name: the 2^20-point sphere,
    64 voxels x 16,384 points and 2^20 points in one voxel."""
    n = 1 << 20
    return {"sphere": sphere(n, 5.0, 420),
            "dense_voxels": voxel_clusters(n, 16384, cfg.sdf_res, 5),
            "single_voxel": voxel_clusters(n, n, cfg.sdf_res, 5)}


def k5_inputs(pts_np, cfg: MapConfig, dev):
    """K5's inputs on the ``pallas`` backend for one insert of ``pts_np``
    (scanned from the origin) into a fresh map: (pools, member tables,
    payload, stats)."""
    cfg = dataclasses.replace(cfg, accumulate_impl="pallas")
    state = create_state(cfg, origin_blocks_for_position(np.zeros(3), cfg),
                         dev)
    pts = torch.from_numpy(pts_np).to(dev)
    pos = torch.zeros(3, dtype=torch.float32, device=dev)
    batch = integrate.sort_samples(integrate.compute_samples(
        pts, pts.shape[0], pos, state.origin_blocks, cfg))
    n_valid = (batch.bkey != 2**31 - 1).sum(dtype=torch.int32)
    _, tables, t_count, _ = integrate.plan_segments(state, batch.bkey,
                                                    n_valid, cfg)
    stats = {"samples": int(n_valid), "members": int(t_count),
             "kept_samples": int(tables[1].sum()),
             "max_segment": int(tables[1].max())}
    return (state.pool_sd, state.pool_w), tables, batch.payload, stats


def boundary_inputs(cfg: MapConfig, dev, chunk: int = accumulate.CHUNK,
                    seed: int = 4):
    """A synthetic table whose segment lengths sit on chunk boundaries
    (C-1, C, C+1, 2C, 2C+1, 3C+5, 1, ...), with dead members between them
    (the reserved slot with samples, a live slot with none), padded to the
    touched capacity; random payloads from ``seed``; zero pools."""
    rng = np.random.default_rng(seed)
    cb, t = cfg.block_capacity, cfg.touched_capacity
    c = chunk
    lens = np.asarray([c - 1, c, c + 1, 2 * c, 2 * c + 1, 3 * c + 5, 1, 0,
                       777, 5 * c, c, 1, 2], np.int64)
    slots = rng.permutation(cb - accumulate.GROUP)[:lens.shape[0]]
    slots[[3, 11]] = cb - 1                  # the reserved slot, with samples
    # (member 7: a live slot with no samples)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pad = t - lens.shape[0]
    tables = [np.concatenate([a, np.full(pad, v)]).astype(np.int32)
              for a, v in ((starts, 0), (lens, 0), (slots, cb - 1))]
    payload = rng.integers(-2**31, 2**31 - 1, int(lens.sum()),
                           dtype=np.int64).astype(np.int32)
    kept = int(lens[(slots != cb - 1)].sum())
    stats = {"samples": int(lens.sum()), "members": int((slots != cb - 1)
                                                         .sum()),
             "kept_samples": kept, "max_segment": int(lens.max())}
    pools = (torch.zeros((cb, 512), dtype=torch.float32, device=dev),
             torch.zeros((cb, 512), dtype=torch.float32, device=dev))
    return (pools, tuple(torch.from_numpy(a).to(dev) for a in tables),
            torch.from_numpy(payload).to(dev), stats)


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def profile_inserts(pts: np.ndarray, device: torch.device, reps: int,
                    config: MapConfig | None = None, position=None):
    from torch.profiler import ProfilerActivity, profile
    m = TSDFMap(0.05, 0.1, config=config, device=device)
    origin = np.zeros(3, np.float32) if position is None else position
    for _ in range(2):
        m.insert(pts, origin)
    sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(reps):
            m.insert(pts, origin)
        sync(device)
    ka = prof.key_averages()
    sort_by = "device_time_total" if device.type == "cuda" else \
        "cpu_time_total"
    print(ka.table(sort_by=sort_by, row_limit=20), flush=True)
    evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
    host_us = sum(e.self_cpu_time_total for e in ka)
    out = {"reps": reps, "host_op_ms_per_insert": host_us / 1e3 / reps}
    if evs:
        busy = sum(e.time_range.elapsed_us() for e in evs)
        t0 = min(e.time_range.start for e in evs)
        t1 = max(e.time_range.end for e in evs)
        out.update(device_busy_ms_per_insert=busy / 1e3 / reps,
                   device_window_ms_per_insert=(t1 - t0) / 1e3 / reps,
                   device_busy_share=busy / (t1 - t0))
    else:
        out.update(device_busy_ms_per_insert="not measured",
                   device_busy_share="not measured")
    return out


def stage_times(pts: np.ndarray, device: torch.device):
    """Median per-stage ms over 5 inserts (after 2 warm-ups), through the
    same calls as ``integrate.insert_step_fused`` on a tile-covered cloud."""
    cfg = MapConfig()
    p = torch.from_numpy(pts).to(device)
    n = p.shape[0]
    pos = torch.zeros(3, dtype=torch.float32, device=device)
    st = create_state(cfg, origin_blocks_for_position(np.zeros(3), cfg),
                      device)
    names = ["keys + sort", "normals K2", "K1", "directory + plan + K3",
             "fallback flag"]
    runs = []
    for i in range(7):
        t = StageTimer(device)
        bkey, okey, _ = integrate.point_keys_soa(
            p[:, 0], p[:, 1], p[:, 2], n, st.origin_blocks, cfg)
        sb, so, px, py, pz = integrate.sort_points_soa(
            p[:, 0], p[:, 1], p[:, 2], bkey, okey)
        t.mark(names[0])
        nx, ny, nz = integrate.estimate_normals_dispatch(
            px, py, pz, sb, so, pos, st.origin_blocks, cfg)
        t.mark(names[1])
        pk, psd, pw, cnt = fused_integrate.fused_tile_partials(
            px, py, pz, nx, ny, nz, sb, pos, st.origin_blocks * 8,
            nb=cfg.tile_nb, k=cfg.dda_steps, res=cfg.sdf_res,
            trunc=cfg.sdf_trunc, extent=cfg.blocks_per_axis * 8)
        t.mark(names[2])
        tot = cnt.sum(0, dtype=torch.int32)
        st, _ = integrate.update_pool_tiled(st, pk, psd, pw, tot[1], tot[0],
                                            tot[2], 0, cfg)
        t.mark(names[3])
        integrate.FallbackTail(tot[1], None, cfg)
        t.mark(names[4])
        if i >= 2:
            runs.append(dict(t.stages))
    return {k: statistics.median(r[k] for r in runs) for k in names}


def seg_stage_times(pts: np.ndarray, position: np.ndarray,
                    config: MapConfig, device: torch.device):
    """Median per-stage ms over 5 eager inserts of one scan through
    ``TSDFMap.insert`` (after 2 warm-ups), the stages marked where
    ``core/integrate.py`` calls its ``STAGE_HOOK``; "host prep + upload" is
    what ``insert`` does before the graph's eager step
    (``InsertGraph.run_step``)."""
    m = TSDFMap(config=config, device=device)
    m.graphs_enabled = False
    runs = []
    for i in range(7):
        t = StageTimer(device)
        integrate.STAGE_HOOK = t.mark
        try:
            m.insert(pts, position)
        finally:
            integrate.STAGE_HOOK = None
        if i >= 2:
            runs.append(t.stages)
    return {k: statistics.median(r[j][1] for r in runs)
            for j, (k, _) in enumerate(runs[0])}


def graph_host_times(pts: np.ndarray, position: np.ndarray,
                     config: MapConfig, device: torch.device, reps: int = 7):
    """Median ms on the host clock (over ``reps``, after 2 warm-up inserts)
    of what ``TSDFMap.insert`` does on the host before the replay, step by
    step (``pad``: copying the scan into its bucket; ``dispatch``: the
    density estimate; ``pack``: ``pack_points``), and of the whole insert
    to its return (``insert_return``) and to the end of its device work
    (``insert_synced``)."""
    import time
    m = TSDFMap(config=config, device=device)
    for _ in range(2):
        m.insert(pts, position)
    sync(device)
    bucket = next(b for b in config.buckets if b >= len(pts))
    rows = {k: [] for k in ("pad", "dispatch", "pack", "insert_return",
                            "insert_synced")}
    for _ in range(reps):
        t0 = time.perf_counter()
        chunk = np.concatenate(
            [pts, np.zeros((bucket - len(pts), 3), np.float32)])
        t1 = time.perf_counter()
        cfg = m._dispatch_config(pts)
        t2 = time.perf_counter()
        integrate.pack_points(chunk, position, cfg.sdf_res)
        t3 = time.perf_counter()
        m.insert(pts, position)
        t4 = time.perf_counter()
        sync(device)
        t5 = time.perf_counter()
        for k, v in zip(rows, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                               t5 - t3)):
            rows[k].append(v * 1e3)
    return {k: statistics.median(v) for k, v in rows.items()}


def sorted_cloud(pts: np.ndarray, cfg: MapConfig, device: torch.device,
                 n_valid: int | None = None):
    """(sb, so, px, py, pz): the cloud's points on ``device``, Morton-sorted
    as an insert from the origin sorts them; points from ``n_valid`` on are
    padding (key INT32_MAX)."""
    p = torch.from_numpy(pts).to(device)
    origin = torch.from_numpy(origin_blocks_for_position(np.zeros(3), cfg)
                              ).to(device)
    bkey, okey, _ = integrate.point_keys_soa(
        p[:, 0], p[:, 1], p[:, 2], p.shape[0] if n_valid is None else n_valid,
        origin, cfg)
    return integrate.sort_points_soa(p[:, 0], p[:, 1], p[:, 2], bkey, okey)


def k2_dense_voxels(n: int, segment: int, device: torch.device):
    """K2 and its plain version on clusters of ``segment`` points per voxel;
    min dot between the two, the largest depth-0 segment, and both times."""
    cfg = MapConfig()
    sb, so, px, py, pz = sorted_cloud(
        voxel_clusters(n, segment, cfg.sdf_res, 5), cfg, device)
    pos = torch.zeros(3, dtype=torch.float32, device=device)
    args = (px, py, pz, sb, so, pos, cfg.normal_min_points,
            cfg.normal_max_depth)

    def kernel():
        return normals_cuda.estimate_normals(*args)

    def plain():
        return normals.estimate_normals_soa(
            px, py, pz, sb, so, sb != INT32_MAX, pos, cfg.normal_min_points,
            cfg.normal_max_depth)

    dots = (torch.stack(kernel()) * torch.stack(plain())).sum(0)
    _, counts = torch.unique_consecutive(
        (sb.to(torch.int64) << 32) | so.to(torch.int64), return_counts=True)
    out = {"points": int(px.shape[0]), "largest_segment": int(counts.max()),
           "min_dot": float(dots.min())}
    for name, fn in (("ms", kernel), ("plain_ms", plain)):
        times = []
        for i in range(5):
            t = StageTimer(device)
            with t.stage(name):
                fn()
            if i >= 1:
                times.append(t.stages[0][1])
        out[name] = statistics.median(times)
    return out


def kitti_main(device: torch.device, reps: int,
               sparse_impl: str = "seg") -> int:
    from .io.kitti import synthetic_lidar_scan
    from .scripts.kitti_stream import stream_config
    pts = synthetic_lidar_scan([0.0, 0.0, 0.0], seed=0)
    pos = np.float32([0.0, 0.0, 1.7])
    cfg = stream_config(sparse_impl=sparse_impl)
    if device.type != "cuda":          # no density dispatch off the card
        cfg = dataclasses.replace(cfg, accumulate_impl=cfg.sparse_impl)
    res = {"points": int(pts.shape[0]), "sparse_impl": sparse_impl,
           "profile": profile_inserts(pts, device, reps, cfg, pos)}
    print("profile:", json.dumps(res["profile"]), flush=True)
    res["stages_ms"] = seg_stage_times(pts, pos, cfg, device)
    print("stages (eager):", json.dumps(res["stages_ms"]), flush=True)
    res["host_ms"] = graph_host_times(pts, pos, cfg, device)
    print("host:", json.dumps(res["host_ms"]), flush=True)
    print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=1 << 20)
    ap.add_argument("--segment", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--workload", choices=("sphere", "kitti"),
                    default="sphere")
    ap.add_argument("--sparse-impl", default="seg",
                    choices=("seg", "sample_tile", "pallas", "fused"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    if args.workload == "kitti":
        return kitti_main(device, args.reps, args.sparse_impl)
    pts = sphere(args.points, 5.0, 420)
    res = {"profile": profile_inserts(pts, device, args.reps)}
    print("profile:", json.dumps(res["profile"]), flush=True)
    res["stages_ms"] = stage_times(pts, device)
    print("stages:", json.dumps(res["stages_ms"]), flush=True)
    res["k2_dense_voxels"] = k2_dense_voxels(args.points, args.segment,
                                             device)
    print("k2 dense voxels:", json.dumps(res["k2_dense_voxels"]), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
