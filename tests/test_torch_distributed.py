"""The port's sharded map across processes (``chad_tsdf_tpu_torch/parallel/
distributed.py``): 2 CPU processes joined by gloo, 2 shards each, run the
same scans through one 4-shard mesh, as tests/test_distributed.py does for
the JAX package.  Both processes must build the identical map, and it must
equal a single-process 4-shard run bit for bit: an ``xla`` stream with a
rotation, ``save`` and a checkpoint; a ``fused`` map whose scratch
fallbacks and carve are settled through the group; and the pose graph's
normal equations summed over the group.  A ``fused`` map dropped by one
process with its last insert unsettled must issue no collective from
``__del__``: the peer would never join it.

The worker is this file run as a script (``python
tests/test_torch_distributed.py <rank> <port>``)."""

import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sphere(n, r, seed, centre):
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.float32(centre) + d * r).astype(np.float32)


def _digest(*arrays) -> str:
    return hashlib.sha256(b"".join(a.tobytes() for a in arrays)).hexdigest()


def run_maps(mesh, tmp: str) -> dict:
    """The lifecycle both the workers and the single process run."""
    from chad_tsdf_tpu_torch import MapConfig
    from chad_tsdf_tpu_torch.io import save_checkpoint
    from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap
    from chad_tsdf_tpu_torch.slam import posegraph as pg

    cfg = MapConfig(max_points=512, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    m = ShardedTSDFMap(config=cfg, mesh=mesh)
    m.insert(_sphere(2048, 1.5, 100, (0, 0, 0)), np.zeros(3, np.float32))
    m.insert(_sphere(2048, 1.5, 101, (8, 0, 0)), np.float32([8, 0, 1.7]))
    assert len(m._pending) == 1, "rotation must be deferred"
    m.save(os.path.join(tmp, "mesh.ply"))
    codes, sd = m.voxel_samples()
    path = os.path.join(tmp, "ckpt.npz")
    save_checkpoint(path, m)
    z = np.load(path, allow_pickle=False)
    out = {"digest": _digest(codes, sd),
           "ck_digest": _digest(z["active_dir_keys"], z["active_pool_sd"],
                                z["active_pool_w"]),
           "n_submaps": m.stats()["n_submaps"],
           "route_sent": m.last_metrics["route_sent"],
           "route_overflow": m.last_metrics["route_overflow"]}

    fused = MapConfig(max_points=1024, block_capacity=4096,
                      touched_capacity=2048, accumulate_impl="fused",
                      tile_nb=8, carve_steps=16, carve_stride=2.0)
    f = ShardedTSDFMap(config=fused, mesh=mesh)
    met = f.insert(_sphere(4096, 4.0, 102, (0, 0, 0)),
                   np.zeros(3, np.float32))
    assert f._deferred is not None
    out["fused"] = {k: met[k] for k in ("n_new_blocks", "n_blocks",
                                        "n_carve_samples",
                                        "n_carve_dropped")}
    out["fused_digest"] = _digest(*f.voxel_samples())

    poses = np.stack([np.eye(4, dtype=np.float32)] * 5)
    poses[:, 0, 3] = np.arange(5, dtype=np.float32)
    graph = pg.make_odometry_edges(poses, noise=0.02, seed=1)
    graph = pg.add_edge(graph, 4, 0, np.linalg.inv(poses[4]) @ poses[0],
                        weight=10.0)
    opt, _ = pg.optimize_poses(graph, poses, iterations=6, mesh=mesh,
                               device="cpu")
    out["poses"] = opt.tolist()
    return out


def collectives_of_gc(mesh, rank: int) -> list:
    """Rank 0 drops a ``fused`` map whose last insert is unsettled while
    rank 1 keeps its copy, then both all-reduce a marker, then rank 1
    drops its copy.  Returns the collectives the two ``__del__`` calls
    issued (none is allowed: a collective from garbage collection pairs up
    with whatever the peer calls next, or waits forever)."""
    import gc

    import torch.distributed as dist

    from chad_tsdf_tpu_torch import MapConfig
    from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap

    cfg = MapConfig(max_points=1024, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="fused",
                    tile_nb=8, carve_steps=16, carve_stride=2.0)
    f = ShardedTSDFMap(config=cfg, mesh=mesh)
    f.insert(_sphere(4096, 4.0, 102, (0, 0, 0)), np.zeros(3, np.float32))
    assert f._deferred is not None
    names = ("all_reduce", "all_gather", "all_to_all_single", "broadcast",
             "barrier")
    saved = {n: getattr(dist, n) for n in names}
    calls = []

    def drop(who):
        nonlocal f
        if rank != who:
            return
        for n in names:
            setattr(dist, n, lambda *a, _n=n, **k: calls.append(_n) or
                    saved[_n](*a, **k))
        try:
            f = None
            gc.collect()
        finally:
            for n in names:
                setattr(dist, n, saved[n])

    drop(0)
    marker = torch.tensor([rank + 1.0])
    dist.all_reduce(marker)
    assert float(marker) == 3.0, float(marker)
    drop(1)
    return calls


def worker(rank: int, port: int) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from chad_tsdf_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(f"localhost:{port}", 2, rank, device="cpu",
                           timeout_s=240)
    info = distributed.process_info()
    assert info["process_count"] == 2 and info["process_index"] == rank
    mesh = make_mesh(4, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.first == 2 * rank and mesh.group is not None
    with tempfile.TemporaryDirectory() as tmp:
        out = run_maps(mesh, tmp)
    out["gc_collectives"] = collectives_of_gc(mesh, rank)
    print("DIST_OK " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_map_matches_one_process():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DIST_OK" in out, \
            f"process {rank}:\n{out[-4000:]}"
    recs = [json.loads(out.split("DIST_OK ", 1)[1].splitlines()[0])
            for out in outs]
    for rec in recs:
        assert rec.pop("gc_collectives") == []
    assert recs[0] == recs[1]
    assert recs[0]["n_submaps"] == 1 and recs[0]["route_overflow"] == 0
    assert recs[0]["route_sent"] > 0

    from chad_tsdf_tpu_torch.parallel import make_mesh
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            want = run_maps(make_mesh(4, device="cpu"), tmp)
    finally:
        torch.set_num_threads(n)
    assert recs[0] == want


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]))
