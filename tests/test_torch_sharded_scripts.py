"""Dry runs of the port's three single-card sharded scripts on the CPU
(``chad_tsdf_tpu_torch/scripts/sharded_overhead_bench.py``,
``micro_sharded_phases.py``, ``sharded_kitti_bench.py``): two scans, a
small bucket and pool.  Each writes its JSON with the JAX script's keys;
at one shard no halo row is sent or deferred; the halo rows per scan for
N = 2..32 equal the JAX package's own host split of the same scans."""

import json

import numpy as np
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import state as j_state
from chad_tsdf_tpu.parallel import sharded as j_sharded
from chad_tsdf_tpu_torch.scripts import (micro_sharded_phases,
                                         sharded_kitti_bench,
                                         sharded_overhead_bench as sob)

SMALL = ["--device", "cpu", "--scans", "2", "--bucket", "4096",
         "--block-capacity", "16384"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, args, tmp_path):
    path = tmp_path / "out.json"
    assert main(args + ["--json", str(path)]) == 0
    return json.loads(path.read_text())


def test_sharded_overhead_bench_dry_run(tmp_path):
    out = _run(sob.main, SMALL + ["--touched-capacity", "4096",
                                  "--rounds", "1"], tmp_path)
    assert {"backend", "n_points_per_scan", "direct_ms", "generic_ms",
            "fixed_overhead_ms", "halo"} <= set(out)
    assert out["device"] == "cpu" and out["route_sent_n1"] == 0
    assert out["direct_ms"] > 0 and out["generic_ms"] > 0
    assert set(out["halo"]) == {"2", "4", "8", "16", "32"}
    for row_sets in out["halo"].values():
        assert row_sets["adaptive"]["remote_rows_per_scan"] == 0.0
        assert row_sets["static"]["remote_rows_per_scan"] > 0


def test_micro_sharded_phases_dry_run(tmp_path):
    out = _run(micro_sharded_phases.main,
               SMALL + ["--touched-capacity", "4096", "--rounds", "1"],
               tmp_path)
    for k in ("direct_ms", "scratch_only_ms", "generic_ms"):
        assert out[k] > 0
    assert out["scratch_pipeline_ms"] == pytest.approx(
        out["scratch_only_ms"] - out["direct_ms"])
    assert out["extract_route_merge_ms"] == pytest.approx(
        out["generic_ms"] - out["scratch_only_ms"])


def test_sharded_kitti_bench_dry_run(tmp_path):
    out = _run(sharded_kitti_bench.main, SMALL, tmp_path)
    assert {"backend", "n_devices", "scans_per_sec", "points_per_sec",
            "route_overflow", "n_submaps"} <= set(out)
    assert out["n_devices"] == 1 and out["route_overflow"] == 0
    assert out["scans_per_sec"] > 0


def test_halo_rows_match_jax_split():
    """The halo counts of the JAX script, computed here with the JAX
    package's host split on the same scans: equal."""
    raw = sob.raw_scans(3, 1 << 17)
    cfg = sob.stream_config(sob.argparse.Namespace(
        block_capacity=1 << 17, touched_capacity=1 << 15, bucket=1 << 17))
    got = sob.halo_rows(raw, cfg)
    jcfg = JaxMapConfig(block_capacity=1 << 17, touched_capacity=1 << 15,
                        max_points=1 << 17, packed_ingest=True,
                        accumulate_impl="seg", point_buckets=())
    origin = j_state.origin_blocks_for_position(sob.POSITION, jcfg)
    for n_sh in (2, 8, 32):
        for scheme in ("static", "adaptive"):
            if scheme == "static":
                bounds = j_sharded.key_bounds(n_sh, jcfg)
                splits = [j_sharded.morton_split(p, n_sh, jcfg.sdf_res)
                          for p in raw]
            else:
                bounds = j_sharded.adaptive_bounds(raw[0], origin, n_sh,
                                                   jcfg)
                splits = [j_sharded.owner_split(p, bounds, origin, jcfg)
                          for p in raw]
            remote = touched = 0
            for split in splits:
                for me, c in enumerate(split):
                    if len(c):
                        uk = np.unique(j_sharded.point_block_keys(
                            c, origin, jcfg))
                        touched += len(uk)
                        remote += int((np.searchsorted(
                            bounds, uk, side="right") - 1 != me).sum())
            want = got[str(n_sh)][scheme]
            assert want["remote_rows_per_scan"] == remote / len(raw)
            assert want["touched_rows_per_scan"] == touched / len(raw)
