"""The roofline byte counts, at a tiny size."""

import numpy as np
import pytest
import torch

from tsdf_bench import run
from tsdf_bench.metrics import (insert_roofline_pct, normals_roofline_pct,
                                roofline)
from tsdf_bench.reference import tsdf_ref as R


def test_byte_counts():
    assert roofline.normals_bytes(1000) == 24_000
    assert roofline.insert_bytes(1000, 300) == 12_000 + 4_800
    # 3.35 GB in one second is 0.1% of the peak
    assert roofline.share_pct(3.35e9, 1.0) == pytest.approx(0.1)
    assert roofline.share_pct(1.0, 0.0) is None


def test_touched_voxels_counted_from_the_cloud():
    # one point ~1 m ahead along x: its band of +-0.1 m, 0.9125 .. 1.1125 m,
    # crosses the voxels x = 18..22 at y = z = 0
    sem = R.Semantics()
    keys, _ = R.scan_samples(np.float32([[1.0125, 0.0125, 0.0125]]),
                             np.float32([0.0, 0.0125, 0.0125]),
                             np.zeros(3, np.float32), sem)
    vox = R.unpack_key(torch.unique(keys))
    assert vox[:, 0].tolist() == [18, 19, 20, 21, 22]
    assert (vox[:, 1:] == 0).all()


def test_readers_on_a_synthetic_trace():
    rec = run.Record()
    rec.valid_points = {0: 1000, 1: 3000}
    rec.touched = {0: 500, 1: 1500}
    rec.trace = {"steps": 2, "templates": [0, 1], "busy_s": 2e-6,
                 "kernel_s": {"void normals_tile_kernel<true>()": 4e-7,
                              "other": 1e-6}}
    # per step: 2000 points, 1000 voxels, 1 us busy, 0.2 us of K2
    least_insert = (12 * 2000 + 16 * 1000) / 3.35e12
    assert insert_roofline_pct.read(rec, "") == pytest.approx(
        100 * least_insert / 1e-6)
    assert normals_roofline_pct.read(rec, "") == pytest.approx(
        100 * 24 * 2000 / 3.35e12 / 2e-7)
    rec.trace["kernel_s"] = {"other": 1e-6}
    assert normals_roofline_pct.read(rec, "") is None
