"""The port's microbenchmarks (M1-M3, ``chad_tsdf_tpu_torch/scripts``)
through their plain versions, against the JAX package's scripts' own
Pallas kernels under ``pltpu.force_tpu_interpret_mode()``, with the
scripts' module sizes shrunk (M1/M3: N = 4096 points, M2: 2 tiles).

Keys, weights and M3's sums are compared exactly.  M1's and M2's sd sums
differ by the two kernels' rounding: the TPU kernels round each sd to bf16
(relative 2^-9) before an f32 sum, the port rounds it to the SD_QUANT grid
over [-SD_RANGE, SD_RANGE] (dscale / 2 per sample) before an integer sum.
So each cell is held to ``2^-8 * sum|sd| + count * dscale + 1e-6``, twice
the sum of both bounds."""

import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chad_tsdf_tpu_torch.ops import tile_accum
from chad_tsdf_tpu_torch.scripts import micro_mxu8 as t_m3
from chad_tsdf_tpu_torch.scripts import micro_stagea_phases as t_m1
from chad_tsdf_tpu_torch.scripts import micro_tile_accum as t_m2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SMALL = 4096


def _load_script(name):
    """Import scripts/<name>.py by path.  The scripts set JAX's compilation
    cache directory when imported; the previous value is restored."""
    before = jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_script_{name}", os.path.join(ROOT, "scripts",
                                                f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


@pytest.fixture(scope="module")
def j_m1():
    mod = _load_script("micro_stagea_phases")
    mod.N = N_SMALL
    return mod


@pytest.fixture(scope="module")
def j_m2():
    mod = _load_script("micro_tile_accum")
    mod.NTILES = 2
    return mod


@pytest.fixture(scope="module")
def j_m3():
    mod = _load_script("micro_mxu8")
    mod.N = N_SMALL
    return mod


def _bf16_bound(abs_sum, count, sd_range):
    _, dscale = tile_accum.sd_scales(sd_range)
    return 2.0 ** -8 * abs_sum + count * dscale + 1e-6


@pytest.mark.parametrize("mode", t_m1.MODES)
def test_m1_plain_matches_jax(j_m1, mode):
    bkey, okey, sd = t_m1.inputs(N_SMALL)
    nb = 48
    with pltpu.force_tpu_interpret_mode():
        ref = j_m1.build(nb, 1024, mode)(bkey, okey, sd)
    ref = [np.asarray(a) for a in ref]
    args = [torch.from_numpy(a) for a in (bkey, okey, sd)]
    keys, psd, pw = (a.numpy() for a in t_m1.build(nb, 1024, mode)(*args))
    np.testing.assert_array_equal(keys, ref[0])
    np.testing.assert_array_equal(pw, ref[2])
    if mode in ("list", "rank", "plist"):
        np.testing.assert_array_equal(psd, ref[1])
        assert mode == "list" or np.count_nonzero(psd) > 0
    else:
        abs_sum = t_m1.stagea_plain(args[0], args[1], args[2].abs(), nb,
                                    mode)[1].numpy()
        bound = _bf16_bound(abs_sum, pw, t_m1.SD_RANGE)
        assert (np.abs(psd - ref[1]) <= bound).all(), \
            np.abs(psd - ref[1]).max()
        assert pw.sum() > 0


def test_m1_presort_list_equals_min_extraction():
    bkey, okey, sd = (torch.from_numpy(a) for a in t_m1.inputs(N_SMALL, 4))
    for nb in (32, 48):
        a = t_m1.stagea(bkey, okey, sd, nb, "list")[0]
        b = t_m1.stagea(bkey, okey, sd, nb, "plist")[0]
        assert torch.equal(a, b)
    res = t_m1.check(bkey, okey, sd, 40)
    assert res["max_abs_err"] == 0.0


def test_m1_rejects_unsupported_shapes():
    bkey = torch.zeros((17, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        t_m1.stagea(bkey, bkey, bkey.float(), 48, "plist")
    with pytest.raises(ValueError):
        t_m1.build(48, 512, "full")
    with pytest.raises(ValueError):
        t_m1.stagea(bkey[:4], bkey[:4], bkey[:4].float(), 48, "sort")


def test_m2_plain_matches_jax(j_m2):
    bkeys, offs, sds = t_m2.inputs(2)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(a) for a in j_m2.run(bkeys, offs, sds)]
    args = [torch.from_numpy(a) for a in (bkeys, offs, sds)]
    keys, psd, pw = (a.numpy() for a in t_m2.run(*args))
    np.testing.assert_array_equal(keys, ref[0])
    np.testing.assert_array_equal(pw, ref[2])
    abs_sum = t_m2.run_plain(args[0], args[1], args[2].abs())[1].numpy()
    bound = _bf16_bound(abs_sum, pw, t_m2.SD_RANGE)
    assert (np.abs(psd - ref[1]) <= bound).all(), np.abs(psd - ref[1]).max()
    assert pw.sum() == 2 * t_m2.S


def test_m2_beyond_the_list_lands_in_the_last_row():
    """More distinct keys than NB: the TPU kernel's rank (# list[1:] <= key)
    puts every sample beyond the list into row NB - 1."""
    bkeys = np.arange(t_m2.S, dtype=np.int32).reshape(1, t_m2.ROWS, t_m2.C)
    offs = np.zeros_like(bkeys)
    sds = np.zeros(bkeys.shape, np.float32)
    keys, _, pw = t_m2.run(*(torch.from_numpy(a) for a in (bkeys, offs,
                                                            sds)))
    np.testing.assert_array_equal(keys.numpy().ravel(), np.arange(t_m2.NB))
    assert float(pw[t_m2.NB - 1, 0]) == t_m2.S - (t_m2.NB - 1)
    assert float(pw[:t_m2.NB - 1, 0].sum()) == t_m2.NB - 1


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8b", "formD", "formD8",
                                  "formDb"])
def test_m3_plain_matches_jax(j_m3, mode):
    okey, sdq, lrow, use = t_m3.inputs(N_SMALL)
    with pltpu.force_tpu_interpret_mode():
        ref = j_m3.build(t_m3.NB, mode)(okey, sdq, lrow, use)
    args = [torch.from_numpy(a) for a in (okey, sdq, lrow, use)]
    psd, pw = t_m3.build(t_m3.NB, mode)(*args)
    np.testing.assert_array_equal(psd.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(ref[1]))
    assert t_m3.PRECISION[mode] in t_m3.PRECISIONS


def test_m3_precisions_agree_and_reject_bad_args():
    args = [torch.from_numpy(a) for a in t_m3.inputs(2048, 5)]
    a = t_m3.contract(*args, t_m3.NB, "bf16")
    b = t_m3.contract(*args, t_m3.NB, "int8")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert t_m3.check(*args)["max_abs_err"] == 0.0
    with pytest.raises(ValueError):
        t_m3.contract(*args, 24, "bf16")
    with pytest.raises(ValueError):
        t_m3.contract(*args, t_m3.NB, "fp8")


def test_micro_modules_import_no_jax():
    code = ("import sys; import chad_tsdf_tpu_torch.scripts.micro_mxu8, "
            "chad_tsdf_tpu_torch.scripts.micro_stagea_phases, "
            "chad_tsdf_tpu_torch.scripts.micro_tile_accum; "
            "assert 'jax' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
