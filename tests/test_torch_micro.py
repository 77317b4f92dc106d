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


@pytest.fixture(scope="module")
def m3_ref(j_m3):
    """(inputs, the JAX script's outputs) per (case, nb, mode), each run
    once under ``pltpu.force_tpu_interpret_mode()``; case None is the
    script's own inputs, else one of ``EDGE_CASES``."""
    cache = {}

    def ref(case, nb, mode):
        if (case, nb, mode) not in cache:
            npy = (t_m3.inputs(N_SMALL) if case is None else
                   t_m3.edge_inputs(case, N_SMALL, nb))
            with pltpu.force_tpu_interpret_mode():
                out = j_m3.build(nb, mode)(*npy)
            cache[case, nb, mode] = (npy, [np.asarray(a) for a in out])
        return cache[case, nb, mode]
    return ref


def _m3_port(npy, nb, mode):
    args = [torch.from_numpy(a) for a in npy]
    return [a.numpy() for a in t_m3.build(nb, mode)(*args)]


@pytest.mark.parametrize("nb", t_m3.NB_SUPPORTED)
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8b", "formD", "formD8",
                                  "formDb"])
def test_m3_plain_matches_jax(m3_ref, mode, nb):
    npy, ref = m3_ref(None, nb, mode)
    psd, pw = _m3_port(npy, nb, mode)
    np.testing.assert_array_equal(psd, ref[0])
    np.testing.assert_array_equal(pw, ref[1])
    assert t_m3.PRECISION[mode] in t_m3.PRECISIONS


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("case", t_m3.EDGE_CASES)
def test_m3_edge_cases_match_jax(m3_ref, case, mode):
    """One offset group, use all zero, sdq at +-127 with a pile of +127 in
    one cell per tile, lrow outside [0, nb): the port equals the JAX
    script's kernel, and each case shows what it stresses."""
    nb = t_m3.NB
    npy, ref = m3_ref(case, nb, mode)
    psd, pw = _m3_port(npy, nb, mode)
    np.testing.assert_array_equal(psd, ref[0])
    np.testing.assert_array_equal(pw, ref[1])
    okey, sdq, lrow, use = npy
    if case == "one_group":
        assert pw[:, 5 * 64:6 * 64].sum() == pw.sum() > 0
    elif case == "unused":
        assert not psd.any() and not pw.any()
    elif case == "sdq127":
        # half of each tile's K * 1024 samples land in (row 0, offset 0)
        pile = 127 * t_m3.K * t_m3.TILE // 2
        assert (psd[::nb, 0] >= pile - 127 * 40).all()
        assert np.abs(sdq).min() == 127
    else:
        outside = (lrow < 0) | (lrow >= nb)
        assert outside.any()
        assert pw.sum() == ((use != 0) & ~outside).sum()


@pytest.mark.parametrize("case", (None, *t_m3.EDGE_CASES))
def test_m3_onehot_bmm_matches_jax(m3_ref, case):
    """The yardstick's operands (``onehot_operands``), contracted with
    ``torch.bmm`` in f32 on the CPU, equal the plain version and the JAX
    script's kernel exactly."""
    nb = t_m3.NB
    npy, ref = m3_ref(case, nb, "bf16")
    args = [torch.from_numpy(a) for a in npy]
    onehot, vals = t_m3.onehot_operands(*args, nb, dtype=torch.float32)
    t = N_SMALL // t_m3.TILE
    assert onehot.shape == (t, 512, t_m3.K * t_m3.TILE)
    assert vals.shape == (t, t_m3.K * t_m3.TILE, 2 * nb)
    got = t_m3.from_bmm(torch.bmm(onehot, vals), nb)
    plain = t_m3.contract_plain(*args, nb)
    for a, b, r in zip(got, plain, ref):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), r)


@pytest.mark.parametrize("case", (None, *t_m3.EDGE_CASES))
def test_m3_wgmma_count_is_the_padded_lists(case):
    """``mma_steps_plain`` (what the kernel must report per tile) against a
    recount in numpy: per tile and offset group of 64 rows, the kept
    samples padded to a multiple of one wgmma's K."""
    nb = t_m3.NB
    npy = (t_m3.inputs(N_SMALL, 3) if case is None else
           t_m3.edge_inputs(case, N_SMALL, nb, 3))
    okey, sdq, lrow, use = npy
    kept = (use != 0) & (lrow >= 0) & (lrow < nb)
    t = N_SMALL // t_m3.TILE
    args = [torch.from_numpy(a) for a in npy]
    for prec, step in t_m3.K_STEP.items():
        want = np.zeros(t, np.int64)
        for i in range(t):
            cols = slice(i * t_m3.TILE, (i + 1) * t_m3.TILE)
            groups = okey[:, cols][kept[:, cols]] // 64
            counts = np.bincount(groups, minlength=8)
            want[i] = (-(-counts // step)).sum()
        steps = torch.full((t,), -1, dtype=torch.int32)
        t_m3.contract(*args, nb, prec, steps)
        np.testing.assert_array_equal(steps.numpy(), want)
        flop = t_m3.bucketed_flop(steps, nb, prec)
        assert flop == want.sum() * 2 * 64 * 2 * nb * step
        if case == "one_group":      # one list a tile: 8x fewer than dense
            dense = kept.reshape(t_m3.K, t, t_m3.TILE).sum((0, 2))
            assert (want == -(-dense // step)).all()


def test_m3_phase_cuts_find_their_places():
    """``scripts/m3_turns.py`` times M3 by phase from copies of micro.cu cut
    at fixed lines: each cut must find its line exactly once."""
    from chad_tsdf_tpu_torch import kernels
    from chad_tsdf_tpu_torch.scripts import m3_turns
    with open(os.path.join(kernels.CSRC, "micro.cu")) as fh:
        src = fh.read()
    for phase in m3_turns._CUTS:
        cut = m3_turns.cut_source(src, phase)
        assert cut != src
    with pytest.raises(RuntimeError):
        m3_turns.cut_source(src.replace("wgmma_ss(acc, da +", "x"), "no_mma")


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
    with pytest.raises(ValueError):     # the kernel's 16-bit group counts
        t_m3.contract(*(torch.cat([a] * 2) for a in args), t_m3.NB, "bf16")
    with pytest.raises(ValueError):
        t_m3.edge_inputs("two_groups", 2048)


def test_micro_modules_import_no_jax():
    code = ("import sys; import chad_tsdf_tpu_torch.scripts.micro_mxu8, "
            "chad_tsdf_tpu_torch.scripts.micro_stagea_phases, "
            "chad_tsdf_tpu_torch.scripts.micro_tile_accum, "
            "chad_tsdf_tpu_torch.scripts.m3_turns; "
            "assert 'jax' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
