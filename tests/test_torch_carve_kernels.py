"""The carve's kernels (``ops/carve_kernels.py``, ``csrc/carve.cu``,
``csrc/carve_sort.cu``) held against the plain route on the card, bit for
bit: the keys, their count and digit counts, the sorted keys, both pool
planes, ``touched_overflow`` and the three metrics
(``chad_tsdf_tpu_torch/scripts/carve_stages.py`` ``hold``); and the sort
alone against ``torch.sort`` on the parked sweep and on made-up keys.

Cases: a parked sweep at ``kitti_hdl64_carve``'s map configuration carved
into the map of another sweep from the same spot, whose obstacles it
passes through (``carve_stages.scene``), under the configuration's touched
cap and under one that loses blocks; a cloud whose size is no multiple of
``carve_subsample``, and an empty one; rays that leave the local extent,
and a scanner outside it; the packed-ingest carve.  On the CPU every carve
takes the plain route, which ``tests/test_torch_carve.py`` holds against
the JAX package; here the CPU tests hold the stages that route is cut into
to the sequence they replace, the kernels' bounds, the sort's digit plan
and plain digit counts, and the wrappers' refusal of CPU tensors.

No JAX here: the tests marked ``card`` run on the card, where JAX is not
installed (``python3 -m pytest tests/test_torch_carve_kernels.py -m
card``)."""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from chad_tsdf_tpu_torch import MapConfig, kernels
from chad_tsdf_tpu_torch.core import carve, integrate
from chad_tsdf_tpu_torch.core.state import (clone_state, create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.io.kitti import synthetic_lidar_scan
from chad_tsdf_tpu_torch.ops import carve_kernels
from chad_tsdf_tpu_torch.scripts import carve_stages

CFG = MapConfig(max_points=16384, block_capacity=1 << 15,
                touched_capacity=1 << 14, accumulate_impl="seg",
                carve_steps=48, carve_stride=2.0, carve_subsample=3,
                carve_weight=1.0)
POS = np.float32([0.3, -0.2, 1.7])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture
def card():
    """The CUDA card of a test marked ``card``; skips without one (decided
    here, never while the module is imported)."""
    return _card()


@pytest.fixture(scope="module")
def kitti():
    """``carve_stages.scene``: the map of one parked sweep and the sweep
    to carve, on the card."""
    return carve_stages.scene(_card())


def _launched(fn, names=("carve_keys", "carve_apply")):
    before = dict(kernels.LAUNCHES)
    out = fn()
    return out, {k: kernels.LAUNCHES[k] - before[k] for k in names}


@pytest.mark.card
@pytest.mark.parametrize("cap", [None, carve_stages.SMALL_CAP])
def test_kitti_sweep_kernels_equal_plain(kitti, cap):
    """The parked sweep: equal under the cell's touched cap (nothing lost)
    and under one that loses blocks; each route's carve
    launches the two kernels once, the plain route none."""
    cfg, state, pts, n, pos = kitti
    if cap is not None:
        cfg = dataclasses.replace(cfg, touched_capacity=cap)
    counts, launched = _launched(
        lambda: carve_stages.hold(state, pts, n, pos, cfg))
    assert launched == {"carve_keys": 2, "carve_apply": 1}
    assert counts["n_carve_samples"] > 0 and counts["n_carve_dropped"] > 0
    assert (counts["touched_overflow"] > 0) == (cap is not None)
    _, launched = _launched(lambda: carve.carve_step_plain(
        clone_state(state), pts, n, pos, cfg))
    assert launched == {"carve_keys": 0, "carve_apply": 0}


@pytest.mark.card
def test_carve_sort_on_the_sweep(kitti):
    """The parked sweep's keys: ``carve_keys``' digit counts are the plain
    counts, ``carve_sort`` equals ``torch.sort(key).values`` over all S
    slots and leaves its input as it was; the kernel route's carve sorts
    with it once, the plain route never."""
    cfg, state, pts, n, pos = kitti
    key, nv, counts = carve.carve_keys(pts, n, pos, state.origin_blocks, cfg)
    assert torch.equal(counts, carve.digit_counts_plain(key, cfg))
    want = torch.sort(key).values
    kept = key.clone()
    got, launched = _launched(
        lambda: carve_kernels.carve_sort(key, nv, counts, key_bits=39),
        ("carve_sort",))
    assert launched == {"carve_sort": 1}
    assert torch.equal(got, want) and torch.equal(key, kept)
    assert 0 < int(nv) < key.numel()
    for step, want_n in ((carve.carve_step, 1), (carve.carve_step_plain, 0)):
        _, launched = _launched(lambda: step(clone_state(state), pts, n, pos,
                                             cfg), ("carve_sort",))
        assert launched == {"carve_sort": want_n}


INVALID = (2**31 - 1) << 32 | (2**31 - 1)
TILE = carve_kernels.SORT_TILE

# (slots, valid keys, block_bits, how the valid keys are drawn)
SORT_CASES = {
    "n_valid_0": (3 * TILE + 17, 0, 10, "random"),
    "n_valid_1": (3 * TILE + 17, 1, 10, "random"),
    "n_valid_S": (3 * TILE + 17, 3 * TILE + 17, 10, "random"),
    "all_equal": (100_003, 50_000, 10, "equal"),
    "top_of_39_bits": (100_003, 60_000, 10, "top"),
    "random_block_bits_10": (1 << 21, 1_200_000, 10, "random"),
    "random_block_bits_4": (1 << 20, 700_000, 4, "random"),
    "one_slot": (1, 1, 10, "random"),
    "one_empty_slot": (1, 0, 10, "random"),
    "ragged_tiles": (5 * TILE - 3, 2 * TILE + 5, 7, "random"),
}


def sort_case(name):
    """(key i64[S], n_valid, config) of ``SORT_CASES[name]``: the valid
    keys ``bkey << 32 | okey`` at random slots, ``INVALID`` elsewhere."""
    s, nv, bb, how = SORT_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    key = np.full(s, INVALID, np.int64)
    top = (1 << 3 * bb) - 1
    if how == "random":
        b = rng.integers(0, top + 1, nv)
        o = rng.integers(0, 512, nv)
    else:
        b = np.full(nv, top if how == "top" else rng.integers(0, top + 1))
        o = np.full(nv, 511 if how == "top" else rng.integers(0, 512))
    key[rng.permutation(s)[:nv]] = b.astype(np.int64) << 32 | o
    return key, nv, dataclasses.replace(CFG, block_bits=bb)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SORT_CASES))
def test_carve_sort_equals_torch_sort(card, name):
    """``carve_sort`` is ``torch.sort(key).values`` bit for bit over all S
    slots: no valid key, one, every slot; every valid key equal; keys at
    the top of the 39 bits; random keys over the full range at
    ``block_bits`` 10 and below; one slot; S no multiple of a tile."""
    key, nv, cfg = sort_case(name)
    key = torch.from_numpy(key).to(card)
    n_valid = torch.tensor(nv, dtype=torch.int32, device=card)
    got = carve_kernels.carve_sort(
        key, n_valid, carve.digit_counts_plain(key, cfg),
        key_bits=carve.sort_key_bits(cfg))
    want = torch.sort(key).values
    assert torch.equal(got, want), int((got != want).sum())


def _walled(dev, cfg=CFG):
    """A map of one synthetic LiDAR scan, inserted from POS."""
    scan = synthetic_lidar_scan([0.3, -0.2, 0.0], seed=2)
    pts = scan[:: max(1, len(scan) // 12000)][:12000]
    st = create_state(cfg, origin_blocks_for_position(POS, cfg), dev)
    st, _ = integrate.insert_step(st, _pad(pts, dev, cfg), len(pts),
                                  torch.from_numpy(POS).to(dev), cfg)
    return st


def _pad(pts, dev, cfg=CFG):
    out = np.zeros((cfg.max_points, 3), np.float32)
    out[:len(pts)] = pts
    return torch.from_numpy(out).to(dev)


def _second_scan(n):
    pos = POS + np.float32([1.1, 0.4, 0.0])
    scan = synthetic_lidar_scan([1.4, 0.2, 0.0], seed=5)
    return scan[:: max(1, len(scan) // n)][:n], pos


@pytest.mark.card
@pytest.mark.parametrize("n", [12_001, 12_000 - 1, 1, 0])
def test_ragged_and_empty_clouds(card, n):
    """Clouds of any size: no multiple of ``carve_subsample`` (3), one
    point, none at all (no valid sample: every counter 0, the pool as it
    was)."""
    st = _walled(card)
    pts, pos = _second_scan(max(n, 1))
    pts = pts[:n]
    counts = carve_stages.hold(st, _pad(pts, card), n,
                               torch.from_numpy(pos).to(card), CFG)
    if n == 0:
        assert counts["n_valid"] == 0
        assert counts["n_carve_samples"] == counts["n_carve_dropped"] == 0
    elif n > 1:
        assert counts["n_carve_samples"] > 0


@pytest.mark.card
@pytest.mark.parametrize("shift", [2.5, 40.0])
def test_rays_leaving_the_local_extent(card, shift):
    """A 16-block extent (6.4 m): from a scanner near its edge, many rays
    leave it part way; from one far outside, every ray lies outside and
    nothing is valid."""
    cfg = dataclasses.replace(CFG, block_bits=4)
    st = _walled(card, cfg)
    pts, pos = _second_scan(12_000)
    pos = pos + np.float32([shift, 0.0, 0.0])
    counts = carve_stages.hold(st, _pad(pts + np.float32([shift, 0, 0]),
                                        card, cfg),
                               len(pts), torch.from_numpy(pos).to(card), cfg)
    inside = counts["n_valid"]
    assert (inside > 0) == (shift < 10.0)
    assert inside < cfg.carve_steps * -(-len(pts) // cfg.carve_subsample)


@pytest.mark.card
def test_packed_ingest_carve(card):
    """The packed-ingest carve (``carve_step_packed``: the i16 cloud,
    decoded on the card) equals the plain route on the decoded cloud."""
    cfg = dataclasses.replace(CFG, packed_ingest=True)
    st = _walled(card, cfg)
    pts, pos = _second_scan(12_000)
    pad = np.zeros((cfg.max_points, 3), np.float32)
    pad[:len(pts)] = pts
    q = torch.from_numpy(integrate.pack_points(pad, pos, cfg.sdf_res))
    pos_t = torch.from_numpy(pos).to(card)
    got, gm = carve.carve_step_packed(clone_state(st), q.to(card), len(pts),
                                      pos_t, cfg)
    want, wm = carve.carve_step_plain(
        clone_state(st), integrate.unpack_points(q.to(card), pos_t, cfg),
        len(pts), pos_t, cfg)
    for f in ("pool_sd", "pool_w", "touched_overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert {k: int(v) for k, v in gm.items()} == \
        {k: int(v) for k, v in wm.items()}
    assert int(gm["n_carve_samples"]) > 0


# ---- on the CPU: the stages the card's route is built from ----

@pytest.fixture(scope="module")
def cpu_scene():
    """A small map of one scan and a second scan to carve, on the CPU."""
    pts, pos = _second_scan(12_000)
    return _walled("cpu"), _pad(pts, "cpu"), len(pts), torch.from_numpy(pos)


@pytest.mark.parametrize("cap", [1 << 14, 100, 1])
def test_carve_stages_add_up(cpu_scene, cap):
    """``carve_keys``, the sort and ``carve_apply`` are ``carve_step``:
    the same state and metrics as today's sequence through
    ``carve_entries``, ``lookup_blocks``, ``apply_entries`` and
    ``lost_samples``; the blocks past the cap are ``touched_overflow``,
    and hits, drops and the lost blocks' samples add up to the valid
    samples."""
    st, pts, n, pos = cpu_scene
    cfg = dataclasses.replace(CFG, touched_capacity=cap)
    got, gm = carve.carve_step(clone_state(st), pts, n, pos, cfg)

    want = clone_state(st)
    e_b, e_o, e_c, n_valid, e_end = carve.carve_entries(
        pts, n, pos, st.origin_blocks, cfg)
    flags, _, found, slots, first_lost, ovf = carve.lookup_blocks(want, e_b,
                                                                  cfg)
    _, wm = carve.apply_entries(want, e_b, e_o, e_c, n_valid, flags, found,
                                slots, cfg)
    lost = carve.lost_samples(e_end, n_valid, first_lost)
    for f in ("pool_sd", "pool_w"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(gm["n_carve_dropped"]) == int(wm["n_carve_dropped"] - lost)
    for k in ("n_carve_samples", "n_carved_voxels"):
        assert int(gm[k]) == int(wm[k]), k

    counts = carve_stages.hold(st, pts, n, pos, cfg)
    assert int(st.touched_overflow) == 0
    assert counts["touched_overflow"] == max(counts["blocks"] - cap, 0) == \
        int(got.touched_overflow) == int(ovf)
    assert counts["n_carve_samples"] + counts["n_carve_dropped"] + \
        int(lost) == counts["n_valid"] == int(n_valid)
    assert (int(lost) > 0) == (cap < counts["blocks"])


def test_carve_bounds_count_the_bytes():
    """Each kernel's bound: 12 B a ray and 8 B a slot for the keys; 8 B a
    slot read and 8 B a slot written for the sort; 8 B a valid sample, 8 B
    a looked-up block and 16 B a carved voxel for the apply, at 3.35
    TB/s."""
    counts = {"slots": 1000, "n_valid": 600, "blocks": 50,
              "n_carved_voxels": 70}
    cfg = dataclasses.replace(CFG, touched_capacity=40)
    b = carve_stages.bounds_ms(counts, cfg, rays=100)
    assert b["carve_keys_bytes"] == 12 * 100 + 8 * 1000
    assert b["carve_sort_bytes"] == 16 * 1000
    assert b["carve_apply_bytes"] == 8 * 600 + 8 * 40 + 16 * 70
    assert b["carve_keys"] == pytest.approx(9200 / 3.35e12 * 1e3)
    assert b["carve_sort"] == pytest.approx(16000 / 3.35e12 * 1e3)


@pytest.mark.parametrize("block_bits, key_bits, passes",
                         [(10, 39, 5), (7, 30, 4), (4, 21, 3), (1, 12, 2)])
def test_sort_digit_plan(block_bits, key_bits, passes):
    """The sort's digits come from the configuration's ``block_bits``: a
    valid key has ``3 * block_bits + 9`` significant bits, sorted 8 at a
    time; its workspace holds a tile counter and one look-back word a tile
    and digit for each pass."""
    cfg = dataclasses.replace(CFG, block_bits=block_bits)
    assert carve.sort_key_bits(cfg) == key_bits
    assert carve_kernels.sort_passes(key_bits) == passes
    assert carve_kernels.sort_workspace_ints(8_388_608, key_bits) == \
        passes * (1 + 2048 * 256)
    assert carve_kernels.sort_workspace_ints(1, key_bits) == passes * 257


@pytest.mark.parametrize("name", ["random_block_bits_10", "ragged_tiles",
                                  "top_of_39_bits", "n_valid_0"])
def test_digit_counts_plain(name):
    """``digit_counts_plain`` (what the card's ``carve_keys`` is held to):
    per pass, the valid keys by their 8-bit digit of ``bkey << 9 | okey``,
    as numpy counts them; each pass counts every valid key once."""
    key, nv, cfg = sort_case(name)
    got = carve.digit_counts_plain(torch.from_numpy(key), cfg).numpy()
    v = key[key != INVALID]
    v = (v >> 32) << 9 | (v & 511)
    want = [np.bincount((v >> 8 * q) & 255, minlength=256)
            for q in range(carve_kernels.sort_passes(
                carve.sort_key_bits(cfg)))]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.stack(want))
    assert (got.sum(axis=1) == nv).all()


@pytest.mark.parametrize("stage", ["carve_keys", "carve_sort",
                                   "carve_apply"])
def test_carve_kernel_wrappers_refuse_cpu_tensors(cpu_scene, stage):
    """The kernels' wrappers take CUDA tensors or raise: the CPU route is
    chosen in ``core/carve.py``, never by a fallback inside a wrapper."""
    st, pts, n, pos = cpu_scene
    key = torch.zeros(8, dtype=torch.int64)
    nv = torch.zeros((), dtype=torch.int32)
    call = {
        "carve_keys": lambda: carve_kernels.carve_keys(
            pts, nv, pos, st.origin_blocks, k=4, sub=1, step_m=0.1,
            res_recip=20.0, trunc=0.1, extent=64, key_bits=39),
        "carve_sort": lambda: carve_kernels.carve_sort(
            key, nv, torch.zeros((5, 256), dtype=torch.int32),
            key_bits=39),
        "carve_apply": lambda: carve_kernels.carve_apply(
            key, nv, st.dir_keys, st.dir_slots, st.pool_sd, st.pool_w,
            t_cap=4, sd_per=0.1, w_per=1.0),
    }[stage]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        call()
