"""K5's launch shape and slot fields (gbdt/route.py: route_plan, _field) on
the CPU, and the rules of the kernel's node -> slot lookup held on the
plain version, which the card tests hold the kernel to.

route_plan is integer arithmetic and _field a dtype mapping, so every
check is exact. The kernel (csrc/route.cu) itself runs only on the card:
tests/test_torch_cuda.py holds it equal to route_wave_plain on the cases
below and more."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu_torch.gbdt import route

SM = 132


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 1000, 1 << 20, 10_502_144])
@pytest.mark.parametrize("NW", [0, 1, 17, 64, 4096, 7264, 8301])
def test_route_plan_fits_and_bounds_the_grid(NW, n, vec):
    p = route.route_plan(NW, n, SM, vec)
    assert p["threads"] == route.THREADS
    # the entries and the larger of the map and the sorted ids fit
    assert p["smem"] == 24 * NW + 4 * max(p["map_cap"], NW)
    assert p["smem"] <= route.SMEM_MAX
    assert 1 <= p["map_cap"] <= route.ROUTE_MAP_CAP
    if 24 * NW + 4 * route.ROUTE_MAP_CAP <= route.SMEM_MAX:
        assert p["map_cap"] == route.ROUTE_MAP_CAP
    # a persistent grid: no more blocks than resident ones, or than the
    # rows (four a thread when vec) need
    items = -(-n // 4) if vec else n
    assert 1 <= p["blocks"] <= route.ROUTE_BLOCKS_PER_SM * SM
    assert p["blocks"] == max(1, min(-(-items // route.THREADS),
                                     route.ROUTE_BLOCKS_PER_SM * SM))
    assert p["blocks"] * route.THREADS * (4 if vec else 1) >= n or \
        p["blocks"] == route.ROUTE_BLOCKS_PER_SM * SM


def test_route_plan_refuses_only_past_shared_memory():
    """A wave whose slot entries and sorted ids pass SMEM_MAX is refused
    by name; every wave the table-in-shared-memory kernel took before
    (8 x 4 bytes a slot: up to 7,264 slots) still fits."""
    route.route_plan(7264, 1000, SM)
    top = route.SMEM_MAX // 28
    route.route_plan(top, 1000, SM)
    with pytest.raises(ValueError, match="shared memory"):
        route.route_plan(top + 1, 1000, SM)
    with pytest.raises(ValueError, match="must be"):
        route.route_plan(4, 10, 0)


@pytest.mark.parametrize("dtype,code", [
    (torch.bool, 1), (torch.uint8, 1), (torch.int8, -1), (torch.int16, 2),
    (torch.int32, 4), (torch.int64, 8),
])
def test_fields_are_read_in_place(dtype, code):
    t = torch.ones(5, dtype=dtype)
    got, c = route._field("nid", t, 5, t.device)
    assert got is t and c == code


@pytest.mark.parametrize("t", [
    torch.arange(5, dtype=torch.float32) + 0.5,
    torch.arange(10, dtype=torch.int32)[::2],
    torch.arange(5, dtype=torch.float64),
])
def test_other_fields_are_converted_once(t):
    """Another dtype or a strided view becomes one contiguous int32 copy,
    the values the plain version compares (.to(torch.int32))."""
    got, c = route._field("slot", t, 5, t.device)
    assert c == 4 and got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, t.to(torch.int32))


def test_fields_refuse_a_bad_shape_and_skip_an_absent_range():
    assert route._field("lo", None, 5, torch.device("cpu")) == (None, 0)
    with pytest.raises(ValueError, match=r"feat must be an \(5,\) tensor"):
        route._field("feat", torch.zeros(4, dtype=torch.int32), 5,
                      torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("later_valid", [True, False])
def test_a_duplicated_id_routes_by_its_highest_valid_slot(later_valid):
    """Slots 0 and 2 hold node 4 with different splits: where slot 2 is
    valid it decides (the Pallas kernel's later-slot-wins), where it is
    not, slot 0 does; the kernel's map and its sorted ids keep the highest
    valid slot of an id."""
    bins = _t(np.asarray([[1, 5, 9, 9]], np.uint8))
    pos = _t(np.asarray([4, 4, 4, 7], np.int32))
    valid = _t(np.asarray([True, True, later_valid]))
    nid = _t(np.asarray([4, 7, 4], np.int32))
    feat = _t(np.zeros(3, np.int32))
    slot = _t(np.asarray([0, 3, 6], np.int32))
    lch = _t(np.asarray([10, 12, 14], np.int32))
    got = route.route_wave(bins, pos, valid, nid, feat, slot, lch, lch + 1)
    want = [14, 14, 15, 13] if later_valid else [11, 11, 11, 13]
    assert got.tolist() == want


def test_ids_far_past_the_lookup_caps_route():
    """Node ids above K1-K4's 57,344-node cap and a wave spread wider than
    the direct map (ROUTE_MAP_CAP ids) route as any other (the kernel
    falls back to its sorted ids)."""
    rng = np.random.RandomState(2)
    n, NW = 3000, 40
    nid = (rng.choice(10 ** 6, size=NW, replace=False) + 60000).astype(
        np.int32)
    pos = nid[rng.randint(0, NW, size=n)]
    pos[::7] = -1
    bins = rng.randint(0, 256, size=(3, n)).astype(np.uint8)
    valid = np.ones(NW, bool)
    feat = rng.randint(0, 3, size=NW).astype(np.int32)
    slot = rng.randint(0, 256, size=NW).astype(np.int32)
    lch = (2 * 10 ** 6 + 2 * np.arange(NW)).astype(np.int32)
    got = route.route_wave(*[_t(a) for a in (bins, pos, valid, nid, feat,
                                             slot, lch, lch + 1)]).numpy()
    assert np.ptp(nid) > route.ROUTE_MAP_CAP
    idx = {int(v): i for i, v in enumerate(nid)}
    for r in range(n):
        if pos[r] < 0:
            assert got[r] == -1
            continue
        i = idx[int(pos[r])]
        right = bins[feat[i], r] > slot[i]
        assert got[r] == lch[i] + right
