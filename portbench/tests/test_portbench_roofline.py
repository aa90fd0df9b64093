"""The kernels' bytes and operations (``portbench/roofline/``) at the
shapes the port's ``chip_smoke.py`` recorded them."""

import json
import pathlib

import pytest

from portbench.roofline import K1, K4, PEAKS, bound_s

FOLDER = pathlib.Path(__file__).resolve().parents[1]


def _config(name):
    return json.loads((FOLDER / "configs" / f"{name}.json").read_text())


def test_k1_bytes_at_the_flagship_pool():
    c = _config("flagship")
    (b, f), = K1.launches(c["config"], c["shapes"], 1)
    assert (c["shapes"]["slots_per_voxel"],
            c["shapes"]["storage_voxels"]) == (18, 175104)
    assert b == 183_508_992  # 183.5 MB
    assert f == 24 * 18 * 175104
    (b4, _), = K1.launches(c["config"], c["shapes"], 4)
    assert b4 == 186_660_864  # the moving mask: 186.7 MB
    assert bound_s(b, f) == pytest.approx(b / 3.35e12)


#: the shapes of the ``large_urban`` preset's compact layout (P = 131,072
#: rows, S = 10 slots a voxel), for which K4's arithmetic is kept
LARGE_URBAN = {"layout": "compact", "compact_capacity": 131072,
               "slots_per_voxel": 10}


def test_k4_bytes_at_large_urban():
    calls = K4.launches({}, LARGE_URBAN, 1)
    assert len(calls) == 4
    assert calls[0][0] == 7_864_320  # 7.9 MB, 7 columns
    assert K4.reach(20) == 32 and K4.reach(10) == 16


def test_k4_at_the_large_urban_configuration():
    """The cell's rows: four launches a frame, their columns as the step
    passes them (``csrc/segscan.cu``'s type codes: occupancy's seven at a
    reach of 32, then its two, then birth's four and rebin's one at 16)."""
    c = _config("large_urban")
    assert c["shapes"]["compact_capacity"] == 1 << 20
    calls = K4.launches(c["config"], c["shapes"], 1)
    assert [b for b, _ in calls] == [60 << 20, 23 << 20, 31 << 20,
                                     7 << 20]
    assert [f for _, f in calls] == [7 * 5 << 20, 2 * 5 << 20,
                                     4 * 4 << 20, 4 << 20]
    assert sum(bound_s(b, f) for b, f in calls) == pytest.approx(
        (121 << 20) / 3.35e12)


def test_a_layout_without_the_kernel_has_no_launches():
    assert K1.launches({}, LARGE_URBAN, 1) == []
    assert K4.launches(_config("flagship")["config"],
                       _config("flagship")["shapes"], 1) == []
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
