"""``BENCHMARK.json`` and the files it names: well formed, and inputs that
depend on the seed alone."""

import json
import math
import re

import pytest
import torch
from conftest import ROOT

from nddwt_bench import data, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nddwt_bench"]
    assert BENCH["command"] == ["python3", "nddwt_bench/run.py"]
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.fullmatch(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_bounds_and_run_length():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    # A full check of 24 cells fits its 43,200 seconds.
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_reports_enough():
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1
        c = harness.resolve(BENCH, cell["name"])
        e2e = {m["name"] for m in c.e2e}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.layer
        for m in c.layer:  # each per-layer metric moves one its cell reports
            assert m["moves"] in e2e
            assert m["layer"] and "\n" not in m["layer"]


def test_layers_are_named_alike():
    layers = {m["name"].partition(".")[0]: m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert layers[m["name"].partition(".")[0]] == m["layer"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs_parse(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert len(entry["source"]) <= 200 and cfg["source"] == entry["source"]
    for key in ("shape", "wavelet", "level", "preserve_l2", "dtype", "assumed"):
        assert key in cfg


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_traffic_and_limits_parse(cell):
    traffic = json.loads((ROOT / "nddwt_bench/traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "nddwt_bench/kinds" / f"{traffic['kind']}.py").is_file()
    assert traffic["sync"] in ("unit", "window")
    assert traffic["check_samples"] >= 1 and traffic["warm_units"] >= 1
    limit = json.loads((ROOT / "nddwt_bench/limits" / f"{cell['name']}.json").read_text())
    err = limit["err_max"]
    assert err["lower"] < err["limit"] < err["upper"]


def _inputs(seed):
    cs = {"ellipsoids": 5, "noise_sigma": 0.01, "mask_axes": [1, 2], "accel": 4,
          "centre": [4, 4], "density_power": 2.0}
    b, mask = data.cs_problem((8, 16, 12), cs, seed, 0, "cpu")
    ring, s1 = data.coil_ring((16, 12), 3, {"ring": 2, "ellipsoids": 5, "noise_sigma": 0.02},
                              seed, "cpu")
    vol, s2 = data.magnitude_volume((8, 8, 8), {"ellipsoids": 5, "noise_sigma": 0.03}, seed, 1,
                                    "cpu")
    return [b, mask, ring, vol, torch.tensor([s1, s2])]


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 987654321098])
def test_same_seed_same_inputs(seed):
    a, b = _inputs(seed), _inputs(seed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    other = _inputs(seed + 1)
    assert not any(torch.equal(x, y) for x, y in zip(a[:4], other[:4]))
    assert [x.shape for x in a] == [x.shape for x in other]


def test_mask_rate_and_centre():
    g = data.generator(7, 0, "cpu")
    m = data.density_mask((4, 64, 48), [1, 2], 4.0, [8, 8], 2.0, g, "cpu")
    assert torch.equal(m[0], m[3])  # the readout axis is fully sampled
    assert abs(float(m.mean()) - 0.25) < 0.03
    k = torch.fft.fftfreq(64, d=1 / 64)
    inner = (k >= -4) & (k < 4)
    assert bool(m[0][inner][:, (torch.fft.fftfreq(48, d=1 / 48).abs() < 4)].all())
    assert math.isclose(float(m.max()), 1.0)
