"""A configuration, a traffic mix and a metric added as new files, with new
entries in ``BENCHMARK.json``, are found by name alone: no file that was
there is edited."""

import hashlib
import json

from conftest import run_tiny

from nddwt_bench import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "nddwt_bench").rglob("*") if p.is_file()}


def test_new_files_found_by_name(tiny):
    bench, root = tiny
    before = _digests(root)
    bdir = root / "nddwt_bench"
    # A new configuration: a 2D image, its own file.
    (bdir / "configs" / "img2d.json").write_text(json.dumps({
        "name": "img2d", "source": "https://example.org/img2d", "shape": [20, 16],
        "coils": 1, "wavelet": "db2", "level": 2, "preserve_l2": True, "dtype": "float32",
        "reduced": {}, "assumed": {}}))
    # A new traffic mix of a kind that exists: data only.
    (bdir / "traffic" / "denoise_soft.json").write_text(json.dumps({
        "kind": "dec_rec", "sync": "unit", "warm_units": 1, "problems": 3, "ellipsoids": 4,
        "noise_sigma": 0.05, "threshold_sigma": 2.0, "check_samples": 3}))
    (bdir / "limits" / "img2d_denoise_soft.json").write_text(json.dumps(
        {"err_max": {"limit": 1e-4, "lower": 1e-6, "upper": 1e-2}}))
    # A new per-layer metric with a reader of its own.
    (bdir / "metrics" / "units_done.py").write_text(
        "def read(rec):\n    return float(rec.units)\n")
    bench["configs"].append({"name": "img2d", "source": "https://example.org/img2d",
                             "file": "nddwt_bench/configs/img2d.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "img2d_denoise_soft", "config": "img2d",
                               "traffic": "denoise_soft", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "img_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["img2d_denoise_soft"]})
    bench["per_layer"].append({"name": "units_done", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "Solvers", "moves": "img_ms",
                               "workloads": ["img2d_denoise_soft"]})
    # img_ms has no reader of its own name yet: a reader of the prefix serves it.
    (bdir / "metrics" / "img_ms.py").write_text(
        "def read(rec):\n    return 1e3 * rec.window_s / rec.units\n")
    new = set(_digests(root)) - set(before)
    assert all(_digests(root)[p] == d for p, d in before.items())  # nothing edited
    assert {p.name for p in new} == {"img2d.json", "denoise_soft.json",
                                     "img2d_denoise_soft.json", "units_done.py", "img_ms.py"}

    c = harness.resolve(bench, "img2d_denoise_soft", root)
    assert c.cfg["shape"] == [20, 16] and c.traffic["problems"] == 3
    assert [m["name"] for m in c.e2e] == ["setup_s", "img_ms"]
    assert [m["name"] for m in c.layer] == ["units_done"]
    line = run_tiny(bench, root, "img2d_denoise_soft")
    assert line["correct"] and set(line["metrics"]) == {"setup_s", "img_ms"}
    traced = run_tiny(bench, root, "img2d_denoise_soft", trace=True)
    assert traced["metrics"]["units_done"]["value"] == traced["attempted"]


def test_reader_by_prefix(tiny):
    _, root = tiny
    read = harness.reader(root / "nddwt_bench", "launches.some_new_cell")
    assert read is harness.reader(root / "nddwt_bench", "launches.cs")
