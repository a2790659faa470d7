"""The inpainting cell, ``img2d_inpaint``: inputs that depend on the seed
alone, the mask's density, the work count, and ``correct`` true for the
program and false for two faults, on a tiny copy of the benchmark on the
CPU with the cell's own 100 iterations a solve."""

import json

import pytest
import torch
from conftest import ROOT, run_tiny

from nddwt_bench import harness
from non_decimated_wavelets_tpu_torch import NDDWT

CELL = "img2d_inpaint"
TRAFFIC = json.loads((ROOT / "nddwt_bench/traffic/inpaint.json").read_text())


def _kind(bench=None, root=ROOT):
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.resolve(bench, CELL, root).kind


@pytest.fixture
def full(tiny):
    """The tiny copy with the cell's traffic at its own iteration count."""
    bench, root = tiny
    path = root / "nddwt_bench/traffic/inpaint.json"
    traffic = json.loads(path.read_text())
    traffic["iters"] = TRAFFIC["iters"]
    path.write_text(json.dumps(traffic))
    return bench, root


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 987654321098])
def test_same_seed_same_inputs(seed):
    problem = _kind().problem
    a = [t for p in range(2) for t in problem((24, 16), TRAFFIC, seed, p, "cpu")]
    b = [t for p in range(2) for t in problem((24, 16), TRAFFIC, seed, p, "cpu")]
    other = [t for p in range(2) for t in problem((24, 16), TRAFFIC, seed + 1, p, "cpu")]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, other))
    assert not torch.equal(a[1], a[3])  # a fresh mask per problem


def test_mask_density_and_observation():
    b, mask = _kind().problem((264, 264), TRAFFIC, 2**31 + 99, 0, "cpu")
    assert abs(float(mask.mean()) - 0.5) <= 0.02
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(b, mask * b) and float(b.abs().max()) > 0.5


def test_work_at_the_cell_shape():
    # Per iteration 116 bytes a pixel: the gradient step 16, an analysis and
    # a synthesis of 11 arrays each 88, the momentum 12; 12 for M b once.
    cfg = json.loads((ROOT / "nddwt_bench/configs/img2d_264.json").read_text())
    ctx = type("Ctx", (), {"cfg": cfg, "traffic": TRAFFIC})
    w = _kind().work(ctx)
    n = 264 * 264
    assert w.bytes == (12 + 100 * 116) * n
    # 2 K 2^(j+1) operations a pixel a level, K = 2 and 6: 56 a level.
    assert w.flops == 100 * 2 * 3 * 56 * n
    assert round(w.bytes / 1e9, 2) == 0.81


def test_program_is_correct(full):
    line = run_tiny(*full, CELL)
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["err_max"]["value"] <= line["checks"]["err_max"]["limit"]


def test_bfloat16_storage_fails(full, monkeypatch):
    """The program's own bfloat16 plan on the inputs rounded to bfloat16."""
    kind = _kind(*full)
    solve = kind.fista_inpaint

    def low(plan, b, mask, lam, **kw):
        p16 = NDDWT(plan.wavelet, plan.shape, preserve_l2=plan.preserve_l2,
                    dtype="bfloat16", device=b.device)
        return solve(p16, b.to(torch.bfloat16), mask.to(torch.bfloat16), lam, **kw)

    monkeypatch.setattr(kind, "fista_inpaint", low)
    assert not run_tiny(*full, CELL)["correct"]


def test_ninety_iterations_fail(full, monkeypatch):
    """A solve cut to 90 iterations reads 9.2e-5 on this seed's first
    problem, which has nearly settled, and 1.1e-3 on its second: the
    window runs both (two units at least) and the comparison sees both."""
    kind = _kind(*full)
    solve = kind.fista_inpaint
    monkeypatch.setattr(kind, "fista_inpaint",
                        lambda plan, b, mask, lam, level, iters, step:
                        solve(plan, b, mask, lam, level=level, iters=iters - 10, step=step))
    line = run_tiny(*full, CELL, seconds=2.0)
    assert line["attempted"] >= 2 and not line["correct"]
