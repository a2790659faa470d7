"""``correct``: true for the program, false with the timed path broken
underneath and for the lower-precision control, at a tiny size on the CPU.

Each fault is planted where the program produces its output, under the
harness's own run (its look for a card skipped, the rest as in a run): a
step that returns its state unchanged, half of a batch left out, an answer
altered where it is produced. The cells run on one chip, so no exchange
between chips can be left out.
"""

import json
import random
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, run_tiny

from nddwt_bench import harness
from non_decimated_wavelets_tpu_torch import NDDWT

CELLS = ["knee3d_cs_r4", "knee2d_mc_coilwise", "knee3d_denoise"]


def _alter(x):
    """One element moved by a hundredth of the largest magnitude."""
    x = x.clone()
    x.view(-1)[x.numel() // 3] += 0.01 * x.abs().max()
    return x


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(tiny, workload):
    line = run_tiny(*tiny, workload)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["err_max"]["value"] <= line["checks"]["err_max"]["limit"]


def _kind(tiny, workload):
    return harness.resolve(tiny[0], workload, tiny[1]).kind


def test_cs_unchanged_state(tiny, monkeypatch):
    kind = _kind(tiny, "knee3d_cs_r4")
    solve = kind.fista_cs_mri
    monkeypatch.setattr(kind, "fista_cs_mri",
                        lambda plan, b, mask, lam, level, iters, step:
                        solve(plan, b, mask, lam, level, 0, step))
    assert not run_tiny(*tiny, "knee3d_cs_r4")["correct"]


def test_cs_altered_answer(tiny, monkeypatch):
    kind = _kind(tiny, "knee3d_cs_r4")
    solve = kind.fista_cs_mri
    monkeypatch.setattr(kind, "fista_cs_mri", lambda *a, **k: _alter(solve(*a, **k)))
    assert not run_tiny(*tiny, "knee3d_cs_r4")["correct"]


def test_coil_unchanged_state(tiny, monkeypatch):
    seen = {}
    dec = NDDWT.dec_batched

    def remember(self, x, level):
        seen["x"] = x
        return dec(self, x, level)

    monkeypatch.setattr(NDDWT, "dec_batched", remember)
    monkeypatch.setattr(NDDWT, "rec_batched", lambda self, y: seen["x"].clone())
    assert not run_tiny(*tiny, "knee2d_mc_coilwise")["correct"]


def test_coil_half_batch_left_out(tiny, monkeypatch):
    dec = NDDWT.dec_batched

    def half(self, x, level):
        y = dec(self, x[: x.shape[0] // 2 + 1], level)
        rest = y[-1:].expand((x.shape[0] - y.shape[0],) + tuple(y.shape[1:]))
        return torch.cat([y, rest])  # the rest stand in for the coils left out

    monkeypatch.setattr(NDDWT, "dec_batched", half)
    assert not run_tiny(*tiny, "knee2d_mc_coilwise")["correct"]


def test_coil_altered_answer(tiny, monkeypatch):
    rec = NDDWT.rec_batched
    monkeypatch.setattr(NDDWT, "rec_batched", lambda self, y: _alter(rec(self, y)))
    assert not run_tiny(*tiny, "knee2d_mc_coilwise")["correct"]


def test_denoise_unchanged_state(tiny, monkeypatch):
    monkeypatch.setattr(NDDWT, "dec_rec", lambda self, x, level, threshold=0.0,
                        band_axis=-1: (None, x.clone()))
    assert not run_tiny(*tiny, "knee3d_denoise")["correct"]


def test_denoise_altered_answer(tiny, monkeypatch):
    dec_rec = NDDWT.dec_rec

    def altered(self, *a, **k):
        y, x = dec_rec(self, *a, **k)
        return y, _alter(x)

    monkeypatch.setattr(NDDWT, "dec_rec", altered)
    assert not run_tiny(*tiny, "knee3d_denoise")["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(tiny, workload):
    """The control (the reference in bfloat16, or the program's own
    bfloat16 path) read as a run reads the program."""
    bench, root = tiny
    c = harness.resolve(bench, workload, root)
    _, state, sync, _ = harness.prepare(c, 424242, "cpu")
    w = harness.run_window(c.kind, state, 0.2, c.traffic["sync"] == "unit",
                           harness.Spans(), sync, c.traffic["check_samples"],
                           random.Random(1))
    got = harness.compare(c.kind, state, w.kept, control=True)
    limit = c.limits["err_max"]["limit"]
    assert got["err_max"] <= limit < got["control_err_max"]


def test_no_card_no_result(tmp_path):
    """``run.py`` on a machine without a card exits non-zero and prints no
    result line."""
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['run.py', '--workload', 'knee3d_denoise', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']; "
            f"runpy.run_path({str(ROOT / 'nddwt_bench' / 'run.py')!r}, run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout.strip() or "x")


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tiny, cuda):
    """The harness drives the port's kernels at the tiny sizes."""
    bench, root = tiny
    for workload in CELLS:
        line, _ = harness.run_cell(bench, workload, 99, 0.3, False, cuda, root=root)
        assert line["correct"] and line["device"]["platform"] == "gpu"
