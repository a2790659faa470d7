"""The torch port's reference-style classes (``api.py``) and its native CPU
bridge against the JAX package's, on the CPU.

* The six classes against the JAX classes on the same seeded complex
  double data, for ``compute`` in ``'gpu'``, ``'gpu_off'`` and ``'numpy'``
  at ``tests/test_api.py``'s shapes. The port's plans take the kernel route
  (the device check stubbed, so the kernel wrappers run their plain
  versions: the 1D and float64 kernels' contracts), as they would on the
  card; the round trip and the tight-frame energy are held to 1e-12.
* The options, size arity, warnings and row vectors of
  ``tests/test_api.py``, the 4D ``method`` option and the Haar classes.
* The native bridge (``native/cpu_backend.py``) against the JAX package's,
  both loading one library built here from ``native/nddwt_cpu.cpp`` (skips
  without a C++ compiler, as ``tests/test_native.py`` does), and the
  fallback to the plan with a warning when the library is absent.
"""

import subprocess
import sys
import warnings
from functools import partialmethod
from pathlib import Path

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu as nw
from non_decimated_wavelets_tpu.native import cpu_backend as jcb

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import api, oracle
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.native import cpu_backend as tcb
from non_decimated_wavelets_tpu_torch.ops import flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CLASSES = [
    ("nd_dwt_1D", (54,), "db4"),
    ("nd_dwt_2D", (26, 26), ("db1", "db3")),
    ("nd_dwt_3D", (16, 12, 10), ("db1", "db3", "db2")),
    ("nd_dwt_4D", (8, 8, 6, 6), "db2"),
]


@pytest.fixture
def as_cuda(monkeypatch):
    """Route every tensor as if it were on a CUDA device: the plans take
    the kernel route, whose wrappers run their plain versions here."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    # The per-level route at these small shapes: tests/test_torch_flat.py
    # holds the one-launch flat route, tests/test_torch_multi.py the
    # multilevel one.
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("name,shape,wv", CLASSES)
@pytest.mark.parametrize("compute", ["gpu", "gpu_off", "numpy"])
@pytest.mark.parametrize("pl2", [False, True])
def test_classes_match_jax(as_cuda, name, shape, wv, compute, pl2, rng):
    """Round trip and energy (``Test/nddwt1D_test.m:14-76``) at the default
    double precision, and the bands of the JAX class, on complex data."""
    t = getattr(tw, name)(wv, shape, pres_l2_norm=pl2, compute=compute, device="cpu")
    j = getattr(nw, name)(wv, shape, pres_l2_norm=pl2,
                          compute="jax" if compute == "gpu" else compute)
    assert t.precision == "double" and t.f_size == j.f_size
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = t.dec(x, 2)
    xr = t.rec(y)
    if compute == "gpu":
        assert isinstance(y, torch.Tensor) and y.dtype == torch.complex128
    else:
        assert isinstance(y, np.ndarray) and isinstance(xr, np.ndarray)
    np.testing.assert_allclose(_host(y), np.asarray(j.dec(x, 2)), atol=1e-12)
    assert np.max(np.abs(_host(xr) - x)) < 1e-12
    if pl2:
        assert abs(np.linalg.norm(_host(y)) / np.linalg.norm(x) - 1) < 1e-12


@pytest.mark.parametrize("compute", ["gpu", "gpu_off"])
def test_single_precision(as_cuda, compute, rng):
    t = tw.nd_dwt_2D("db2", (32, 32), precision="single", compute=compute, device="cpu")
    x = rng.standard_normal((32, 32)).astype(np.float32)
    y = t.dec(x, 2)
    assert _host(y).dtype == np.float32 and t.plan.real_dtype == torch.float32
    assert np.max(np.abs(_host(t.rec(y)) - x)) < 1e-5


@pytest.mark.parametrize("compute", ["gpu", "gpu_off", "numpy"])
def test_1d_row_vector(compute, rng):
    """(1, N) inputs flatten (Functions/nd_dwt_1D.m:151-153)."""
    t = tw.nd_dwt_1D(["db2"], 40, compute=compute, device="cpu")
    x = rng.standard_normal((1, 40))
    y = t.dec(x, 2)
    assert _host(y).shape == (40, 3)
    np.testing.assert_allclose(_host(y), oracle.dec(x[0], "db2", 2), atol=1e-12)
    yt = t.dec(torch.from_numpy(x), 2) if compute == "gpu" else y
    np.testing.assert_allclose(_host(yt), _host(y), atol=0)


def test_options_and_errors():
    with pytest.warns(UserWarning, match="Unknown optional input"):
        tw.nd_dwt_1D("db1", 16, bogus_option=1, device="cpu")
    with pytest.raises(ValueError):
        tw.nd_dwt_1D("db1", 16, compute="quantum")
    with pytest.raises(ValueError):
        tw.nd_dwt_1D("db1", (16, 16))
    with pytest.raises(ValueError):
        tw.nd_dwt_3D("db1", (16, 16))
    with pytest.raises(ValueError):
        tw.nd_dwt_2D("db4", (4, 32), device="cpu")  # filter longer than the axis
    with pytest.raises(ValueError):
        tw.nd_dwt_2D(("db1", "db2", "db3"), (16, 16), device="cpu")
    with pytest.raises(ValueError):
        tw.harr_nddwt_2D("db4", (16, 16))
    with pytest.raises(ValueError, match="method"):
        tw.nd_dwt_4D("db2", (8, 8, 6, 6), method="wavelet")
    t = tw.nd_dwt_2D(("db2", "db4"), (32, 32), preserve_l2=True, compute="mat",
                     device="cpu")
    assert t.f_size == (4, 8) and t.pres_l2_norm and t.compute == "offload"
    assert t.plan.real_dtype == torch.float64 and t.plan.path == "auto"
    # A class builds its plan on the card unless told otherwise.
    assert tw.nd_dwt_3D("db2", (8, 8, 8)).plan.device.type == "cuda"


def test_paths_each_class_forces():
    """``method`` and the Haar classes' direct stencils force a path only on
    a CPU plan; on the card ``'auto'`` takes the kernels."""
    shape = (8, 8, 6, 6)
    for method, path in (("fft", "fft"), ("conv", "direct"), ("", "auto")):
        assert tw.nd_dwt_4D("db2", shape, method=method, device="cpu").plan.path == path
        assert tw.nd_dwt_4D("db2", shape, method=method).plan.path == "auto"
    for cls, sizes in ((tw.harr_nddwt_2D, (16, 18)), (tw.harr_nddwt_4D, shape)):
        assert cls(sizes=sizes, device="cpu").plan.path == "direct"
        assert cls(sizes=sizes).plan.path == "auto"
    assert tw.nd_dwt_4D("db2", shape, method="fft", path="direct",
                        device="cpu").plan.path == "direct"


@pytest.mark.parametrize("cls,shape", [("harr_nddwt_2D", (16, 18)),
                                       ("harr_nddwt_4D", (8, 6, 6, 4))])
@pytest.mark.parametrize("route", ["cpu", "kernels"])
def test_haar_classes_match_db1(request, cls, shape, route, rng):
    """The Haar classes give the db1 FFT path's bands (the JAX package's
    test) on their CPU stencils and on the kernel route ('auto', as on the
    card)."""
    opts = {}
    if route == "kernels":
        request.getfixturevalue("as_cuda")
        opts["path"] = "auto"
    x = rng.standard_normal(shape)
    th = getattr(tw, cls)(sizes=shape, pres_l2_norm=True, device="cpu", **opts)
    ref = nw.NDDWT(wavelet="db1", shape=shape, preserve_l2=True, dtype="double", path="fft")
    y_h = _host(th.dec(x, 2))
    np.testing.assert_allclose(y_h, np.asarray(ref.dec(x, 2)), atol=1e-12)
    np.testing.assert_allclose(y_h, _host(getattr(nw, cls)(sizes=shape, pres_l2_norm=True)
                                          .dec(x, 2)), atol=1e-12)
    assert np.max(np.abs(_host(th.rec(y_h)) - x)) < 1e-12


def test_4d_methods_match_jax(rng):
    """``method='fft'``/``'conv'`` on a CPU plan against the JAX class."""
    shape = (8, 8, 6, 6)
    x = rng.standard_normal(shape)
    for method in ("fft", "conv"):
        t = tw.nd_dwt_4D("db2", shape, method=method, device="cpu")
        j = nw.nd_dwt_4D("db2", shape, method=method)
        y = _host(t.dec(x, 2))
        np.testing.assert_allclose(y, np.asarray(j.dec(x, 2)), atol=1e-12)
        np.testing.assert_allclose(_host(t.rec(y)), x, atol=1e-12)


def test_native_falls_back_with_a_warning(monkeypatch, rng):
    monkeypatch.setattr(tcb, "available", lambda: False)
    with pytest.warns(UserWarning, match="native CPU backend not built"):
        t = tw.nd_dwt_2D("db2", (16, 16), compute="mex", device="cpu")
    assert t.compute == "jax" and t.plan is not None
    x = rng.standard_normal((16, 16))
    np.testing.assert_allclose(_host(t.dec(x, 2)), oracle.dec(x, "db2", 2), atol=1e-12)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The C++ backend built here into a temporary directory."""
    out = tmp_path_factory.mktemp("native") / "libnddwt_cpu.so"
    try:
        subprocess.run(["g++", "-O3", "-fopenmp", "-fPIC", "-std=c++17", "-shared",
                        "-o", str(out), str(REPO / "native" / "nddwt_cpu.cpp")],
                       check=True, capture_output=True, timeout=120)
    except Exception:
        pytest.skip("no C++ toolchain to build the native backend")
    return out


@pytest.fixture
def bridges(native_lib, monkeypatch):
    """Both bridges on the library built here."""
    monkeypatch.setattr(tcb, "_state", {"lib": None, "tried": False})
    tcb.use_library(native_lib)
    monkeypatch.setattr(jcb, "_CANDIDATES", [str(native_lib)])
    monkeypatch.setattr(jcb, "_LIB", None)
    monkeypatch.setattr(jcb, "_LIB_TRIED", False)
    assert tcb.available() and jcb.available()
    tcb.set_num_threads(1)


@pytest.mark.parametrize("shape,wv,lvl", [((54,), "db4", 3), ((26, 22), ("db2", "db3"), 3),
                                          ((16, 14, 10), ("db1", "db4", "db2"), 2),
                                          ((8, 12, 10, 6), "db2", 2)])
@pytest.mark.parametrize("pl2", [False, True])
def test_native_bridge_matches_jax_bridge(bridges, shape, wv, lvl, pl2, rng):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for v in (x.real.copy(), x):
        y = tcb.dec(v, wv, lvl, pl2)
        np.testing.assert_array_equal(y, jcb.dec(v, wv, lvl, pl2))
        np.testing.assert_allclose(y, oracle.dec(v, wv, lvl, pl2), atol=1e-12)
        xr = tcb.rec(y, wv, pl2)
        np.testing.assert_array_equal(xr, jcb.rec(y, wv, pl2))
        np.testing.assert_allclose(xr, v, atol=1e-12)
    assert tcb.dec(x, wv, lvl, pl2, "single").dtype == np.complex64


def test_native_via_class_api(bridges, rng):
    t = tw.nd_dwt_2D("db2", (24, 24), compute="mex")  # the reference's alias
    assert t.compute == "native"
    j = nw.nd_dwt_2D("db2", (24, 24), compute="mex")
    x = rng.standard_normal((24, 24))
    y = t.dec(x, 2)
    np.testing.assert_array_equal(y, j.dec(x, 2))
    np.testing.assert_allclose(t.rec(y), x, atol=1e-12)


def test_no_jax_in_the_port():
    """The port and its class API import neither JAX nor the JAX package."""
    code = ("import sys, non_decimated_wavelets_tpu_torch as tw;"
            "tw.nd_dwt_1D('db2', 16, device='cpu').dec([0.0] * 16, 1);"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'non_decimated_wavelets_tpu')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
    assert api.NDDWT is tw.NDDWT
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # 'double' needs no downgrade warning
        tw.nd_dwt_3D("db2", (8, 8, 8), device="cpu")
