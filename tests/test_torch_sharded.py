"""The port's ``ShardedNDDWT`` (``parallel/sharded.py``) on the CPU, with
gloo across spawned processes, against the JAX package's ``ShardedNDDWT``
(``use_pallas=False``: its XLA bodies) on the 8-device virtual CPU mesh of
``tests/conftest.py`` and against the float64 oracle.

A module-scoped fixture spawns four ranks once (``_torch_sharded_worker``,
which imports no JAX: spawned children re-import what they run) and hands
them every case; rank 0 writes each case's gathered result to a file as
the case finishes, and each test reads its own while the ranks go on. A
case needing fewer ranks runs on a mesh of the first ones. The inputs are
made from each case's seed with NumPy, on both sides. The port runs both
kinds of body: the plain bodies (the direct path's passes over exchanged
halos) and, with ``use_pallas=True``, the kernel bodies, whose kernel
wrappers run their plain versions on the CPU (the halo-padded mode). The
JAX sharded Pallas bodies are not run: their interpret mode aborts at
random (``ROADMAP.md`` queue 3).

The cases are the JAX sharded tests' (``tests/test_sharded.py``), with
meshes of more than four ranks cut to four (the JAX side keeps its own)
and the kernel cases' 128-wide lane axis cut to 16 (neither the port's
kernels nor the JAX XLA bodies need it). Tolerances, relative to
max|reference|: float32 1e-5 for bands and 1e-4 for reconstructions,
float64 1e-12, the float64 solvers 1e-10.
"""

import os
import tempfile
import time
import zlib

import numpy as np
import pytest
import torch

import _torch_sharded_worker as worker

torch.set_num_threads(1)

RANKS = 4
F64 = "float64"
F32 = "float32"


def _case(kind, cid, shape, wv, spec, mesh, **kw):
    """A case; its seed ignores the body suffix (``-k``, ``-p``), so that
    the two bodies of one case take the same inputs."""
    key = cid.removesuffix("-k").removesuffix("-p")
    return dict(kind=kind, id=cid, shape=shape, wv=wv, spec=spec, mesh=mesh,
                seed=zlib.crc32(key.encode()), **kw)


# test_sharded_matches_oracle (tests/test_sharded.py:21-30): the port on at
# most 4 ranks, the JAX side on its own mesh; both normalisations, both
# kinds of body (1D has no kernel body).
ORACLE_BASE = [
    ("1d", (64,), "db4", ("x",), {"x": 4}, {"x": 8}),
    ("2d2", (32, 24), ("db2", "db3"), ("x", "y"), {"x": 2, "y": 2}, {"x": 4, "y": 2}),
    ("2d1", (32, 24), "db2", ("x", None), {"x": 4}, {"x": 8}),
    ("3d", (16, 16, 12), "db2", ("x", "y", None), {"x": 2, "y": 2}, {"x": 2, "y": 2}),
    ("4d", (16, 8, 6, 6), "db1", ("x", None, None, None), {"x": 4}, {"x": 4}),
]
ORACLE_CASES = [
    _case("transform", f"oracle-{name}-pl2{pl2}-{'k' if up else 'p'}", shape, wv,
          spec, mesh, jax_mesh=jmesh, pl2=pl2, dtype=F64, use_pallas=up, level=2)
    for name, shape, wv, spec, mesh, jmesh in ORACLE_BASE
    for pl2 in (False, True)
    for up in ((False,) if len(shape) == 1 else (False, True))
]
# The kernel-body cases (tests/test_sharded.py:155-181, 209-220): float32,
# the kernel bodies; mesh axes of size 1 (wrap, no exchange) and 2.
KERNEL_CASES = [
    _case("transform", f"kernel-{i}", shape, wv, spec, mesh, pl2=bool(i % 2),
          dtype=F32, use_pallas=True, level=level)
    for i, (shape, wv, spec, mesh, level) in enumerate([
        ((64, 32), "db4", ("x", None), {"x": 4}, 2),
        ((32, 32, 16), ("db2", "db3", "db4"), ("x", "y", None), {"x": 2, "y": 2}, 2),
        ((16, 16, 16), "db1", ("x", None, None), {"x": 2}, 3),
        ((16, 32, 16), "db4", (None, "y", None), {"y": 2}, 2),
        ((64, 32, 16), "db4", ("x", None, None), {"x": 2}, 2),
        ((64, 64, 16), "db2", ("x", "y", None), {"x": 2, "y": 2}, 2),
        ((96, 32, 24), "db10", ("x", None, None), {"x": 4}, 1),
        ((32, 32, 16), "db4", ("x", None, None), {"x": 1}, 3),
        ((32, 32, 16), "db2", ("x", "y", None), {"x": 1, "y": 1}, 2),
        ((32, 32, 16), "db2", ("x", "y", None), {"x": 2, "y": 1}, 2),
        ((16, 16, 8, 16), "db2", ("x", "y", None, None), {"x": 2, "y": 2}, 2),
        ((32, 16, 4, 32), "db1", ("x", None, None, None), {"x": 4}, 2),
        ((64, 16, 4, 32), "db2", ("x", None, None, None), {"x": 2}, 2),
        ((32, 16, 4, 32), "db2", ("x", None, None, None), {"x": 1}, 2),
        # 3D filters too long for the level kernels: the stage kernels
        ((40, 40, 32), "db15", ("x", "y", None), {"x": 2, "y": 2}, 1),
    ])
]
# The kernel cases also held against the JAX XLA body (the oracle holds
# every case; a JAX sharded program takes seconds to compile): two sharded
# axes with their corners, a size-1 axis beside a sharded one, 4D X and Y.
JAX_KERNEL_CASES = {"kernel-1", "kernel-5", "kernel-9", "kernel-10"}
COMPLEX_CASES = [
    _case("transform", "complex-1d", (48,), "db3", ("x",), {"x": 4}, complex=True,
          level=3),
    _case("transform", "complex-3d-k", (16, 16, 12), "db2", ("x", "y", None),
          {"x": 2, "y": 2}, complex=True, use_pallas=True, level=2),
    _case("transform", "complex-4d-k", (16, 8, 6, 6), "db2", ("x", "y", None, None),
          {"x": 2, "y": 2}, complex=True, use_pallas=True, level=1),
]
# batch_spec: the multi-chip dry run's mesh ({"data": 2, "x": 2}, db4,
# (8 x, 16, 12), batch 2 data) and test_batch_spec_composes_with_spatial's.
BATCH_CASES = [
    _case("transform", f"batch-{name}-{'k' if up else 'p'}", shape, wv, spec,
          {"data": 2, "x": 2}, jax_mesh=jmesh, batch_spec=("data",), batch=4,
          pl2=pl2, dtype=dt, use_pallas=up, level=2)
    for name, shape, wv, spec, jmesh, pl2, dt in [
        ("dryrun", (16, 16, 12), "db4", ("x", None, None), {"data": 2, "x": 2}, True, F32),
        ("spatial", (32, 16), "db2", ("x", None), {"data": 2, "x": 4}, False, F64),
    ]
    for up in (False, True)
]
SPLIT_CASES = [
    _case("split", "split-p", (32, 16), "db2", ("x", None), {"x": 4}, split=True,
          jax_mesh={"x": 4}, dtype=F64, use_pallas=False, level=2),
    _case("split", "split-k2", (64, 32), "db4", ("x", None), {"x": 4}, split=True,
          jax_mesh={"x": 4}, dtype=F32, use_pallas=True, level=2),
    _case("split", "split-k3", (32, 32, 16), ("db2", "db3", "db4"), ("x", "y", None),
          {"x": 2, "y": 2}, split=True, dtype=F32, use_pallas=True, level=2),
    _case("dec_rec_split", "drsplit-p", (32, 24), "db3", ("x", None), {"x": 2},
          split=True, pl2=True, dtype=F64, use_pallas=False, threshold=0.3, level=2),
    _case("dec_rec_split", "drsplit-k", (32, 16, 16), "db3", ("x", None, None),
          {"x": 2}, split=True, pl2=True, dtype=F32, use_pallas=True, threshold=0.3,
          level=2),
]
DEC_REC_CASES = [
    _case("dec_rec", f"decrec-{thr}-{'k' if up else 'p'}", (32, 24), "db2",
          ("x", None), {"x": 4}, pl2=True, dtype=F64, use_pallas=up, threshold=thr,
          level=2)
    for thr in (0.0, 0.1) for up in (False, True)
] + [
    _case("dec_rec", "decrec-fused-shrink", (64, 32, 16), "db4", ("x", None, None),
          {"x": 2}, pl2=True, dtype=F32, use_pallas=True, threshold=0.3, level=2),
]
# tests/test_sharded.py:427-438, both thresholds.
STREAMED_CASES = [
    _case("streamed", f"streamed-{name}-{thr}", shape, wv, spec, mesh, dtype=dt,
          use_pallas=up, threshold=thr, level=level)
    for name, shape, wv, spec, mesh, level, up, dt in [
        ("3d-p", (16, 16, 12), "db2", ("x", "y", None), {"x": 2, "y": 2}, 2, False, F64),
        ("4d-p", (16, 8, 6, 6), "db1", ("x", None, None, None), {"x": 4}, 2, False, F64),
        ("3d-k", (32, 32, 16), "db4", ("x", None, None), {"x": 2}, 3, True, F32),
        ("4d-k", (16, 16, 8, 16), "db2", ("x", "y", None, None), {"x": 2, "y": 2}, 2,
         True, F32),
    ]
    for thr in (0.0, 0.1)
]
FISTA_CASES = [
    _case(kind, f"{kind}-{'k' if up else 'p'}", (32, 32), "db2", ("x", None), {"x": 4},
          pl2=True, dtype=F64, use_pallas=up, lam=0.05, iters=10, level=2,
          split=kind == "fista_split")
    for kind in ("fista", "fista_split") for up in (False, True)
]
MEMORY_CASES = [
    _case("memory", "memory-local", (64, 64, 64, 32), "db4", ("x", None, None, None),
          {"x": 1}, dtype=F32, use_pallas=False, level=3),
    _case("memory", "memory-sharded", (64, 64, 64, 32), "db4", ("x", None, None, None),
          {"x": 2}, dtype=F32, use_pallas=False, level=3),
]
HALF_CASES = [  # tests/test_sharded.py:241-260: a block of K//2 rows
    _case("transform", f"half-{'k' if up else 'p'}", (16, 16), "db4", ("x", None),
          {"x": 4}, dtype=F64, use_pallas=up, level=2)
    for up in (False, True)
]
ERROR_CASE = _case("errors", "errors", (32, 16), "db2", ("x", None), {"x": 4})
CONVERT_CASE = _case("convert", "convert", (16, 16, 12), "db2", ("x", "y", None),
                     {"x": 2, "y": 2}, pl2=True, dtype=F64, level=2)
ERRORS = {  # label: (port's exception, JAX's for the same call or None)
    "not_divisible": "ValueError", "bogus_axis": "ValueError",
    "halo_too_big": "ValueError", "spec_arity": "ValueError",
    "axis_twice": "ValueError", "pallas_1d": "ValueError",
    "pallas_4d_z": "ValueError", "split_batch": "ValueError",
    "mesh_too_big": "ValueError", "cs_mri": "NotImplementedError",
    "cuda_1d": "NotImplementedError", "cuda_4d_z": "NotImplementedError",
}


def _convert_case():
    import non_decimated_wavelets_tpu as nw

    c = dict(CONVERT_CASE)
    jplan = nw.NDDWT(wavelet=c["wv"], shape=c["shape"], preserve_l2=True, dtype="double")
    c["config"] = jplan.to_config()
    c["taps_hp"] = [np.asarray(t) for t in jplan.taps_hp]
    return c


ALL_CASES = (ORACLE_CASES + KERNEL_CASES + COMPLEX_CASES + BATCH_CASES + SPLIT_CASES
             + DEC_REC_CASES + STREAMED_CASES + FISTA_CASES + MEMORY_CASES
             + HALF_CASES + [ERROR_CASE])


class _Ranks:
    """The four spawned ranks and the files their rank 0 writes."""

    def __init__(self, cases):
        self.dir = tempfile.mkdtemp(prefix="nddwt_sharded_")
        init = f"file://{os.path.join(self.dir, 'init')}"
        self.ctx = torch.multiprocessing.start_processes(
            worker.main, args=(RANKS, init, cases, self.dir), nprocs=RANKS,
            join=False, start_method="spawn")

    def result(self, cid, timeout=600.0):
        path = os.path.join(self.dir, f"{cid}.pt")
        end = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > end:
                pytest.fail(f"no result for {cid} within {timeout} s")
            if all(not p.is_alive() for p in self.ctx.processes):
                if os.path.exists(path):
                    break
                pytest.fail(f"the ranks exited without a result for {cid}: exit codes "
                            f"{[p.exitcode for p in self.ctx.processes]}")
            time.sleep(0.02)
        r = torch.load(path, weights_only=False)
        if isinstance(r, dict) and "error" in r:
            pytest.fail(f"case {cid} failed on rank 0:\n{r['error']}")
        return r

    def close(self):
        for p in self.ctx.processes:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()


@pytest.fixture(scope="module")
def ranks():
    r = _Ranks(ALL_CASES + [_convert_case()])
    yield r
    r.close()


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu import models, oracle
    from non_decimated_wavelets_tpu.parallel import ShardedNDDWT, make_mesh

    import types

    return types.SimpleNamespace(jax=jax, jnp=jnp, nw=nw, models=models, oracle=oracle,
                                 ShardedNDDWT=ShardedNDDWT, make_mesh=make_mesh)


def _close(got, want, rel):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _tols(case):
    """(bands, reconstruction) tolerances relative to max|reference|."""
    return (1e-12, 1e-12) if case.get("dtype", F64) == F64 or case.get("complex") \
        else (1e-5, 1e-4)


def _jax_sharded(jx, case, use_pallas=False):
    jplan = jx.nw.NDDWT(wavelet=case["wv"], shape=case["shape"],
                        preserve_l2=case.get("pl2", False),
                        dtype="double" if case.get("dtype", F64) == F64 else jx.jnp.float32)
    mesh = jx.make_mesh(case.get("jax_mesh", case["mesh"]))
    return jx.ShardedNDDWT(jplan, mesh, case["spec"], case.get("batch_spec", ()),
                           use_pallas=use_pallas)


_jax_results = {}


def _jax_transform(jx, case):
    """The JAX XLA body's bands and reconstruction of a case; cases that
    differ only in the port's body share one run."""
    key = case["id"].removesuffix("-k").removesuffix("-p")
    if key not in _jax_results:
        sh = _jax_sharded(jx, case)
        x = worker.inputs(case)["x"]
        xs = jx.jax.device_put(jx.jnp.asarray(x), sh.x_sharding)
        y = sh.dec(xs, case["level"])
        _jax_results[key] = np.asarray(y), np.asarray(sh.rec(y))
    return _jax_results[key]


def _gold(jx, case, x):
    """The float64 oracle's band-first bands of ``x`` (items on axis 1)."""
    lead = x.ndim - len(case["shape"])
    x = np.asarray(x, np.complex128 if np.iscomplexobj(x) else np.float64)
    if lead:
        return np.stack([_gold(jx, case, v) for v in x], axis=1)
    return np.moveaxis(jx.oracle.dec(x, case["wv"], case["level"],
                                     preserve_l2=case.get("pl2", False)), -1, 0)


@pytest.mark.parametrize("case", ORACLE_CASES + KERNEL_CASES + COMPLEX_CASES
                         + BATCH_CASES + HALF_CASES, ids=lambda c: c["id"])
def test_sharded_transform_matches_jax_and_oracle(ranks, jx, case):
    """``dec``/``rec`` through ``shard_input``/``gather`` against the JAX
    XLA body and the float64 oracle; the kernel cases take the kernel
    bodies."""
    band_tol, rec_tol = _tols(case)
    x = worker.inputs(case)["x"]
    gold = _gold(jx, case, x)
    yj = xj = None
    if not case["id"].startswith("kernel-") or case["id"] in JAX_KERNEL_CASES:
        yj, xj = _jax_transform(jx, case)
    r = ranks.result(case["id"])
    assert r["use_pallas"] == bool(case.get("use_pallas", False))
    _close(r["y"], gold, band_tol)
    _close(r["xr"], x, rec_tol)
    if yj is not None:
        _close(r["y"], yj, band_tol)
        _close(r["xr"], xj, rec_tol)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c["id"])
def test_sharded_split_matches_complex(ranks, jx, case):
    """``dec_split``/``rec_split`` against the oracle's complex transform,
    and ``dec_rec_split`` against complex dec + complex soft-threshold +
    rec; the JAX XLA body's split transform where the JAX test has one."""
    band_tol, rec_tol = _tols(case)
    pair = worker.inputs(case)["x"]
    xc = pair[0].astype(np.float64) + 1j * pair[1].astype(np.float64)
    gold = _gold(jx, case, xc)
    if case["kind"] == "dec_rec_split":
        mag = np.abs(gold[1:])
        gold = np.concatenate(
            [gold[:1], gold[1:] * np.maximum(mag - case["threshold"], 0.0)
             / np.maximum(mag, 1e-30)])
        xc = jx.oracle.rec(np.moveaxis(gold, 0, -1), case["wv"],
                           preserve_l2=case.get("pl2", False))
    yj = None
    if case.get("jax_mesh"):
        sh = _jax_sharded(jx, case)
        ps = sh.shard_input_split(jx.jnp.asarray(pair))
        yj = np.asarray(sh.dec_split(ps, case["level"]))
    r = ranks.result(case["id"])
    _close(r["y"][0] + 1j * r["y"][1], gold, band_tol)
    _close(r["xr"][0] + 1j * r["xr"][1], xc, rec_tol)
    if yj is not None:
        _close(r["y"], yj, band_tol)


@pytest.mark.parametrize("case", DEC_REC_CASES, ids=lambda c: c["id"])
def test_sharded_dec_rec(ranks, jx, case):
    """The fused iterate against JAX ``ShardedNDDWT.dec_rec`` (XLA body)
    and against the oracle's dec + shrink + rec; on the kernel bodies the
    shrink rides the analysis."""
    band_tol, rec_tol = _tols(case)
    x = worker.inputs(case)["x"]
    thr = case["threshold"]
    gold = _gold(jx, case, x)
    mag = np.abs(gold[1:])
    gold = np.concatenate(
        [gold[:1], gold[1:] * np.maximum(mag - thr, 0.0) / np.maximum(mag, 1e-30)])
    xref = jx.oracle.rec(np.moveaxis(gold, 0, -1), case["wv"], preserve_l2=True)
    r = ranks.result(case["id"])
    _close(r["y"], gold, band_tol)
    _close(r["xr"], xref, rec_tol)
    if case["dtype"] == F64:
        sh = _jax_sharded(jx, {**case, "jax_mesh": {"x": 4}})
        yj, xj = sh.dec_rec(sh.shard_input(jx.jnp.asarray(x)), case["level"], thr)
        _close(r["y"], np.asarray(yj), band_tol)
        _close(r["xr"], np.asarray(xj), rec_tol)


@pytest.mark.parametrize("case", STREAMED_CASES, ids=lambda c: c["id"])
def test_sharded_streamed_matches_classic(ranks, jx, case):
    """The level-streamed iterate equals the classic ``dec_rec`` (and, at
    threshold 0, the input); the float64 plain cases also equal the JAX
    streamed iterate."""
    tol = 1e-12 if case["dtype"] == F64 else 1e-5
    x = worker.inputs(case)["x"]
    r = ranks.result(case["id"])
    _close(r["xs"], r["xc"], tol)
    if not case["threshold"]:
        _close(r["xs"], x, max(tol, 1e-12 if case["dtype"] == F64 else 1e-5))
    if case["dtype"] == F64:
        sh = _jax_sharded(jx, case)
        xj = sh.dec_rec_streamed(sh.shard_input(jx.jnp.asarray(x)), case["level"],
                                 case["threshold"])
        _close(r["xs"], np.asarray(xj), tol)


@pytest.mark.parametrize("case", FISTA_CASES, ids=lambda c: c["id"])
def test_sharded_fista_matches_jax(ranks, jx, case):
    """``fista_inpaint`` and ``fista_inpaint_split`` on a sharded transform
    (this rank's blocks in and out) against the JAX solvers on a JAX
    ``ShardedNDDWT``, float64, 1e-10."""
    data = worker.inputs(case)
    x, mask = data["x"], data["mask"]
    sh = _jax_sharded(jx, case)
    m = jx.jnp.asarray(mask)
    if case["kind"] == "fista":
        want = jx.models.fista_inpaint(sh, sh.shard_input(jx.jnp.asarray(mask * x)), m,
                                       case["lam"], level=2, iters=case["iters"])
    else:
        want = jx.models.fista_inpaint_split(
            sh, sh.shard_input_split(jx.jnp.asarray(mask[None] * x)), m, case["lam"],
            level=2, iters=case["iters"])
    r = ranks.result(case["id"])
    _close(r["x"], np.asarray(want), 1e-10)


@pytest.mark.parametrize("case", MEMORY_CASES, ids=lambda c: c["id"])
def test_peak_memory_model(ranks, jx, case):
    """The JAX model's keys, and its numbers where nothing is exchanged
    (no halo-padded copies); a sharded block counts its padded copies."""
    r = ranks.result(case["id"])["model"]
    sh = _jax_sharded(jx, {**case, "jax_mesh": case["mesh"]})
    want = sh.peak_memory_model(case["level"])
    assert set(want) <= set(r)
    if case["mesh"]["x"] == 1:
        assert r["halo_factor"] == 1.0
        assert {k: r[k] for k in want} == want
    else:
        vox = r["local_voxels"]
        assert vox == want["local_voxels"] and r["halo_factor"] == (32 + 7) / 32
        assert r["full_band_layout_bytes"] > want["full_band_layout_bytes"]
        assert r["full_band_layout_bytes"] == int((46 + 2 + 4 + 47 * 39 / 32) * vox * 4)


@pytest.mark.parametrize("label", sorted(ERRORS))
def test_sharded_validation_errors(ranks, jx, label):
    """The JAX validation cases (tests/test_sharded.py:75-88) raise the
    same exception type, and the port's own refusals raise theirs: the
    kernel bodies asked for where the spec does not allow them, the split
    forms with batch axes, a mesh larger than the group, the
    masked-Fourier solver (no sharded FFT yet), and the specs that a CUDA
    tensor cannot take (1D; 4D with Z sharded), shown on a stand-in
    tensor that reports itself on the card."""
    got = ranks.result("errors")[label]
    assert got == ERRORS[label]
    jax_calls = {
        "not_divisible": lambda m: jx.ShardedNDDWT(
            jx.nw.NDDWT(wavelet="db2", shape=(30, 16), dtype="double"), m, ("x", None)),
        "bogus_axis": lambda m: jx.ShardedNDDWT(
            jx.nw.NDDWT(wavelet="db2", shape=(32, 16), dtype="double"), m, ("bogus", None)),
        "halo_too_big": lambda m: jx.ShardedNDDWT(
            jx.nw.NDDWT(wavelet="db10", shape=(32, 32), dtype="double"), m, ("x", None)),
        "spec_arity": lambda m: jx.ShardedNDDWT(
            jx.nw.NDDWT(wavelet="db2", shape=(32, 16), dtype="double"), m, ("x",)),
        "split_batch": lambda m: jx.ShardedNDDWT(
            jx.nw.NDDWT(wavelet="db2", shape=(32, 16), dtype="double"), m, (None, None),
            batch_spec=("x",)).dec_split_fn(2),
    }
    if label in jax_calls:
        with pytest.raises(Exception) as info:
            jax_calls[label](jx.make_mesh({"x": 4}))
        assert type(info.value).__name__ == got


def test_sharded_from_jax(ranks, jx):
    """A JAX ``ShardedNDDWT``'s plan and partitioning carried across: the
    same spec and blocks, bands equal to the JAX sharded transform's; taps
    that differ in one bit are refused."""
    case = _convert_case()
    sh = _jax_sharded(jx, case)
    x = worker.inputs(case)["x"]
    yj = np.asarray(sh.dec(sh.shard_input(jx.jnp.asarray(x)), case["level"]))
    r = ranks.result("convert")
    assert r["spec"] == tuple(sh.spec) and r["local_shape"] == sh._local_shape
    assert r["refused"] == "ValueError"
    _close(r["y"], yj, 1e-12)
