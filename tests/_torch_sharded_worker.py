"""Rank worker of ``tests/test_torch_sharded.py``: runs the port's
``ShardedNDDWT`` cases on one rank of a gloo process group on the CPU.

``main(rank, world, init, cases, out_dir)`` joins the group and runs every
case in order, each case on a mesh of the first ranks (the others wait at
its mesh's construction, which every rank joins). Rank 0 gathers each
case's result (``ShardedNDDWT.gather``) and writes it to
``out_dir/<id>.pt``; a case that fails writes its traceback instead.
``inputs`` makes a case's global inputs from its seed with NumPy; the test
module calls it too, for the JAX side. This module imports torch, NumPy and
the port only: spawned ranks import it, and the test module imports JAX.
"""

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist


def inputs(case):
    """The case's global inputs, from its seed: ``x`` (with the batch axis
    in front for a batch case; complex for a complex case; a re/im pair
    for a split case) and, for a solver, the mask."""
    rng = np.random.default_rng(case["seed"])
    shape = tuple(case["shape"])
    lead = (case["batch"],) if case.get("batch") else ()
    if case.get("split"):
        lead = (2,)
    x = rng.standard_normal(lead + shape)
    if case.get("complex"):
        x = x + 1j * rng.standard_normal(lead + shape)
    else:
        x = x.astype(case.get("dtype", "float64"))
    out = {"x": x}
    if case["kind"].startswith("fista"):
        out["mask"] = (rng.random(shape) < 0.6).astype(x.dtype)
    return out


class _OnCard(torch.Tensor):
    """A CPU tensor that the port takes for a CUDA one (no card here)."""

    @property
    def is_cuda(self):
        return True


def _plan(case):
    import non_decimated_wavelets_tpu_torch as tw

    return tw.NDDWT(case["wv"], tuple(case["shape"]), preserve_l2=case.get("pl2", False),
                    dtype=case.get("dtype", "float64"), device="cpu")


def _sharded(case, mesh):
    from non_decimated_wavelets_tpu_torch.parallel import ShardedNDDWT

    return ShardedNDDWT(_plan(case), mesh, tuple(case["spec"]),
                        tuple(case.get("batch_spec", ())),
                        use_pallas=case.get("use_pallas", "auto"))


def _errors(mesh4):
    """The validation cases: ``{label: exception type name or None}``."""
    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.models import fista_cs_mri
    from non_decimated_wavelets_tpu_torch.parallel import ShardedNDDWT, make_mesh

    plan = tw.NDDWT("db2", (32, 16), dtype="float64", device="cpu")
    on_card = lambda t: t.as_subclass(_OnCard)  # noqa: E731
    cases = {
        "not_divisible": lambda: ShardedNDDWT(
            tw.NDDWT("db2", (30, 16), dtype="float64", device="cpu"), mesh4, ("x", None)),
        "bogus_axis": lambda: ShardedNDDWT(plan, mesh4, ("bogus", None)),
        "halo_too_big": lambda: ShardedNDDWT(
            tw.NDDWT("db10", (32, 32), dtype="float64", device="cpu"), mesh4, ("x", None)),
        "spec_arity": lambda: ShardedNDDWT(plan, mesh4, ("x",)),
        "axis_twice": lambda: ShardedNDDWT(plan, mesh4, ("x", "x")),
        "pallas_1d": lambda: ShardedNDDWT(
            tw.NDDWT("db2", (32,), device="cpu"), mesh4, ("x",), use_pallas=True),
        "pallas_4d_z": lambda: ShardedNDDWT(
            tw.NDDWT("db1", (8, 8, 8, 4), device="cpu"), mesh4, (None, None, "x", None),
            use_pallas=True),
        "split_batch": lambda: ShardedNDDWT(
            plan, mesh4, (None, None), batch_spec=("x",)).dec_split(
                np.zeros((2, 32, 16)), 2),
        "mesh_too_big": lambda: make_mesh({"x": 8}, "cpu"),
        "cs_mri": lambda: fista_cs_mri(
            ShardedNDDWT(plan, mesh4, ("x", None)), np.zeros((8, 16)),
            np.ones((8, 16)), 0.1),
        "cuda_1d": lambda: ShardedNDDWT(
            tw.NDDWT("db2", (32,), device="cpu"), mesh4, ("x",)).dec(
                on_card(torch.zeros(8, dtype=torch.float64)), 1),
        "cuda_4d_z": lambda: ShardedNDDWT(
            tw.NDDWT("db1", (8, 8, 8, 4), device="cpu"), mesh4,
            (None, None, "x", None)).dec(on_card(torch.zeros(8, 8, 2, 4)), 1),
    }
    got = {}
    for label, fn in cases.items():
        try:
            fn()
            got[label] = None
        except Exception as e:  # the type is what the test holds
            got[label] = type(e).__name__
    return got


def _run(case, sh, data):
    """The case's port results on this rank, gathered (numpy arrays)."""
    from non_decimated_wavelets_tpu_torch.models import fista_inpaint, fista_inpaint_split

    kind, level = case["kind"], case.get("level", 2)
    thr = case.get("threshold", 0.0)
    g = lambda t: sh.gather(t).numpy()  # noqa: E731
    if kind == "transform":
        y = sh.dec(sh.shard_input(data["x"]), level)
        return {"y": g(y), "xr": g(sh.rec(y)), "use_pallas": sh.use_pallas}
    if kind == "dec_rec":
        y, xr = sh.dec_rec(sh.shard_input(data["x"]), level, thr)
        return {"y": g(y), "xr": g(xr)}
    if kind == "streamed":
        xs = sh.shard_input(data["x"])
        return {"xs": g(sh.dec_rec_streamed(xs, level, thr)),
                "xc": g(sh.dec_rec(xs, level, thr)[1])}
    if kind == "split":
        y = sh.dec_split(sh.shard_input_split(data["x"]), level)
        return {"y": g(y), "xr": g(sh.rec_split(y))}
    if kind == "dec_rec_split":
        y, xr = sh.dec_rec_split(sh.shard_input_split(data["x"]), level, thr)
        return {"y": g(y), "xr": g(xr)}
    if kind == "fista":
        out = fista_inpaint(sh, sh.shard_input(data["mask"] * data["x"]),
                            sh.shard_input(data["mask"]), case["lam"], level, case["iters"])
        return {"x": g(out)}
    if kind == "fista_split":
        pair = sh.shard_input_split(data["mask"][None] * data["x"])
        out = fista_inpaint_split(sh, pair, sh.shard_input(data["mask"]), case["lam"],
                                  level, case["iters"])
        return {"x": g(out)}
    if kind == "memory":
        return {"model": sh.peak_memory_model(level)}
    raise ValueError(f"unknown case kind {kind!r}")


def _one(case, rank):
    from non_decimated_wavelets_tpu_torch import convert
    from non_decimated_wavelets_tpu_torch.parallel import make_mesh

    mesh = make_mesh(case["mesh"], "cpu")
    if case["kind"] == "errors":
        return _errors(mesh)
    if mesh.get_coordinate() is None:
        return None
    data = inputs(case)
    if case["kind"] == "convert":
        sh = convert.sharded_from_jax(case["config"], case["taps_hp"], case["spec"],
                                      case.get("batch_spec", ()), mesh, "cpu")
        y = sh.dec(sh.shard_input(data["x"]), case["level"])
        bad = [np.array(t) for t in case["taps_hp"]]
        bad[0][0, 0] += 1e-12
        try:
            convert.sharded_from_jax(case["config"], bad, case["spec"], (), mesh, "cpu")
            refused = None
        except ValueError as e:
            refused = type(e).__name__
        return {"y": sh.gather(y).numpy(), "refused": refused,
                "spec": sh.spec, "local_shape": sh.local_shape}
    return _run(case, _sharded(case, mesh), data)


def main(rank, world, init, cases, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for case in cases:
            try:
                result = _one(case, rank)
            except Exception:
                result = {"error": traceback.format_exc()}
            if rank == 0:
                path = os.path.join(out_dir, f"{case['id']}.pt")
                torch.save(result, path + ".tmp")
                os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()
