"""Multi-rank spatial decomposition of the non-decimated DWT, on
``torch.distributed``.

Port of ``non_decimated_wavelets_tpu/parallel/sharded.py``. Spatial axes
of the volume are sharded across the ranks of a
``torch.distributed.device_mesh.DeviceMesh`` (the counterpart of
``jax.sharding.Mesh``), and every K-tap periodic correlation along a
sharded axis reads a constant ``K - 1``-row halo from the ring neighbours
of its mesh dimension: the periodic boundary maps onto the ring, first and
last block linked. The reference's cascade re-filters the full-resolution
approximation with undilated filters at every level, so the halo does not
grow with the level.

SPMD form: every rank calls the same methods with its own block, a plain
tensor, and gets its block of the result back; ``shard_input`` cuts this
rank's block out of a global array and ``gather`` rebuilds the global
array from the blocks (what ``shard_map`` and ``np.asarray`` of a sharded
array do in the JAX package). Band arrays are band-first,
``(B, *batch, *spatial)`` blocks, the band axis never sharded.

The exchange is ``dist.batch_isend_irecv`` on the mesh dimension's group
with the neighbours at mesh coordinate +-1 mod P (the counterpart of
``jax.lax.ppermute`` over ``_ring_perms``). On a gloo group the halo rows of
a CUDA tensor are staged through host memory; on NCCL they go as device
tensors. A mesh dimension of size 1 exchanges nothing: its periodic
neighbour is the block itself.

Two kinds of body compute a rank's part:

* the kernel bodies: per level the approximation's (or the band array's)
  halos are exchanged on the sharded axes, one axis after the other, so
  the corners come from two hops, and the halo-padded mode of the CUDA
  level kernels (``cuda_kernels.dec_level``/``rec_level``) or, in 4D and
  for 3D filters too long for those, of the lead stage kernels
  (``lead_dec``/``lead_adj``) reads them. The lane stage runs locally
  (Z and T are never sharded there), and its output's X/Y halos are
  exchanged before the lead stage. They replace the JAX package's Pallas
  bodies (``sharded.py:338-600``, TPU kernel table row 23). A CUDA tensor
  takes them; a CPU tensor asked to take them (``use_pallas=True``) runs
  the kernels' plain versions.
* the plain bodies, the torch direct path's passes with each sharded axis
  padded by the exchange instead of the circular pad (JAX ``_dec_body``/
  ``_rec_body``): every spec, on the CPU, and on any device when
  ``use_pallas=False`` is asked for explicitly.

On a CUDA tensor, a spec that the kernel bodies cannot serve raises
``NotImplementedError``: 1D, 4D with Z or T sharded, and 3D with Z sharded
where the filters take the stage kernels (``ROADMAP.md`` queue 1 item 14).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..models.denoise import soft_threshold, soft_threshold_mag_pair
from ..ops import cuda_kernels as ck
from ..ops import direct_path, elemwise
from ..oracle import level_from_bands, num_bands
from ..plan import NDDWT, _join, _parts

def make_mesh(axis_sizes: dict, device_type: str = "cuda"):
    """A ``DeviceMesh`` with one named dimension per ``{name: size}`` entry,
    over ranks ``0 .. prod(sizes) - 1`` of the default process group (the
    JAX ``make_mesh`` takes the first devices likewise). Every rank of the
    group calls it; a rank outside the mesh gets a mesh it has no
    coordinate in."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed.init_process_group first"
        )
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    total = math.prod(sizes)
    world = dist.get_world_size()
    if total > world:
        raise ValueError(f"mesh needs {total} ranks, only {world} available")
    return DeviceMesh(device_type, torch.arange(total).reshape(sizes),
                      mesh_dim_names=names)


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class _Ring:
    """One mesh dimension seen from this rank: its group, its size and the
    global ranks of the left and right neighbours."""

    def __init__(self, mesh, name: str):
        dim = mesh.mesh_dim_names.index(name)
        coord = mesh.get_coordinate()
        index = list(coord)
        index[dim] = slice(None)
        line = mesh.mesh[tuple(index)].tolist()
        self.size = len(line)
        self.left = line[(coord[dim] - 1) % self.size]
        self.right = line[(coord[dim] + 1) % self.size]
        self.group = mesh.get_group(name) if self.size > 1 else None


def _exchanged(ring) -> bool:
    """Whether an axis takes halos from other ranks (a mesh dimension of
    size 1 wraps locally)."""
    return ring is not None and ring.size > 1


def _exchange(tail, head, ring):
    """Send ``tail`` to the right neighbour and ``head`` to the left one;
    return (the left neighbour's tail, the right neighbour's head)."""
    device = tail.device
    staged = device.type != "cpu" and dist.get_backend(ring.group) == "gloo"
    if staged:  # gloo moves host tensors: stage the slabs
        tail, head = tail.cpu(), head.cpu()
    tail, head = tail.contiguous(), head.contiguous()
    from_left = torch.empty_like(tail)
    from_right = torch.empty_like(head)
    ops = []
    # Two messages may go to one peer (P = 2): the tags keep them apart,
    # and the order is the same on both sides, as NCCL matches by order.
    if tail.numel():
        ops += [dist.P2POp(dist.isend, tail, ring.right, ring.group, tag=0),
                dist.P2POp(dist.irecv, from_left, ring.left, ring.group, tag=0)]
    if head.numel():
        ops += [dist.P2POp(dist.isend, head, ring.left, ring.group, tag=1),
                dist.P2POp(dist.irecv, from_right, ring.right, ring.group, tag=1)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        from_left, from_right = from_left.to(device), from_right.to(device)
    return from_left, from_right


def _halo_pad(x, axis: int, ring, left_w: int, right_w: int):
    """``x`` with ``left_w`` rows of the left ring neighbour's tail in front
    and ``right_w`` of the right one's head behind, along ``axis`` (JAX
    ``_halo_pad``); a mesh dimension of size 1, or none, wraps locally."""
    if not _exchanged(ring):
        return direct_path._circ_pad(x, axis, left_w, right_w)
    n = x.shape[axis]
    from_left, from_right = _exchange(x.narrow(axis, n - left_w, left_w),
                                      x.narrow(axis, 0, right_w), ring)
    return torch.cat([from_left, x, from_right], dim=axis)


def _pad_axes(arr, rings, halos, lead_off: int):
    """Halo-pad every exchanged axis of ``arr`` (spatial axis ``k`` at
    ``lead_off + k``) by the widths ``halos[k]``, one after the other: the
    second axis's halo is cut from the already padded array, so the
    corners come from the diagonal neighbours by two hops (JAX
    ``_pad_sharded_axes``)."""
    for ax, ring in enumerate(rings):
        if _exchanged(ring):
            arr = _halo_pad(arr, lead_off + ax, ring, *halos[ax])
    return arr


# --------------------------------------------------------------------------
# The plain bodies: the direct path's passes, sharded axes padded by the
# exchange (JAX sharded.py:138-198).
# --------------------------------------------------------------------------


def _level1_dec_sharded(x, taps, rings):
    """``(2^d, *batch, *local)`` bands of one level: every exchanged axis
    of ``x`` halo-padded up front (corners by two hops), then the direct
    path's valid passes there; ``rings[k]`` shards spatial axis ``k``."""
    xp = _pad_axes(x, rings, ck.halo_widths(taps, False), x.ndim - len(taps))
    return direct_path._level1_dec(xp, taps, tuple(map(_exchanged, rings)))


def _level1_rec_sharded(group, taps, rings):
    gp = _pad_axes(group, rings, ck.halo_widths(taps, True),
                   group.ndim - len(taps))
    return direct_path._level1_rec(gp, taps, tuple(map(_exchanged, rings)))


def _dec_body(x, taps, level, rings):
    groups = []
    approx = x
    for _ in range(level):
        bands = _level1_dec_sharded(approx, taps, rings)
        approx = bands[0]
        groups.append(bands[1:])
    return torch.cat([approx.unsqueeze(0)] + groups[::-1], dim=0)


def _rec_body(y, taps, level, preserve_l2, rings):
    nb = 2 ** len(taps)

    def synth(group):
        acc = _level1_rec_sharded(group, taps, rings)
        return acc if preserve_l2 else acc / nb

    acc = synth(y[:nb])
    pos = nb
    for _ in range(1, level):
        acc = synth(torch.cat([acc.unsqueeze(0), y[pos: pos + nb - 1]], dim=0))
        pos += nb - 1
    return acc


def _shrink_details(y, lam):
    return torch.cat([y[:1], soft_threshold(y[1:], lam)]) if lam else y


# --------------------------------------------------------------------------
# The kernel bodies (JAX sharded.py:338-600): halo-padded levels.
# --------------------------------------------------------------------------


def _dec_body_kernels(x, taps, level, rings, lam=0.0):
    """2D/3D analysis of one block: per level the approximation's halos are
    exchanged, then one halo-padded ``nddwt_dec_level`` launch."""
    ndim = x.ndim
    nb, B = 2**ndim, num_bands(ndim, level)
    padded = tuple(_exchanged(r) for r in rings)
    halos = ck.halo_widths(taps, False)
    big = torch.empty((B,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    approx = x.contiguous()
    for lvl in range(level):
        off, final = B - (nb - 1) * (lvl + 1), lvl == level - 1
        approx = ck.dec_level(_pad_axes(approx, rings, halos, 0), big, off,
                              taps, lam, final, padded)
    return big


def _rec_body_kernels(y, taps, level, preserve_l2, rings):
    """2D/3D synthesis of one block: the band array is padded once, the
    running approximation per level; one halo-padded ``nddwt_rec_level``
    launch per level."""
    nb = 2 ** len(taps)
    scale = 1.0 if preserve_l2 else 1.0 / nb
    padded = tuple(_exchanged(r) for r in rings)
    halos = ck.halo_widths(taps, True)
    yp = _pad_axes(y.contiguous(), rings, halos, 1)
    acc = ck.rec_level(yp, None, [("y", b) for b in range(nb)], taps, scale,
                       padded)
    pos = nb
    for _ in range(1, level):
        src = [("a", 0)] + [("y", pos + b - 1) for b in range(1, nb)]
        acc = ck.rec_level(yp, _pad_axes(acc, rings, halos, 0), src, taps,
                           scale, padded)
        pos += nb - 1
    return acc


def _dec_body_stages(x, taps, level, rings, lam=0.0):
    """4D (or long-filter 3D) analysis of one block: per level a local lane
    stage, its output's X/Y halos exchanged, one halo-padded
    ``nddwt_lead_dec`` launch."""
    ndim = x.ndim
    nb, B = 2**ndim, num_bands(ndim, level)
    lead = rings[:2]
    padded = tuple(_exchanged(r) for r in lead)
    halos = ck.halo_widths(taps[:2], False)
    big = torch.empty((B,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    approx = x.contiguous()
    for lvl in range(level):
        off, final = B - (nb - 1) * (lvl + 1), lvl == level - 1
        temp = _pad_axes(ck.lane_dec(approx, taps), lead, halos, 1)
        approx = ck.lead_dec(temp, big, off, taps, lam, final, padded)
    return big


def _rec_body_stages(y, taps, level, preserve_l2, rings):
    """4D (or long-filter 3D) synthesis of one block: the band array's X/Y
    halos padded once, the running approximation's per level; one
    halo-padded ``nddwt_lead_adj`` and one local ``nddwt_lane_adj`` launch
    per level."""
    nb = 2 ** len(taps)
    scale = 1.0 if preserve_l2 else 1.0 / nb
    lead = rings[:2]
    padded = tuple(_exchanged(r) for r in lead)
    halos = ck.halo_widths(taps[:2], True)
    yp = _pad_axes(y.contiguous(), lead, halos, 1)
    src = [("y", b) for b in range(nb)]
    acc = ck.lane_adj(ck.lead_adj(yp, None, src, taps, padded), taps, scale)
    pos = nb
    for _ in range(1, level):
        src = [("a", 0)] + [("y", pos + b - 1) for b in range(1, nb)]
        partial = ck.lead_adj(yp, _pad_axes(acc, lead, halos, 0), src, taps,
                              padded)
        acc = ck.lane_adj(partial, taps, scale)
        pos += nb - 1
    return acc


def _streamed_pair(x, dec_approx, dec_full, rec1, level):
    """Level-streamed iterate dec -> shrink(details) -> rec that never holds
    the whole ``(B, *local)`` band array (JAX ``_streamed_pair``): going
    down only the running approximations are kept (``dec_approx``); going
    up each level's bands are computed again (``dec_full``, shrunk) and
    synthesised at once (``rec1``). Peak band memory is one level's
    ``2^d`` plus the ``level`` approximations, at one extra analysis per
    level above the deepest."""

    def go(a, lvl):
        if lvl == level - 1:
            bands = dec_full(a)
            deep = bands[0]
        else:
            deep = go(dec_approx(a), lvl + 1)
            bands = dec_full(a)
        return rec1(torch.cat([deep.unsqueeze(0), bands[1:]], dim=0))

    return go(x, 0)


class ShardedNDDWT:
    """A plan bound to a mesh and a spatial partitioning.

    ``spec`` maps each spatial axis to a mesh dimension's name or ``None``
    (local), e.g. ``('x', 'y', None)`` for a 3D volume over a 2D mesh;
    ``batch_spec`` names the mesh dimensions of leading batch axes. Every
    method takes and returns this rank's block (``shard_input``,
    ``gather``). Extents must divide evenly, and a block must hold the
    filters' halo (``K//2`` rows); the plan validates both at construction.

    ``use_pallas``: ``"auto"`` takes the kernel bodies on a plan whose
    device is CUDA (where the spec allows them) and the plain bodies on the
    CPU; ``True`` the kernel bodies on any device (their plain versions on
    the CPU), ``ValueError`` where the spec does not allow them; ``False``
    the plain bodies on any device.
    """

    def __init__(self, plan: NDDWT, mesh, spec, batch_spec=(),
                 use_pallas="auto"):
        spec = tuple(spec)
        batch_spec = tuple(batch_spec)
        sizes = _mesh_sizes(mesh)
        if len(spec) != plan.ndim:
            raise ValueError(
                f"spec must name {plan.ndim} spatial axes, got {len(spec)}"
            )
        named = [n for n in batch_spec + spec if n is not None]
        for name in named:
            if name not in sizes:
                raise ValueError(f"mesh has no axis {name!r}")
        if len(set(named)) != len(named):
            raise ValueError(f"a mesh axis shards at most one array axis: {named}")
        for ax, name in enumerate(spec):
            if name is None:
                continue
            psize = sizes[name]
            if plan.shape[ax] % psize:
                raise ValueError(
                    f"spatial axis {ax} (size {plan.shape[ax]}) not divisible "
                    f"by mesh axis {name!r} (size {psize})"
                )
            local = plan.shape[ax] // psize
            # Each block reads K//2 rows from a ring neighbour (the
            # analysis K//2 - 1 and K//2, the synthesis the mirror:
            # cuda_kernels.halo_widths), and the neighbour must hold them.
            halo = plan.filter_lengths[ax] // 2
            if local < halo:
                raise ValueError(
                    f"local shard of axis {ax} ({local}) is smaller than the "
                    f"filter halo ({halo}); use fewer shards or shorter filters"
                )
        self.plan = plan
        self.mesh = mesh
        self.spec = spec
        self.batch_spec = batch_spec
        self.local_shape = tuple(
            plan.shape[ax] // (sizes[spec[ax]] if spec[ax] else 1)
            for ax in range(plan.ndim)
        )
        self._plain = use_pallas is False  # the plain bodies, asked for
        self._why_not = self._kernels_infeasible()
        if use_pallas == "auto":
            self.use_pallas = not self._why_not and plan.device.type == "cuda"
        else:
            self.use_pallas = bool(use_pallas)
            if self.use_pallas and self._why_not:
                raise ValueError(
                    "use_pallas=True but the spec does not allow the "
                    f"kernel bodies: {self._why_not}"
                )
        self._coord = mesh.get_coordinate()
        self._rings = None

    # ----------------------------------------------------------- dispatch
    def _kernels_infeasible(self):
        """Why the kernel bodies cannot serve this spec, or None."""
        nd, spec = self.plan.ndim, self.spec
        if nd not in (2, 3, 4):
            return (f"{nd}D sharded transforms have no kernel body (the 1D "
                    "level kernels have no halo-padded mode yet)")
        if self._stages() and any(spec[2:]):
            return ("the lane axes (Z, T) of the stage kernels must be "
                    "unsharded: the lane kernels have no halo-padded mode yet")
        return None

    def _stages(self) -> bool:
        """Whether a block runs on the stage kernels (4D, or 3D filters too
        long for the level kernels' tile) rather than the level kernels."""
        return ck.stage_route(self.local_shape, self.plan.taps_hp,
                              self.plan.real_dtype)

    def _ring_list(self):
        """The ring of each spatial axis (None where unsharded)."""
        if self._coord is None:
            raise ValueError(
                f"rank {dist.get_rank()} is not in the mesh {self.mesh}"
            )
        if self._rings is None:
            self._rings = tuple(None if n is None else _Ring(self.mesh, n)
                                for n in self.spec)
        return self._rings

    def _kernels(self, t) -> bool:
        """Whether ``t`` takes the kernel bodies. A CUDA tensor whose spec
        they cannot serve raises, unless the plain bodies were asked for:
        there is no torch-op route on CUDA."""
        if t.is_cuda and self._why_not and not self._plain:
            raise NotImplementedError(
                f"sharded transform on CUDA: {self._why_not} (ROADMAP.md queue 1 "
                "item 14); use_pallas=False runs the plain bodies"
            )
        return self.use_pallas

    def _bodies(self):
        """The (analysis, synthesis) kernel bodies of this spec."""
        if self._stages():
            return _dec_body_stages, _rec_body_stages
        return _dec_body_kernels, _rec_body_kernels

    def _as_input(self, x) -> torch.Tensor:
        """A block on the plan's device in the plan's dtype (NumPy copied)."""
        return self.plan._as_input(x)

    def _as_pair(self, x_pair) -> torch.Tensor:
        x_pair = self._as_input(x_pair)
        if x_pair.is_complex() or tuple(x_pair.shape) != (2,) + self.local_shape:
            raise ValueError(
                f"expected a real (2, *{self.local_shape}) split re/im block, "
                f"got {x_pair.dtype} {tuple(x_pair.shape)}"
            )
        return x_pair

    def _check_block(self, x, lead: int = 0):
        """``x``: ``lead`` leading axes, then the batch axes and this
        rank's spatial block."""
        nb = len(self.batch_spec)
        if (x.ndim != lead + nb + self.plan.ndim
                or tuple(x.shape[x.ndim - self.plan.ndim:]) != self.local_shape):
            raise ValueError(
                f"expected a block of {lead} leading and {nb} batch axes and "
                f"spatial shape {self.local_shape}, got {tuple(x.shape)}"
            )

    def _per_item(self, fn, x, lead: int):
        """``fn`` of each batch item of a block with ``lead`` leading axes
        before its batch axes: the kernel bodies take one array at a time."""
        if not self.batch_spec:
            return fn(x)
        nbatch = len(self.batch_spec)
        bshape = x.shape[lead: lead + nbatch]
        flat = x.reshape(x.shape[:lead] + (-1,) + self.local_shape)
        outs = [fn(flat.select(lead, i)) for i in range(flat.shape[lead])]
        out = torch.stack(outs, dim=outs[0].ndim - self.plan.ndim)
        return out.reshape(out.shape[: out.ndim - self.plan.ndim - 1]
                           + tuple(bshape) + self.local_shape)

    def _dec_block(self, x, level, lam=0.0):
        """Band-first analysis ``(*batch, *local) -> (B, *batch, *local)``;
        ``lam`` shrinks the details (in the kernels on the kernel bodies,
        joint magnitude for complex data)."""
        rings = self._ring_list()
        if not self._kernels(x):
            return _shrink_details(
                _dec_body(x, self.plan.taps, level, rings), lam)
        dec_body = self._bodies()[0]
        taps = self.plan.taps_hp

        def one(v):
            if not v.is_complex():
                return dec_body(v, taps, level, rings, lam)
            y = torch.stack([dec_body(c, taps, level, rings) for c in _parts(v)])
            return _join(elemwise.mag_shrink_pair(y, lam) if lam else y)

        return self._per_item(one, x, 0)

    def _rec_block(self, y, level):
        rings = self._ring_list()
        pl2 = self.plan.preserve_l2
        if not self._kernels(y):
            return _rec_body(y, self.plan.taps, level, pl2, rings)
        rec_body = self._bodies()[1]
        taps = self.plan.taps_hp

        def one(v):
            if not v.is_complex():
                return rec_body(v, taps, level, pl2, rings)
            return torch.complex(*(rec_body(c, taps, level, pl2, rings)
                                   for c in _parts(v)))

        return self._per_item(one, y, 1)

    # ------------------------------------------------------------- public
    def dec(self, x, level: int):
        """Sharded analysis of this rank's block: ``(*batch, *local)`` ->
        ``(B, *batch, *local)``."""
        level = self.plan._check_level(level)
        x = self._as_input(x)
        self._check_block(x)
        return self._dec_block(x, level)

    def rec(self, y):
        """Sharded synthesis: ``(B, *batch, *local)`` -> ``(*batch,
        *local)``, the level inferred from ``B``."""
        y = self._as_input(y)
        self._check_block(y, lead=1)
        level = level_from_bands(self.plan.ndim, y.shape[0])
        return self._rec_block(y, level)

    def dec_rec(self, x, level: int, threshold: float = 0.0):
        """Analysis -> soft-threshold of the details -> synthesis; returns
        ``(bands, x)`` blocks. On the kernel bodies the shrink rides the
        analysis kernels' band writes (JAX ``dec_rec_fn``); complex data
        takes the joint-magnitude ``mag_shrink_pair`` kernel."""
        level = self.plan._check_level(level)
        threshold = self.plan._check_threshold(threshold)
        x = self._as_input(x)
        self._check_block(x)
        y = self._dec_block(x, level, threshold)
        return y, self._rec_block(y, level)

    def dec_rec_streamed(self, x, level: int, threshold: float = 0.0):
        """The level-streamed iterate ``x -> reconstruction``
        (:func:`_streamed_pair`): the bands are never returned, and one
        level's bands live at a time. On the kernel bodies complex data
        raises ``NotImplementedError`` (its joint shrink is not streamed)."""
        level = self.plan._check_level(level)
        threshold = self.plan._check_threshold(threshold)
        x = self._as_input(x)
        self._check_block(x)
        rings = self._ring_list()
        pl2, nb = self.plan.preserve_l2, 2**self.plan.ndim
        if self._kernels(x):
            if x.is_complex():
                raise NotImplementedError(
                    "the streamed iterate of complex data on the kernel "
                    "bodies; use dec_rec")
            dec_body, rec_body = self._bodies()
            taps = self.plan.taps_hp

            def stream(v):
                return _streamed_pair(
                    v,
                    dec_approx=lambda a: dec_body(a, taps, 1, rings)[0],
                    dec_full=lambda a: dec_body(a, taps, 1, rings, threshold),
                    rec1=lambda g: rec_body(g, taps, 1, pl2, rings),
                    level=level)

            return self._per_item(stream, x, 0)
        taps = self.plan.taps

        def rec1(group):
            acc = _level1_rec_sharded(group, taps, rings)
            return acc if pl2 else acc / nb

        return _streamed_pair(
            x,
            dec_approx=lambda a: _level1_dec_sharded(a, taps, rings)[0],
            dec_full=lambda a: _shrink_details(
                _level1_dec_sharded(a, taps, rings), threshold),
            rec1=rec1, level=level)

    def peak_memory_model(self, level: int) -> dict:
        """Per-rank peak memory (bytes) of the two iterate layouts, as this
        port holds them: the full layout keeps the ``B`` bands, the input,
        the output and a level's intermediate (4 lane bands in 4D, the next
        approximation otherwise), and on the kernel bodies the halo-padded
        copies of the band array and of the running approximation; the
        streamed layout keeps ``level + 1`` approximations, one level's
        ``2^d`` bands and the intermediate, plus the padded copy of one
        level's bands. ``halo_factor`` is the padded block's size over the
        block's."""
        level = int(level)
        nd = self.plan.ndim
        nb, B = 2**nd, num_bands(nd, level)
        local_vox = math.prod(self.local_shape)
        item = torch.empty((), dtype=self.plan.real_dtype).element_size()
        temp = 4 if nd == 4 else 1
        factor = math.prod(
            (n + k - 1) / n if name is not None and _mesh_sizes(self.mesh)[name] > 1
            else 1.0
            for n, k, name in zip(self.local_shape, self.plan.filter_lengths, self.spec))
        pads = factor if factor > 1.0 else 0.0
        full = (B + 2 + temp + (B + 1) * pads) * local_vox * item
        streamed = (level + 1 + nb + 1 + temp + (nb + 1) * pads) * local_vox * item
        return {
            "local_voxels": local_vox,
            "halo_factor": factor,
            "full_band_layout_bytes": int(full),
            "streamed_layout_bytes": int(streamed),
            "ratio": full / streamed,
        }

    # ---------------------------------------------------------- split-complex
    def _split_check(self):
        if self.batch_spec:
            raise ValueError(
                "split-complex sharded transforms do not compose with "
                "batch axes; drop batch_spec or transform per item"
            )

    def dec_split(self, x_pair, level: int):
        """Split-complex analysis of a block: ``(2, *local)`` ->
        ``(2, B, *local)``, pair and band axes unsharded."""
        self._split_check()
        level = self.plan._check_level(level)
        x_pair = self._as_pair(x_pair)
        if self._kernels(x_pair):
            return torch.stack([self._dec_block(c, level) for c in x_pair])
        return self._dec_block(x_pair, level).transpose(0, 1)

    def rec_split(self, y_pair):
        """Split-complex synthesis: ``(2, B, *local)`` -> ``(2, *local)``."""
        self._split_check()
        y_pair = self._as_input(y_pair)
        if (y_pair.is_complex() or y_pair.ndim != self.plan.ndim + 2
                or y_pair.shape[0] != 2
                or tuple(y_pair.shape[2:]) != self.local_shape):
            raise ValueError(
                f"expected a real (2, B, *{self.local_shape}) split band block, "
                f"got {y_pair.dtype} {tuple(y_pair.shape)}"
            )
        level = level_from_bands(self.plan.ndim, y_pair.shape[1])
        if self._kernels(y_pair):
            return torch.stack([self._rec_block(c, level) for c in y_pair])
        return self._rec_block(y_pair.transpose(0, 1), level)

    def dec_rec_split(self, x_pair, level: int, threshold: float = 0.0):
        """Split-complex iterate: analysis of both components, the joint
        re/im magnitude shrink of the details (the prox of the complex l1
        norm; the ``nddwt_mag_shrink_pair`` kernel on the kernel bodies),
        synthesis. Returns ``((2, B, *local), (2, *local))`` blocks."""
        threshold = self.plan._check_threshold(threshold)
        y = self.dec_split(x_pair, level)
        if threshold:
            shrink = (elemwise.mag_shrink_pair if self._kernels(y)
                      else soft_threshold_mag_pair)
            y = shrink(y, threshold)
        return y, self.rec_split(y)

    # ------------------------------------------------------------- blocks
    def _cut(self, t, lead: int):
        """This rank's block of a global array with ``lead`` unsharded
        leading axes, then the batch axes and the spatial axes."""
        if self._coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {self.mesh}")
        sizes = _mesh_sizes(self.mesh)
        names = self.mesh.mesh_dim_names
        for ax, name in enumerate(self.batch_spec + self.spec):
            if name is None:
                continue
            axis = lead + ax
            n = t.shape[axis]
            if n % sizes[name]:
                raise ValueError(
                    f"axis {axis} (size {n}) not divisible by mesh axis "
                    f"{name!r} (size {sizes[name]})")
            w = n // sizes[name]
            t = t.narrow(axis, self._coord[names.index(name)] * w, w)
        return t.contiguous()

    def shard_input(self, x):
        """This rank's block ``(*batch, *local)`` of the global array
        ``(*batch, *shape)``, on the plan's device."""
        x = self._as_input(x)
        want = len(self.batch_spec) + self.plan.ndim
        if x.ndim != want or tuple(x.shape[x.ndim - self.plan.ndim:]) != self.plan.shape:
            raise ValueError(
                f"expected a global array with {len(self.batch_spec)} batch "
                f"axes and shape {self.plan.shape}, got {tuple(x.shape)}")
        return self._cut(x, 0)

    def shard_input_split(self, x_pair):
        """This rank's block ``(2, *local)`` of a global split pair
        ``(2, *shape)``: the pair axis unsharded."""
        self._split_check()
        x_pair = self._as_input(x_pair)
        if tuple(x_pair.shape) != (2,) + self.plan.shape:
            raise ValueError(
                f"expected a (2, *{self.plan.shape}) split pair, got "
                f"{tuple(x_pair.shape)}")
        return self._cut(x_pair, 1)

    def gather(self, t):
        """The global array of which ``t`` is this rank's block: its last
        axes are the batch and spatial axes (any axes before them, bands or
        a split pair, are unsharded). Every rank of the mesh calls it and
        gets the whole array."""
        if self._coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {self.mesh}")
        sizes = _mesh_sizes(self.mesh)
        names = self.batch_spec + self.spec
        off = t.ndim - len(names)
        for ax, name in enumerate(names):
            if name is None or sizes[name] == 1:
                continue
            group = self.mesh.get_group(name)
            staged = t.is_cuda and dist.get_backend(group) == "gloo"
            src = (t.cpu() if staged else t).contiguous()
            parts = [torch.empty_like(src) for _ in range(sizes[name])]
            dist.all_gather(parts, src, group=group)
            t = torch.cat(parts, dim=off + ax).to(t.device)
        return t

    def num_bands(self, level: int) -> int:
        return num_bands(self.plan.ndim, level)

