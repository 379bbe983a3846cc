"""Shared model building blocks: dtypes, initializers, norms, RoPE,
sinusoidal positions and the embedding tables.

Parameters live in ``nn.Module``s and keep the reference's names and
layouts: a projection is stored ``(in, out)`` and applied as ``x @ w``, so
a weight carries between the packages as a plain copy
(:mod:`repro_torch.convert`). Modules allocate their parameters and
``reset_parameters(generator)`` fills them; the model code itself is plain
functions on tensors. Parameters are made frozen (``requires_grad=False``)
for serving; the trainer turns grads on explicitly, with
``model.init(..., trainable=True)`` or ``params.requires_grad_(True)``
(:mod:`repro_torch.train.step`). Training runs the differentiable
``impl="xla"`` route: the attention and scan kernels are forward-only.

Sharding, as the reference's: every module has a ``spec_*`` function, a
tree of :class:`P` (one entry per tensor dim: ``None``, a mesh axis name,
or a tuple of them) mirroring its parameters, with tensor parallelism
over ``model`` (``TP``) and FSDP over ``data`` (``FSDP``). The reference
stacks its layers on a leading axis; the port keeps one module per layer,
so a port spec is the reference's with that leading ``None`` dropped.
Under a mesh (:func:`repro_torch.launch.mesh.set_mesh`) parameters and
activations are DTensors: :func:`maybe_shard` redistributes an
activation to a spec and :func:`shard_map` runs a function on the local
shards. With no mesh current both leave the computation untouched, so
the single-device path does not change by a bit.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import obs

TP = "model"   # tensor-parallel mesh axis
FSDP = "data"  # fully-sharded-data-parallel mesh axis

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------- #
#  Sharding specs and the current mesh
# ---------------------------------------------------------------------- #
class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name, or a tuple of axis names (the dim split over their
    product, in that order), as the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + (super().__repr__() if len(self) != 1
                      else f"({self[0]!r})")


def is_spec(x) -> bool:
    return isinstance(x, P)


def map_specs(fn, tree):
    """``fn`` on every spec of a nested dict / tuple tree of specs."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    return tree


_MESH: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the current one
    for the block (:func:`repro_torch.launch.mesh.set_mesh`)."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` block, or None."""
    return _MESH[-1] if _MESH else None


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a mesh (a dict of them passes through; empty
    for None)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def sanitize_spec(spec, shape, mesh):
    """Drop spec entries whose mesh axes don't exist or don't divide the
    dim (e.g. Whisper's vocab 51866 % 16 != 0 → vocab unsharded): of each
    entry's axes, the greedy prefix whose product divides the dim.
    ``mesh``: a ``DeviceMesh`` or {axis name: size}."""
    axes = mesh_axes(mesh)
    out = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept, size = [], 1
        for a in (a for a in names if a in axes):
            if shape[i] % (size * axes[a]) != 0:
                break
            kept.append(a)
            size *= axes[a]
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return P(*out)


def _splits(n: int, k: int) -> bool:
    """Whether ``n`` rows split over ``k`` ranks leave none empty: in
    DTensor's uneven ``Shard`` each rank holds ``ceil(n / k)`` rows, the
    last ones fewer."""
    return (k - 1) * -(-n // k) < n


def split_spec(spec, shape, mesh):
    """An activation's spec on ``mesh`` as the reference's
    :func:`maybe_shard` keeps it: each entry cut to the axes the mesh has,
    an axis kept where it does not divide the dim. Such a dim is split
    unevenly (chunks of ``ceil(n / k)``, the last shorter: Whisper's 1500
    frames are 94 rows a rank on 16, as GSPMD pads them to 94 a device).
    Of each entry's axes, those that divide, then at most one that does
    not, if it leaves no rank empty (a batch of 1 runs replicated: on a
    device GSPMD's padded split holds the same one row)."""
    axes = mesh_axes(mesh)
    out = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept, size = [], 1
        for a in (a for a in names if a in axes):
            if shape[i] % (size * axes[a]) == 0:
                kept.append(a)
                size *= axes[a]
                continue
            if _splits(shape[i] // size, axes[a]):
                kept.append(a)
            break
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return P(*out)


def podify(spec_tree):
    """Batch/cache spec trees: extend the 'data' axis to ('pod','data') so
    serve inputs shard across pods too (params stay pod-replicated — pure
    DP over the slow links)."""
    def one(s):
        out = []
        for entry in s:
            if entry == "data":
                out.append(("pod", "data"))
            elif isinstance(entry, tuple) and "data" in entry:
                out.append(("pod",) + tuple(entry))
            else:
                out.append(entry)
        return P(*out)
    return map_specs(one, spec_tree)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of ``shape`` laid out as ``spec``."""
    axes = mesh_axes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else
                  (() if entry is None else (entry,))):
            out[dim] //= axes[a]
    return tuple(out)


def sharded(local, shape, mesh, spec):
    """The DTensor of global ``shape`` laid out as ``spec`` (sanitized)
    whose shard on this rank is ``local``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def mesh_zeros(make, spec_tree, device):
    """``make(device)``: a tree of zero tensors (a cache). Under a mesh,
    each leaf instead is a DTensor laid out as its spec in ``spec_tree``
    (sanitized), and only this rank's shard is allocated."""
    mesh = current_mesh()
    if mesh is None:
        return make(device)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():   # shapes only: no dispatch mode sees it
        meta = make("meta")

    def one(t, spec):
        if isinstance(t, dict):
            return {k: one(v, spec[k]) for k, v in t.items()}
        spec = sanitize_spec(spec, t.shape, mesh)
        return sharded(torch.zeros(local_shape(t.shape, spec, mesh),
                                   dtype=t.dtype, device=device),
                       t.shape, mesh, spec)
    return one(meta, spec_tree)


def placements(mesh, spec):
    """The DTensor placements of ``spec`` on ``mesh``: a tensor dim split
    over several mesh dims is sharded in mesh order (DTensor cannot state
    another order without ``_StridedShard``); the local shape and the
    collective bytes are the same either way. Axes the mesh lacks are
    dropped, as the reference's ``maybe_shard`` drops them."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in names:
                out[names.index(a)] = Shard(dim)
    return out


def maybe_shard(x, spec):
    """Redistribute the DTensor ``x`` to ``spec`` on the current mesh (the
    reference's ``with_sharding_constraint``), as :func:`split_spec` cuts
    it: an axis that does not divide its dim splits it unevenly, as the
    reference's partitioner pads it. A no-op with no mesh current or on a
    plain tensor (a local shard inside :func:`shard_map`)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _redistribute(x, mesh, placements(mesh, split_spec(
        spec, tuple(x.shape), mesh)))


def _redistribute(x, mesh, pl):
    """``x.redistribute(mesh, pl)``, with a move of the ``model`` split
    from one dim to another as one all-to-all over ``model`` (each rank
    sends each other rank the block it will hold), as the partitioner
    moves it. DTensor does the same on the card with an op the dry run
    does not see, and gathers the whole tensor over a CPU group."""
    from torch.distributed.tensor import DTensor, Shard
    names = list(mesh.mesh_dim_names)
    if TP in names:
        i = names.index(TP)
        src, dst, k = x.placements[i], pl[i], mesh.size(i)
        others = [p for j, p in enumerate(x.placements) if j != i]
        if isinstance(src, Shard) and isinstance(dst, Shard) and \
                src.dim != dst.dim and not x.shape[src.dim] % k and \
                not x.shape[dst.dim] % k and \
                Shard(src.dim) not in others and Shard(dst.dim) not in others:
            from torch.distributed._functional_collectives import \
                all_to_all_single_autograd
            a, b = src.dim, dst.dim
            send = torch.stack(x.to_local().chunk(k, dim=b))
            got = all_to_all_single_autograd(send, None, None,
                                             mesh.get_group(i))
            moved = list(x.placements)
            moved[i] = Shard(b)
            shape = tuple(x.shape)
            x = DTensor.from_local(
                got.movedim(0, a).flatten(a, a + 1), mesh, moved,
                run_check=False, shape=torch.Size(shape),
                stride=_contiguous_stride(shape))
    return x.redistribute(mesh, pl)


def to_dtensor(x, mesh, spec):
    """``x`` as a DTensor on ``mesh`` laid out as ``spec``. A plain tensor
    counts as the same full value on every rank, so each rank keeps its
    own slice and nothing is sent. A DTensor already so laid out comes
    back as it is, with no autograd node: a gradient that reaches it as a
    partial sum stays one, and the partial gradients of a block's
    projections add up before one all-reduce (not one a projection)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = tuple(placements(mesh, spec))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def shard_bounds(shape, mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` laid out by ``placements`` on ``mesh``, from the mesh
    coordinate alone (a dim split over several mesh dims is split in mesh
    order, as DTensor splits it). Each split must divide its dim, as
    :func:`sanitize_spec` makes it."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    n, lo = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        k = mesh.size(i)
        if n[p.dim] % k:
            raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                             f"split over {k} ranks")
        n[p.dim] //= k
        lo[p.dim] += coord[i] * n[p.dim]
    return tuple(n), tuple(lo)


@torch.no_grad()
def assign(dst, index, src):
    """``dst[index] = src`` in place (a cache write). ``index``: a tuple
    of ints and unit-step slices over ``dst``'s leading dims. Under a
    mesh, with ``dst`` a DTensor, each rank writes the part of ``src``
    that falls in its own shard of ``dst``: ``src`` is laid out as
    ``dst`` on the dims the index leaves whole and whole on the sliced
    ones, so a write into a cache whose sequence is split over ``model``
    moves no more than the rows it writes. With no mesh, the plain
    assignment."""
    mesh = current_mesh()
    if mesh is None:
        dst[index] = src
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dst, DTensor):
        dst[index] = src
        return
    index = tuple(index) + (slice(None),) * (dst.dim() - len(index))
    src_dim, d = {}, 0                       # dst dim -> src dim
    for i, ix in enumerate(index):
        if not isinstance(ix, int):
            src_dim[i] = d
            d += 1
    src_pl = []
    for p in dst.placements:
        if isinstance(p, Shard) and index[p.dim] == slice(None):
            src_pl.append(Shard(src_dim[p.dim]))
        elif isinstance(p, (Shard, Replicate)):
            src_pl.append(Replicate())
        else:
            raise ValueError(f"assign: cannot write into a {p} tensor")
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, dst.device_mesh,
                                 [Replicate()] * dst.device_mesh.ndim,
                                 run_check=False)
    src = src.redistribute(dst.device_mesh, src_pl).to_local()
    local = dst.to_local()
    n_loc, lo = shard_bounds(dst.shape, dst.device_mesh, dst.placements)
    dst_ix, src_ix = [], []
    for i, ix in enumerate(index):
        size = dst.shape[i]
        if isinstance(ix, int):
            k = ix % size
            if not lo[i] <= k < lo[i] + n_loc[i]:
                return                       # not in this rank's shard
            dst_ix.append(k - lo[i])
            continue
        a, b, step = ix.indices(size)
        if step != 1:
            raise ValueError("assign: slices must have unit step")
        a2, b2 = max(a, lo[i]), min(b, lo[i] + n_loc[i])
        if a2 >= b2:
            return
        dst_ix.append(slice(a2 - lo[i], b2 - lo[i]))
        src_ix.append(slice(a2 - a, b2 - a) if ix != slice(None)
                      else slice(None))
    local[tuple(dst_ix)] = src[tuple(src_ix)]


def shard_map(f, mesh, in_specs, out_specs, out_partial=(), out_shapes=()):
    """Run ``f`` on local shards, as the reference's ``shard_map``: each
    argument is redistributed to its spec in ``in_specs`` (a plain tensor
    counts as replicated) and ``f`` gets its local shard; each output of
    ``f`` is a local shard laid out as its spec in ``out_specs`` and, over
    the axes in the matching entry of ``out_partial``, a partial sum that
    is all-reduced to a replicated value (the reference's ``psum`` at the
    end of the body). A spec may split a dim unevenly (:func:`split_spec`);
    an output split so gives its global shape in ``out_shapes`` (one
    entry an output, None where every split divides).

    Differentiable, as the transpose of the reference's ``shard_map``.
    The body's work is split over the mesh axes on which an output is
    sharded or partial; over those, the gradient of an argument that is
    replicated there is a partial sum (an FSDP weight's gradient is
    reduce-scattered over ``data``, a ``model``-replicated activation's
    summed over ``model``). Over the other axes every rank runs the same
    computation, and such a gradient is whole on each rank. An output
    that needs a gradient must then be split over every axis the work is
    split over: one replicated there would have its gradient counted once
    per rank, so that raises."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    names = list(mesh.mesh_dim_names)
    parts = [tuple(out_partial[i]) if i < len(out_partial) else ()
             for i in range(len(out_specs))]
    out_pl = []
    for s, part in zip(out_specs, parts):
        pl = placements(mesh, s)
        for a in part:
            pl[names.index(a)] = Partial()
        out_pl.append(pl)
    split = {i for pl in out_pl for i, p in enumerate(pl)
             if not p.is_replicate()}

    def run(*args):
        local = []
        for a, s in zip(args, in_specs):
            pl = placements(mesh, s)
            grad_pl = [p if isinstance(p, Shard) else
                       (Partial() if i in split else p)
                       for i, p in enumerate(pl)]
            local.append(to_dtensor(a, mesh, s).to_local(
                grad_placements=grad_pl))
        outs = f(*local)
        res = []
        for i, (o, s, part, pl) in enumerate(zip(outs, out_specs, parts,
                                                 out_pl)):
            whole = [names[j] for j in split if pl[j].is_replicate()]
            if whole and o.requires_grad:
                raise ValueError(
                    f"shard_map: an output laid out as {s} is replicated "
                    f"over {whole}, over which the body's work is split; "
                    "its gradient would be counted once per rank")
            shape = out_shapes[i] if i < len(out_shapes) else None
            d = (DTensor.from_local(o, mesh, pl, run_check=False)
                 if shape is None else DTensor.from_local(
                     o, mesh, pl, run_check=False, shape=torch.Size(shape),
                     stride=_contiguous_stride(shape)))
            res.append(d.redistribute(mesh, placements(mesh, s))
                       if part else d)
        return tuple(res)
    return run


def _contiguous_stride(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def matmul(x, w, split_seq: bool = False, split_out: bool = False):
    """``x @ w`` for a projection ``w`` (in, out). Under a mesh, with ``w``
    a DTensor, the product runs on local shards in the layout its spec
    implies, not one DTensor's strategy search picks: ``w``'s FSDP shards
    are gathered (over ``data``/``pod``), its ``model`` split decides
    column parallelism (x whole over ``model``, the output split) or row
    parallelism (x split on its last dim, the partial outputs summed by
    an all-reduce), and x keeps its batch over (pod, data). With ``w``
    whole over ``model``: ``split_seq`` splits x's second dim (the
    sequence) over ``model``, and so the output's, each rank projecting
    only its rows; ``split_out`` splits the output's last dim, each rank
    taking its columns of ``w`` (the reference's vocab-parallel logits,
    whose constraint its partitioner carries into the product). Either
    split may be uneven (:func:`split_spec`)."""
    mesh = current_mesh()
    if mesh is None:
        return x @ w
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(w, DTensor):
        return x @ w
    names = list(mesh.mesh_dim_names)
    on_tp = w.placements[names.index(TP)] if TP in names else None
    row, col = on_tp == Shard(0), on_tp == Shard(1)
    dp = split_spec(P(("pod", FSDP)), (x.shape[0],), mesh)[0]
    mid = [None] * (x.dim() - 2)
    if split_seq and not (row or col) and mid:
        mid[0] = split_spec(P(None, TP), tuple(x.shape[:2]), mesh)[1]
    out_tp = TP if col else None
    if split_out and not (row or col or any(mid)):
        out_tp = split_spec(P(TP), (w.shape[-1],), mesh)[0]
    (y,) = shard_map(lambda a, b: (a @ b,), mesh,
                     [P(dp, *mid, TP if row else None),
                      P(TP if row else None, out_tp)],
                     [P(dp, *mid, out_tp)],
                     out_partial=((TP,) if row else (),),
                     out_shapes=[(*x.shape[:-1], w.shape[-1])])(x, w)
    return y


def split_last(x, sizes):
    """``torch.split(x, sizes, dim=-1)``. Under a mesh, with ``x`` a
    DTensor whose last dim is split over ``model`` (and no other axis)
    and every part dividing over ``model``, each part comes out split
    over ``model`` too, and the ranks exchange only what moves: one
    all-to-all over ``model`` sends each column to the rank that holds it
    in its part's layout, as the partitioner does for the reference's
    ``jnp.split`` of a projection's output. (Slicing the DTensor would
    gather ``x`` whole over ``model`` once a part.)"""
    from torch.distributed.tensor import DTensor, Shard
    mesh = current_mesh()
    sizes = list(sizes)
    names = list(mesh.mesh_dim_names) if mesh is not None else []
    if not isinstance(x, DTensor) or TP not in names:
        return torch.split(x, sizes, dim=-1)
    i, d = names.index(TP), x.dim() - 1
    tp = mesh.size(i)
    if x.placements[i] != Shard(d) or any(
            p == Shard(d) for j, p in enumerate(x.placements) if j != i) \
            or any(n % tp for n in sizes):
        return torch.split(x, sizes, dim=-1)
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    local = x.to_local()
    c, r, J = local.shape[-1], mesh.get_local_rank(TP), len(sizes)
    starts = [sum(sizes[:j]) for j in range(J)]

    def cut(q, j, s):
        """Part j's columns on rank q that rank s holds (global)."""
        w = sizes[j] // tp
        lo = max(starts[j] + q * w, s * c)
        return lo, max(lo, min(starts[j] + (q + 1) * w, (s + 1) * c))

    # send to each rank q its parts' columns, part by part; receive from
    # each rank s in the same order, and put each part's pieces together
    sent = [cut(q, j, r) for q in range(tp) for j in range(J)]
    mine = [cut(r, j, s) for s in range(tp) for j in range(J)]
    got = all_to_all_single_autograd(
        torch.cat([local[..., lo - r * c:hi - r * c].movedim(-1, 0)
                   for lo, hi in sent]),
        [sum(hi - lo for lo, hi in mine[s * J:(s + 1) * J])
         for s in range(tp)],
        [sum(hi - lo for lo, hi in sent[q * J:(q + 1) * J])
         for q in range(tp)], mesh.get_group(i))
    pieces = torch.split(got, [hi - lo for lo, hi in mine])
    return tuple(DTensor.from_local(
        torch.cat(pieces[j::J]).movedim(0, -1), mesh, x.placements,
        run_check=False) for j in range(J))


def batch_spec():
    """Batch-dim sharding: over ('pod','data') when present."""
    return ("pod", "data")


def residual(x):
    """Pin a block's output to the residual stream's layout under a mesh:
    batch over (pod, data), replicated over ``model`` (the all-reduce of
    a tensor-parallel block's partial sums, as Megatron-style TP and the
    reference's compiled program place it). A no-op with no mesh."""
    return maybe_shard(x, P(("pod", FSDP), None, None))


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized, frozen parameter."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


#: the full-sequence routes: the forward-only kernels ("flash", serving)
#: or the differentiable plain path ("xla", training)
IMPLS = ("flash", "xla")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def layer_call(cfg, fn, *args, keep_rows: bool = False):
    """``fn(*args)``, rematerialised in the backward pass when
    ``cfg.remat == "full"`` (the reference wraps its layer bodies in
    ``jax.checkpoint``): only the layer's inputs are kept, and its
    activations are recomputed when the gradient reaches it.

    ``keep_rows`` (the attention layers' stacks): under a mesh the kept
    input, the residual stream whole over ``model``, is kept as this
    rank's rows of it and gathered again for the recompute, as the
    reference's partitioner keeps an attention layer's input (1/16 of it
    on 16 ranks; one all-gather a layer in the backward). Its gradient
    passes whole, as without the split."""
    if cfg.remat != "full":
        return fn(*args)
    split = _rows_kept(args[0]) if keep_rows else None
    if split is None:
        return checkpoint(fn, *args, use_reentrant=False)
    whole, box = args[0].placements, [args[0]]

    def body(rows, *rest):
        # the forward takes the whole input it was given; the recompute
        # gathers it from the kept rows
        x = _Rejoin.apply(rows, box.pop()) if box else \
            _Relayout.apply(rows, whole)
        return fn(x, *rest)
    return checkpoint(body, _Relayout.apply(args[0], split), *args[1:],
                      use_reentrant=False)


def _rows_kept(x):
    """The placements of ``x`` with its rows (dim 1) split over
    ``model``, for a DTensor whole over ``model`` whose rows split there
    (:func:`split_spec`), while gradients are recorded; else None."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = current_mesh()
    if mesh is None or TP not in mesh.mesh_dim_names or \
            not isinstance(x, DTensor) or x.dim() < 2 or \
            not torch.is_grad_enabled():
        return None
    i = list(mesh.mesh_dim_names).index(TP)
    if not x.placements[i].is_replicate() or \
            split_spec(P(None, TP), tuple(x.shape[:2]), mesh)[1] is None:
        return None
    out = list(x.placements)
    out[i] = Shard(1)
    return tuple(out)


class _Relayout(torch.autograd.Function):
    """A DTensor redistributed to ``placements`` (its rows cut out, or
    gathered whole); the gradient passes as it comes: whole over
    ``model`` on each side of the cut."""

    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Rejoin(torch.autograd.Function):
    """``whole`` (the tensor ``rows`` was cut from) in place of ``rows``:
    nothing moves; the gradient goes to ``rows``."""

    @staticmethod
    def forward(ctx, rows, whole):
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------- #
#  Initializers (fp32 normal draws scaled, then cast, as the reference)
# ---------------------------------------------------------------------- #
def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def dense_init(generator, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return (_normal(generator, shape, device)
            * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(generator, shape, dtype, device):
    return (_normal(generator, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------- #
#  Norms (computed in fp32, cast back)
# ---------------------------------------------------------------------- #
def rms_norm(x, weight, eps):
    with obs.span("norm"):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps)
        return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm parameters as the reference's ``{"w", "b"}`` leaves."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.w = param((cfg.d_model,), dt, device)
        self.b = param((cfg.d_model,), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.w.fill_(1.0)
        self.b.zero_()


def ln(x, p: LayerNorm, eps):
    return layer_norm(x, p.w, p.b, eps)


# ---------------------------------------------------------------------- #
#  Rotary position embeddings (full head dim, split-half rotation)
# ---------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float, scale: float = 1.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). With
    ``scale`` other than 1 the rotated fp32 values are multiplied by it
    before their one rounding to x's dtype (a query scaled for a score
    scale other than ``1/sqrt(hd)``, :attr:`ModelConfig.query_scale`)."""
    with obs.span("attention.rope"):
        hd = x.shape[-1]
        freqs = rope_freqs(hd, theta, x.device)            # (hd/2,)
        angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
        cos = torch.cos(angles)[..., :, None, :]          # (..., S, 1, hd/2)
        sin = torch.sin(angles)[..., :, None, :]
        x1, x2 = x.float().chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        if scale != 1.0:
            out = out * scale
        return out.to(x.dtype)


# ---------------------------------------------------------------------- #
#  Sinusoidal positions (Whisper encoder)
# ---------------------------------------------------------------------- #
def sinusoidal_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """(n_pos, dim) fp32: computed in float64 numpy and rounded once, as
    the reference computes it."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10_000, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# ---------------------------------------------------------------------- #
#  Embedding / unembedding
# ---------------------------------------------------------------------- #
class Embeddings(nn.Module):
    """``tok`` (vocab, d_model) and, unless tied, ``unembed`` (d_model,
    vocab)."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.tok = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.unembed = (None if cfg.tie_embeddings else
                        param((cfg.d_model, cfg.vocab_size), dt, device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        dev = self.tok.device
        self.tok.copy_(embed_init(generator, self.tok.shape, self.tok.dtype,
                                  dev))
        if self.unembed is not None:
            self.unembed.copy_(dense_init(generator, self.unembed.shape,
                                          self.unembed.dtype, dev))


def spec_embeddings(cfg):
    # vocab-parallel over TP only, as the reference (it does not
    # FSDP-shard the d_model dim of the table: batch sharding would be
    # lost downstream of the gather)
    p = {"tok": P(TP, None)}
    if not cfg.tie_embeddings:
        p["unembed"] = P(FSDP, TP)
    return p


def init_embeddings(cfg, generator, device):
    emb = Embeddings(cfg, device)
    emb.reset_parameters(generator)
    return emb


def _embed_vocab_parallel(tok, tokens, mesh):
    """The lookup with the table's vocab sharded over ``model``: each
    rank looks up the tokens in its slice (zero elsewhere) and one
    all-reduce over ``model`` sums them."""
    spec = sanitize_spec(P(TP, None), tok.shape, mesh)
    n = mesh_axes(mesh)[TP] if spec[0] else 1
    V_loc = tok.shape[0] // n
    v0 = mesh.get_local_rank(TP) * V_loc if spec[0] else 0

    def local(t, w):
        t = t.long()
        hit = (t >= v0) & (t < v0 + V_loc)
        out = torch.nn.functional.embedding(torch.where(hit, t - v0, 0), w)
        return (out * hit[..., None].to(out.dtype),)
    bspec = sanitize_spec(P(("pod", FSDP), None), tokens.shape, mesh)
    (out,) = shard_map(local, mesh, [bspec, spec], [P(bspec[0], None, None)],
                       out_partial=((TP,),) if spec[0] else ())(tokens, tok)
    return out


def embed_tokens(p: Embeddings, tokens, cfg):
    mesh = current_mesh()
    if mesh is None:
        out = p.tok[tokens.long()]
    else:
        out = _embed_vocab_parallel(p.tok, tokens, mesh)
    out = out.to(dtype_of(cfg.activation_dtype))
    # the canonical activation layout at network entry: batch over
    # (pod, data), everything else replicated
    return maybe_shard(out, P(("pod", FSDP), None, None))


def unembed(p: Embeddings, x, cfg):
    w = p.unembed if p.unembed is not None else p.tok.T
    # vocab-parallel logits, as the reference: x whole on every ``model``
    # rank, so the product splits the vocab and not d_model
    x = maybe_shard(x, P(("pod", FSDP), None, None))
    return maybe_shard(matmul(x, w.to(x.dtype), split_out=True),
                       P(("pod", FSDP), None, TP))
