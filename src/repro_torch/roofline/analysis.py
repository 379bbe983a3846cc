"""Three-term roofline analysis: the analytic model costs and the costs
of a traced step (§Roofline).

  compute term    = FLOPs / peak_FLOP/s          [per device]
  memory term     = bytes / HBM_bw               [per device]
  collective term = collective_bytes / link_bw   [per device, ring model]

Analytic half: :func:`model_flops` counts a model's FLOPs per device from
its active parameters (6·N·D train, 2·N·D prefill, 2·N per decode token),
and :func:`ssm_scan_correction` adds the sequence recurrence of SSM
layers, modelled at the chunked scan kernel's cost.
:mod:`repro_torch.core.model_apps` derives the scheduler's model apps
from them.

Traced half (the port of the reference's compiled-artifact half): where
the reference reads an XLA executable (``cost_analysis``,
``memory_analysis``, the HLO text), the port reads a :class:`Trace`, the
record of one step run on fake DTensors on a fake mesh
(:mod:`repro_torch.launch.dryrun`), made by :class:`Recorder`, a dispatch
mode that sees each DTensor op after DTensor has split it into local ops
and collectives. It counts as XLA's cost analysis counts on the CPU
backend, the one the reference's dry run compiles for (512 host
devices). Each convention below was set by a probe on that backend,
``jax.jit(f).lower(x).compile().cost_analysis()`` of one small function,
f32[1024, 1024] unless named; ``tests/test_torch_dryrun.py`` holds the
recorder to each probe.

* ``flops``: per device (local shapes, no division by the chip count;
  replicated work counted on every rank).
  - Products: ``torch.utils.flop_counter``'s formulas, 2·M·N·K (f32
    product 2.147e9); also kept apart as ``matmul_flops``.
  - Elementwise ops: one per output element (``x*2`` 1.05e6, ``x+y``,
    ``-x``, ``x/y``, ``x>y``, ``where``, a cast: 1.05e6 each); a copy,
    a transpose, a broadcast or a factory none. Transcendentals (``exp``,
    ``log``, ``tanh``, ``rsqrt``, ``sqrt``, ``erf``, ``sin``, ``cos``, a
    non-integer power) are not FLOPs: one per element under
    ``transcendentals`` (``exp(x*2+1)``: 2.10e6 FLOPs, 1.05e6
    transcendentals). XLA expands some into both: ``sigmoid`` 3 + 1,
    ``silu`` 4 + 1, ``softplus`` 6 + 2 a element (their backward ops
    ``_ACTIVATIONS``, from the probes of their VJPs).
  - Reductions: one per input element (a row sum of 1024: 1023;
    ``mean`` 1024). ``softmax`` is a max, a subtract and exp, a sum, a
    divide: 4 a element and 1 transcendental (probe 4.19e6, 1.05e6);
    ``log_softmax`` 5 and 1; their backward ops likewise.
* ``bytes`` (XLA's "bytes accessed"), fused. The recorder logs each op:
  its class, the buffers it reads and writes, and their bytes. A buffer
  is a version of a storage (views map to their base; an in-place write
  makes a new version; storages are numbered by a counter, not
  ``id()``). After the step, elementwise ops (casts, ``where``,
  comparisons, copies and factories included) are joined into one
  fusion along each producer-consumer edge whose value has no other
  reader, as XLA's loop fusion on the CPU, which makes no multi-output
  fusion. A fusion is charged the buffers that enter it from outside
  (each distinct view read once, at most the storage's bytes) and the
  buffers it writes that an op outside it reads, or that are step
  outputs (``exp(x*2+1)``: 8.39e6 bytes, one read and one write; a dead
  value costs nothing). A value with two readers is written once and
  read by each; XLA copies a cheap producer into both consumers instead
  (``y = x*2+1; (y+1, y*3)``: 1.68e7 bytes, the recorder 2.52e7), the
  one probe the recorder does not follow. Every other op is charged its
  operands and results:
  - a reduction on its own, its producers not fused into it and it not
    into its consumers (CPU: ``(x*x).sum(-1)`` writes and reads ``x*x``,
    1.28e7 bytes; ``softmax`` 2.57e7: x read by the max and the exp, e
    written, read by the sum and the divide, y written);
  - products (an f32 product 1.26e7 bytes, a bf16 one into f32 8.39e6).
    A product with a bf16 or f16 result is costed as the CPU backend
    runs it: its operands cast to f32, an f32 product, the result cast
    back (3.15e7 bytes at bf16 [1024, 1024]), the casts elementwise ops
    that fuse with their neighbours (``(a*2) @ b``: 3.15e7 too);
  - gathers, scatters and index ops (reading the whole table: a take of
    512 rows 6.29e6), ``cat`` (1.68e7 for two), sort and top-k, the
    collectives;
  - a copy into part of a larger buffer (a cache write) as XLA's
    dynamic-update-slice: the whole buffer read and written, the update
    read and written (8.52e6 for 16 rows into [1024, 1024]).
  A view costs nothing. The log holds numbers, not tensors.
* collectives: each ``_c10d_functional`` op with the reference's
  conventions — ``s`` = bytes of the per-device result (the gathered
  size for all-gather, the scattered shard for reduce-scatter), N = the
  group size — and its ring-model traffic (all-reduce 2·s·(N-1)/N,
  all-gather s·(N-1)/N, reduce-scatter s·(N-1), all-to-all s·(N-1)/N,
  permute s).
* memory: argument, output and alias bytes from the step's inputs and
  outputs, and temp = the peak of the live local bytes of the storages
  that hold a buffer the fusion model above materializes (written by an
  op that is no elementwise one, or read outside its fusion), less the
  arguments and the outputs, which XLA counts apart: an eager
  intermediate inside a fusion is not held.

The hardware constants stay the reference's (TPU v5e class: 197 TFLOP/s
bf16, 819 GB/s HBM, ~50 GB/s/link ICI): they are the scheduler's data
model, not the card's.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["CollectiveStats", "HBM_BW", "LINK_BW", "PEAK_FLOPS", "Recorder",
           "Roofline", "Trace", "analyze", "collectives_of", "cost_analysis",
           "costs_of", "extrapolate_costs", "make_roofline", "memory_stats",
           "model_flops", "ring_traffic", "ssm_scan_correction"]

# ---------------------------------------------------------------------- #
PEAK_FLOPS = 197e12       # bf16 / chip
HBM_BW = 819e9            # B/s / chip
LINK_BW = 50e9            # B/s / ICI link


def ring_traffic(kind: str, size: float, n: int) -> float:
    """Per-device ring-algorithm link bytes of one collective whose
    per-device result is ``size`` bytes over a group of ``n``."""
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / max(n, 1)
    if kind == "all-gather":
        return size * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return float(size) * (n - 1)
    if kind == "all-to-all":
        return size * (n - 1) / max(n, 1)
    return float(size)  # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    raw_bytes: float
    modeled_bytes: float
    by_kind: dict


def collectives_of(records) -> CollectiveStats:
    """Totals of ``(kind, result bytes, group size)`` records."""
    counts: dict = {}
    by_kind: dict = {}
    raw = modeled = 0.0
    for kind, size, n in records:
        traffic = ring_traffic(kind, size, n)
        raw += size
        modeled += traffic
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0.0) + traffic
    return CollectiveStats(counts=counts, raw_bytes=raw,
                           modeled_bytes=modeled, by_kind=by_kind)


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes_raw: float
    coll_bytes_modeled: float
    coll_counts: dict
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # analytic useful FLOPs per device
    useful_ratio: float          # model_flops / traced flops
    memory_per_device: dict

    def to_dict(self):
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------- #
#  The trace record and its recorder
# ---------------------------------------------------------------------- #
_COLL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_FACTORIES = {"empty", "empty_strided", "zeros", "ones", "full", "arange",
              "scalar_tensor", "rand", "randn", "empty_like", "zeros_like",
              "ones_like", "full_like", "new_empty", "new_zeros", "new_full",
              "new_empty_strided", "new_ones"}
# buffers made with no work: their values cost nothing until read
_EMPTY = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
# elementwise ops that move or make data but do no arithmetic (a copy, a
# transpose, a broadcast, a constant, the transpose of a slice)
_NO_FLOPS = {"clone", "copy", "copy_", "_to_copy", "zeros", "ones", "full",
             "arange", "scalar_tensor", "zeros_like", "ones_like",
             "full_like", "new_zeros", "new_full", "new_ones", "fill",
             "fill_", "zero_", "lift_fresh_copy", "slice_backward",
             "select_backward", "repeat", "expand_copy"}
# elementwise ops torch does not tag ``pointwise``
_ELEMENTWISE = _NO_FLOPS | {"floor_divide", "softplus_backward",
                            "gelu_backward", "threshold_backward"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
                   "tanh", "rsqrt", "sqrt", "erf", "erfc", "erfinv", "sin",
                   "cos", "tan", "asin", "acos", "atan", "atan2", "sinh",
                   "cosh", "asinh", "acosh", "atanh"}
# (FLOPs, transcendentals) a element of ops XLA expands: the forward
# from probes of jax.nn's functions, a backward op from the probe of its
# VJP less the forward it recomputes
_ACTIVATIONS = {"sigmoid": (3, 1), "silu": (4, 1), "softplus": (6, 2),
                "gelu": (8, 1), "sigmoid_backward": (3, 0),
                "tanh_backward": (3, 0), "silu_backward": (9, 1),
                "softplus_backward": (6, 1), "gelu_backward": (12, 0),
                "threshold_backward": (1, 0)}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "prod", "any", "all", "logsumexp",
               "linalg_vector_norm", "norm", "var", "std", "var_mean",
               "std_mean", "nansum"}
_EW, _OTHER = 0, 1            # an op log entry: fusible, or not


@dataclasses.dataclass
class Trace:
    """What one traced step did on one device (every number local)."""
    flops: float = 0.0
    matmul_flops: float = 0.0          # the products' share of flops
    cast_flops: float = 0.0            # the casts' share of flops
    transcendentals: float = 0.0
    bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (nested
    dicts / lists / tuples / NamedTuples / modules; DTensors by their
    local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree._local_tensor
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Records a :class:`Trace` of the local work under it.

    A DTensor op is re-dispatched with the recorder still on, so it sees
    the local ops and collectives DTensor runs for it. Of those it counts
    only the ones that read a local tensor: the inputs' shards and what
    was made from them (DTensor also runs each new op once on global-size
    fake tensors to learn the output's shape; those are not the device's
    work). Outside a DTensor op every op counts (a ``shard_map`` body,
    the model's own small tensors).

    Each counted op adds its FLOPs and transcendentals at once and an
    entry to the op log; on leaving, the log is grouped into fusions and
    ``trace.bytes`` summed (the module's docstring). Call
    :meth:`outputs` with the step's result before leaving: a value the
    step returns is written even where only its fusion reads it."""

    def __init__(self, inputs=()):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.trace = Trace()
        self._depth = 0
        self._entered = 0
        self._local = WeakIdKeyDictionary()
        # the storages the step allocates, numbered, and each allocation
        # and release in order: (storage number, +bytes or -bytes)
        self._stores = WeakIdKeyDictionary()
        self._events = []
        self._n_stores = 0
        self._allocated = set()
        self._store_of = {}                  # buffer -> storage number
        # the op log: (class, reads, writes); a read is (buffer, bytes,
        # view), a write (buffer, bytes); a buffer is an int
        self._log = []
        self._sid = WeakIdKeyDictionary()    # storage -> its buffer now
        self._cap = {}                       # buffer -> its storage bytes
        self._next = 0
        self._out = set()
        self._args = WeakIdKeyDictionary()   # argument storage -> buffer
        for t in _tensors(inputs):
            t = t._local_tensor if isinstance(t, DTensor) else t
            self._local[t] = True
            self._args[t.untyped_storage()] = self._buffer(t)

    def outputs(self, tree) -> None:
        """Mark the tensors of ``tree`` as the step's outputs."""
        for t in _tensors(tree):
            if isinstance(t, self._dtensor):
                t = t._local_tensor
            self._out.add(self._buffer(t))

    def __enter__(self):
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered -= 1
        if self._entered:                    # DTensor's re-dispatch
            return super().__exit__(*exc)
        # an argument written in place returns in its new version (the
        # reference donates it to the step's outputs)
        for st, b in list(self._args.items()):
            if self._sid.get(st, b) != b:
                self._out.add(self._sid[st])
        self.trace.bytes, kept = _fused_bytes(self._log, self._cap,
                                              self._out)
        self.trace.temp_bytes = self._temp_peak(kept)
        self._log = []
        self._events = None
        return super().__exit__(*exc)

    def _temp_peak(self, kept) -> int:
        """The peak of the live bytes of the storages that hold a buffer
        the fusion model materializes (``kept``: written by an op that
        is no elementwise one, or read outside its fusion, or a step
        output), less the step's outputs: XLA holds no intermediate of
        a fusion, and counts outputs and arguments apart from its
        temporaries."""
        out = {self._store_of.get(b) for b in self._out}
        held = {self._store_of[b] for b in kept if b in self._store_of} - out
        live = peak = 0
        for n, nbytes in self._events:
            if n in held:
                live += nbytes
                peak = max(peak, live)
        return peak

    # ------------------------------------------------------------------ #
    def _new(self, nbytes: int) -> int:
        self._next += 1
        self._cap[self._next] = nbytes
        return self._next

    def _buffer(self, t) -> int:
        """The buffer ``t`` reads now (its storage's current version)."""
        st = t.untyped_storage()
        b = self._sid.get(st)
        if b is None:
            b = self._new(st.nbytes())
            self._sid[st] = b
            self._store_of[b] = self._number(st)
        return b

    def _write(self, t) -> int:
        """A new version of ``t``'s storage, written now."""
        st = t.untyped_storage()
        self._buffer(t)
        b = self._new(st.nbytes())
        self._sid[st] = b
        self._store_of[b] = self._number(st)
        return b

    def _number(self, st) -> int:
        n = self._stores.get(st)
        if n is None:
            n = self._stores[st] = self._n_stores
            self._n_stores += 1
        return n

    def _read(self, t) -> tuple:
        return (self._buffer(t), min(_nbytes(t), t.untyped_storage().nbytes()),
                (t.storage_offset(), tuple(t.shape), tuple(t.stride()),
                 t.dtype))

    def _free(self, n, nbytes):
        if self._events is not None:
            self._events.append((n, -nbytes))

    def _alloc(self, t):
        """Count ``t``'s storage live from now until it is released (once
        a storage: a second result in it is a view)."""
        st = t.untyped_storage()
        n = self._number(st)
        if n in self._allocated:
            return
        self._allocated.add(n)
        nbytes = st.nbytes()
        self._events.append((n, nbytes))
        weakref.finalize(st, self._free, n, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            if self._depth:
                return NotImplemented   # let DTensor run it
            self._depth += 1
            try:
                with self:
                    return func(*args, **kwargs)
            finally:
                self._depth -= 1
        ins = list(_tensors((args, kwargs)))
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if self._depth:
            if name in _FACTORIES or not any(a in self._local
                                             for a in ins):
                return out     # DTensor's shape propagation
        outs = list(_tensors(out))
        for o in outs:
            self._local[o] = True
        if name == "wait_tensor":
            return out
        kind = _COLL_KINDS.get(name) if "c10d" in str(
            func._overloadpacket) else None
        if kind is not None:
            self.trace.collectives.append(
                (kind, float(sum(_nbytes(o) for o in outs)),
                 _group_size(args)))
        rets = func._schema.returns
        if not outs:
            return out         # no tensor made (a shape or device query)
        inplace = any(r.alias_info is not None and r.alias_info.is_write
                      for r in rets)
        if all(r.alias_info is not None and not r.alias_info.is_write
               for r in rets) or not inplace and kind is None and all(
                   any(o.untyped_storage() is a.untyped_storage()
                       for a in ins) for o in outs):
            return out         # a view (``_unsafe_view`` too): no work
        if name in _EMPTY:
            for o in outs:
                self._write(o)
                self._alloc(o)
            return out
        self._log_op(func, name, args, kwargs, ins, out, outs, kind)
        if not inplace:
            for o in outs:
                self._alloc(o)
        return out

    def _log_op(self, func, name, args, kwargs, ins, out, outs, kind):
        tr = self.trace
        reads = tuple(self._read(a) for a in ins)
        if func._overloadpacket in flop_registry:
            f = flop_registry[func._overloadpacket](*args, **kwargs,
                                                     out_val=out)
            tr.flops += f
            tr.matmul_flops += f
            if len(outs) == 1 and outs[0].dtype in (torch.bfloat16,
                                                    torch.float16):
                self._product_via_f32(reads, ins, outs)
                return
            self._log.append((_OTHER, reads,
                              tuple((self._write(o), _nbytes(o))
                                    for o in outs)))
            return
        pointwise = (torch.Tag.pointwise in func.tags
                     or name in _ELEMENTWISE)
        n_out = sum(o.numel() for o in outs)
        if name == "copy_" and _nbytes(args[0]) < \
                args[0].untyped_storage().nbytes():
            # a write into part of a buffer: XLA's dynamic-update-slice
            dst = args[0]
            whole = dst.untyped_storage().nbytes()
            b0 = self._buffer(dst)
            reads = ((b0, whole, None),) + tuple(self._read(a)
                                                 for a in ins[1:])
            # XLA charges the update twice: read, and written in place
            upd = sum(r[1] for r in reads[1:])
            self._log.append((_OTHER, reads,
                              ((self._write(dst), whole + upd),)))
            return
        if kind is None and pointwise:
            if name in _ACTIVATIONS:
                f, t = _ACTIVATIONS[name]
            elif name in _TRANSCENDENTAL or name in (
                    "pow", "float_power") and not _integer_power(args):
                f, t = 0, 1
            elif name in _NO_FLOPS:
                f = t = 0
                if name in ("_to_copy", "copy_", "copy") and ins and \
                        outs and ins[-1].dtype != outs[0].dtype:
                    f = 1                   # a cast (XLA's convert)
            else:
                f, t = 1, 0
            tr.flops += f * n_out
            tr.transcendentals += t * n_out
            if name in _NO_FLOPS:
                tr.cast_flops += f * n_out
            self._log.append((_EW, reads, tuple(
                (self._write(o), _nbytes(o)) for o in outs)))
            return
        if name in ("_softmax", "_log_softmax",
                    "_softmax_backward_data", "_log_softmax_backward_data"):
            self._softmax(name, args, reads, outs)
            return
        if kind is None and name in _REDUCTIONS and ins:
            tr.flops += ins[0].numel()
        self._log.append((_OTHER, reads, tuple(
            (self._write(o), _nbytes(o)) for o in outs)))

    def _product_via_f32(self, reads, ins, outs):
        """A bf16/f16-result product as the CPU backend runs it: each
        operand cast to f32 (elementwise, so it fuses with its producer),
        the f32 product, and the cast of its result back."""
        tr, log = self.trace, self._log
        f32 = []
        for (b, nb, view), a in zip(reads, ins):
            if a.dtype in (torch.bfloat16, torch.float16):
                wide = self._new(a.numel() * 4)
                log.append((_EW, ((b, nb, view),), ((wide, a.numel() * 4),)))
                tr.flops += a.numel()
                tr.cast_flops += a.numel()
                f32.append((wide, a.numel() * 4, None))
            else:
                f32.append((b, nb, view))
        (o,) = outs
        wide = self._new(o.numel() * 4)
        log.append((_OTHER, tuple(f32), ((wide, o.numel() * 4),)))
        log.append((_EW, ((wide, o.numel() * 4, None),),
                    ((self._write(o), _nbytes(o)),)))
        tr.flops += o.numel()
        tr.cast_flops += o.numel()

    def _softmax(self, name, args, reads, outs):
        """softmax and its kin as XLA runs them: reductions over the last
        dim and elementwise passes between them."""
        tr, log = self.trace, self._log
        (o,) = outs
        n, nb = o.numel(), _nbytes(o)
        rows = n // max(o.shape[-1], 1) if o.dim() else 1
        rb = nb // max(o.shape[-1], 1) if o.dim() else nb
        def red(src):
            b = self._new(rb)
            log.append((_OTHER, (src,), ((b, rb),)))
            return (b, rb, None)
        def ew(srcs, dst=None):
            b = self._new(nb) if dst is None else dst
            log.append((_EW, tuple(srcs), ((b, nb),)))
            return (b, nb, None)
        if name == "_softmax":                 # max, exp(x-m), sum, e/s
            (x,) = reads[:1]
            m = red(x)
            e = ew((x, m))
            s = red(e)
            ew((e, s), self._write(o))
            tr.flops += 4 * n
            tr.transcendentals += n
        elif name == "_log_softmax":           # max, exp(x-m), sum, x-m-log s
            (x,) = reads[:1]
            m = red(x)
            e = ew((x, m))
            s = red(e)
            ew((x, m, s), self._write(o))
            tr.flops += 5 * n
            tr.transcendentals += n + rows
        elif name == "_softmax_backward_data":  # y*(g - sum(g*y))
            g, y = reads[:2]
            gy = ew((g, y))
            s = red(gy)
            ew((g, y, s), self._write(o))
            tr.flops += 4 * n
        else:                                   # g - exp(y)*sum(g)
            g, y = reads[:2]
            s = red(g)
            ew((g, y, s), self._write(o))
            tr.flops += 3 * n
            tr.transcendentals += n


def _integer_power(args) -> bool:
    e = args[1] if len(args) > 1 else None
    return isinstance(e, (int, float)) and float(e).is_integer()


def _fused_bytes(log, cap, step_out) -> tuple:
    """(bytes, the buffers written) of the op log ``log`` (module
    docstring): elementwise ops grouped into fusions (union-find) along
    the producer-consumer edges of values with one reader, each group
    charged what enters it and what leaves it; every other entry its
    operands and results."""
    parent = list(range(len(log)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def group(i):
        return find(i) if log[i][0] == _EW else ~i

    producer, readers = {}, {}
    for i, (_, reads, writes) in enumerate(log):
        for b, _ in writes:
            producer[b] = i
        for b, _, _ in reads:
            readers.setdefault(b, set()).add(i)
    for i, (cls, reads, _) in enumerate(log):
        for b, _, _ in reads:
            j = producer.get(b)
            if cls == _EW and j is not None and log[j][0] == _EW and \
                    len(readers[b]) == 1:
                parent[find(i)] = find(j)
    total = 0.0
    kept = set()                  # the buffers written out of a fusion
    seen = set()                  # (group, buffer, view) reads charged
    per_buf = {}                  # (group, buffer) -> bytes charged
    for i, (cls, reads, writes) in enumerate(log):
        g = group(i)
        for b, nb, view in reads:
            j = producer.get(b)
            if (g, b, view) in seen or j is not None and group(j) == g:
                continue          # read already, or made inside the fusion
            seen.add((g, b, view))
            have = per_buf.get((g, b), 0)
            add = max(0, min(nb, cap.get(b, nb) - have))
            per_buf[(g, b)] = have + add
            total += add
        for b, nb in writes:
            if cls != _EW or b in step_out or any(
                    group(r) != g for r in readers.get(b, ())):
                total += nb
                kept.add(b)
    return total, kept


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@functools.lru_cache(maxsize=None)
def _size_of_group(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _group_size(args) -> int:
    """The group size of a ``_c10d_functional`` op (its last string
    argument names its group)."""
    return _size_of_group(next(a for a in reversed(args)
                               if isinstance(a, str)))


def memory_stats(trace: Trace) -> dict:
    mem = {"argument_bytes": int(trace.argument_bytes),
           "output_bytes": int(trace.output_bytes),
           "temp_bytes": int(trace.temp_bytes),
           "alias_bytes": int(trace.alias_bytes)}
    mem["total_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                          + mem["temp_bytes"] - mem["alias_bytes"])
    return mem


def cost_analysis(trace: Trace) -> dict:
    """The trace's counterpart of XLA's ``cost_analysis()`` dict."""
    return {"flops": float(trace.flops), "bytes accessed": float(trace.bytes),
            "transcendentals": float(trace.transcendentals)}


def costs_of(trace: Trace) -> dict:
    cost = cost_analysis(trace)
    stats = collectives_of(trace.collectives)
    return {
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "coll_raw": stats.raw_bytes,
        "coll_modeled": stats.modeled_bytes,
        "coll_counts": stats.counts,
        "coll_by_kind": stats.by_kind,
    }


def make_roofline(flops, bytes_accessed, coll_raw, coll_modeled, coll_counts,
                  mem, model_flops_per_device,
                  peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                  link_bw: float = LINK_BW) -> Roofline:
    compute_s = flops / peak_flops
    memory_s = bytes_accessed / hbm_bw
    collective_s = coll_modeled / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        flops=flops, bytes_accessed=bytes_accessed,
        coll_bytes_raw=coll_raw, coll_bytes_modeled=coll_modeled,
        coll_counts=coll_counts,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops_per_device,
        useful_ratio=(model_flops_per_device / flops) if flops else 0.0,
        memory_per_device=mem,
    )


def analyze(trace: Trace, model_flops_per_device: float,
            peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
            link_bw: float = LINK_BW) -> Roofline:
    c = costs_of(trace)
    return make_roofline(c["flops"], c["bytes"], c["coll_raw"],
                         c["coll_modeled"], c["coll_counts"],
                         memory_stats(trace), model_flops_per_device,
                         peak_flops, hbm_bw, link_bw)


def extrapolate_costs(base: dict, bigger: dict, l1: float, l2: float,
                      n_units: float) -> dict:
    """Linear-in-depth cost model from two traces at depths l1 < l2:
    total(n) = intercept + n * slope, with slope from the diff.
    Collective counts are extrapolated the same way."""
    out = {}
    for k in ("flops", "bytes", "coll_raw", "coll_modeled"):
        slope = (bigger[k] - base[k]) / (l2 - l1)
        out[k] = max(base[k] - l1 * slope, 0.0) + n_units * slope
    counts = {}
    for kind in set(base["coll_counts"]) | set(bigger["coll_counts"]):
        c1 = base["coll_counts"].get(kind, 0)
        c2 = bigger["coll_counts"].get(kind, 0)
        slope = (c2 - c1) / (l2 - l1)
        counts[kind] = int(round(max(c1 - l1 * slope, 0) + n_units * slope))
    out["coll_counts"] = counts
    return out


def ssm_scan_correction(cfg, shape, n_chips: int) -> tuple[float, float]:
    """(extra_flops, extra_bytes) per device for the sequence recurrence
    that a compiler's cost model counts once (the scan body): modeled at
    the *chunked scan kernel*'s cost — state resident on chip, inputs
    streamed once.

    mamba1 per token per layer: dA exp + dBu + h-update + y=h·C ≈ 7·Di·N
    FLOPs; stream u,dt (fp32) + B,C + y ≈ (3·Di + 2·N)·4 bytes.
    mamba2: ≈ 6·Di·N FLOPs (scalar-A heads), same streaming shape.
    Sharding: Di over TP(16), tokens over DP — ≈ /n_chips overall.
    """
    if cfg.family not in ("ssm", "hybrid") or shape.mode == "decode":
        return 0.0, 0.0
    tokens = shape.seq_len * shape.global_batch
    Di, N = cfg.d_inner, cfg.ssm_state
    c = 7.0 if cfg.mamba_version == 1 else 6.0
    flops_tok_layer = c * Di * N
    bytes_tok_layer = (3 * Di + 2 * N) * 4.0
    mult = 3.0 if shape.mode == "train" else 1.0  # bwd ≈ 2x fwd re-scan
    total_flops = cfg.n_layers * tokens * flops_tok_layer * mult
    total_bytes = cfg.n_layers * tokens * bytes_tok_layer * mult
    return total_flops / n_chips, total_bytes / n_chips


def model_flops(cfg, shape, n_chips: int) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (N = active params), 2·N·D forward
    (prefill), 2·N per token (decode) — per device.

    Encoder-decoder (audio): the encoder's params see `encoder_seq` frames
    per sample, not the decoder's token count — counted separately."""
    n_active = cfg.active_param_count()
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.mode]
    if cfg.family == "audio":
        D = cfg.d_model
        att = (D * cfg.n_heads * cfg.resolved_head_dim
               + 2 * D * cfg.n_kv_heads * cfg.resolved_head_dim
               + cfg.n_heads * cfg.resolved_head_dim * D)
        enc_params = cfg.n_encoder_layers * (att + 3 * D * cfg.d_ff + 2 * D)
        dec_params = n_active - enc_params
        if shape.mode == "decode":
            dec_tokens = shape.global_batch
            enc_tokens = 0  # encoder output precomputed in the cache
        else:
            dec_tokens = shape.seq_len * shape.global_batch
            enc_tokens = cfg.encoder_seq * shape.global_batch
        total = mult * (dec_params * dec_tokens + enc_params * enc_tokens)
        return total / n_chips
    if shape.mode == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.seq_len * shape.global_batch
    return mult * n_active * tokens / n_chips
