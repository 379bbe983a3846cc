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
and collectives:

* ``flops``: the matmul FLOPs of the local ops (``torch.utils.
  flop_counter``'s formulas on local shapes), so per device with no
  division by the chip count, replicated work counted on every rank.
  XLA's cost analysis also counts elementwise work; these are matmul
  FLOPs only.
* ``bytes``: each local op's tensor operands and results, summed (XLA's
  "bytes accessed", per op; unfused, so an upper bound on what a fused
  program moves). The memory term built on it, and with it the dominant
  term, does not read as the reference's: the dry run marks its result
  ``dominant_comparable: False``.
* collectives: each ``_c10d_functional`` op with the reference's
  conventions — ``s`` = bytes of the per-device result (the gathered
  size for all-gather, the scattered shard for reduce-scatter), N = the
  group size — and its ring-model traffic (all-reduce 2·s·(N-1)/N,
  all-gather s·(N-1)/N, reduce-scatter s·(N-1), all-to-all s·(N-1)/N,
  permute s).
* memory: argument, output and alias bytes from the step's inputs and
  outputs, and temp = the peak of live local bytes beyond the arguments.

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


@dataclasses.dataclass
class Trace:
    """What one traced step did on one device (every number local)."""
    flops: float = 0.0
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


class Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Records a :class:`Trace` of the local work under it.

    A DTensor op is re-dispatched with the recorder still on, so it sees
    the local ops and collectives DTensor runs for it. Of those it counts
    only the ones that read a local tensor: the inputs' shards and what
    was made from them (DTensor also runs each new op once on global-size
    fake tensors to learn the output's shape; those are not the device's
    work). Outside a DTensor op every op counts (a ``shard_map`` body,
    the model's own small tensors)."""

    def __init__(self, inputs=()):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.trace = Trace()
        self._depth = 0
        self._local = WeakIdKeyDictionary()
        self._live = 0
        self._peak = 0
        self._stores = WeakIdKeyDictionary()
        for t in _tensors(inputs):
            self._local[t._local_tensor if isinstance(t, DTensor)
                        else t] = True

    def __exit__(self, *exc):
        self.trace.temp_bytes = self._peak
        return super().__exit__(*exc)

    def _free(self, nbytes):
        self._live -= nbytes

    def _alloc(self, t):
        st = t.untyped_storage()
        if st in self._stores:
            return
        self._stores[st] = True
        nbytes = st.nbytes()
        self._live += nbytes
        self._peak = max(self._peak, self._live)
        weakref.finalize(st, self._free, nbytes)

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
        kind = _COLL_KINDS.get(name) if "c10d" in str(
            func._overloadpacket) else None
        if kind is not None:
            self.trace.collectives.append(
                (kind, float(sum(o.numel() * o.element_size()
                                 for o in outs)), _group_size(args)))
        if func._overloadpacket in flop_registry:
            self.trace.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        views = any(r.alias_info is not None for r in func._schema.returns)
        if name != "wait_tensor":
            self.trace.bytes += sum(t.numel() * t.element_size()
                                    for t in ins + ([] if views else outs))
        if not views:
            for o in outs:
                self._alloc(o)
        return out


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
    return {"flops": float(trace.flops), "bytes accessed": float(trace.bytes)}


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
