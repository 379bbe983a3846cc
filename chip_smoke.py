#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together) and drives the port on the
card, in phases:

0. card identity (name and power limit from ``nvidia-smi``) and kernel
   build time;
1. the GBDT kernel against its plain PyTorch version on the card, at the
   reference test sweep's shapes, depth-8 ensembles, the golden shape,
   ragged and remainder-leaving tree counts, and the production ensembles
   on the 768-row prefetch batch (bit for bit);
2. per-row kernel time vs batch size on the production ensemble, beside the
   plain version and host numpy (the routing crossover); the kernel at the
   golden-trace predictor's shape (64 rows, 80 trees of depth 3); and the
   card's launch floor, an empty kernel of the same library replayed from
   a CUDA graph as the kernel is;
3. the 17 golden traces reproduced exactly with ``device="cuda"``,
   through the kernel: the 12 base ones (6 policies x seeds 0, 1) and the
   five the beyond-paper layers pin (power cap, preemption fired and
   declined, tenant shedding and tier rescue), built as
   ``tests/test_golden.py`` builds them;
4. the main path at full size: the default predictor (400 trees of depth 4
   per regressor), a CUDA ``PredictionService`` with ``prefetch_tables``,
   and the 100 000-job uniform stream on 8 devices (min-energy); then the
   same on ``device="cpu"``, which must give identical records;
5. the flash-attention kernels (both routes: ``wgmma`` on the tensor cores
   for bf16, ``simt`` for the rest) and the Mamba-1 scan kernel against
   their plain PyTorch versions on the card: the reference test sweep's
   shapes, the window and right-aligned cases, and the serving shapes,
   each case printed with its route (fp32 2e-5; bf16 one output ulp,
   2**-7 relative, on the SIMT route, and 2**-9 max|v| more on the wgmma
   route, which rounds p to bf16);
6. their per-call times at the serving shapes, beside the plain versions,
   the bound, for attention the SIMT kernel at the same shape and
   PyTorch's own SDPA as a yardstick;
7. Mistral-NeMo-12B served at full width and depth (random bf16 weights
   from a seed): 4 prompts of 2048 tokens, then 32 greedy decode steps
   through ``greedy_generate``; every flash-attention launch of it must
   take the wgmma route. Prefill and decode are timed apart; one prefill
   is broken down by kernel (``torch.profiler``) and one decode step timed
   on the card alone (CUDA-graph replay). Then the same model at fp32 with
   2 layers, cuda against cpu, logits within 1e-3; and at bf16 with 2
   layers, a prefill through the kernel against one through the plain
   attention (logits within 2**-4, the same next tokens);
8. Falcon-Mamba-7B, the same way (without the bf16 attention check);
9. the beyond-paper scheduler layers at full size, on the card and on the
   CPU, records equal field for field (provenance fields included): the
   tiers scenario of ``benchmarks/bench_tenants.py`` (2500 jobs at 10x
   overload on 2 v5p + 4 v5e + 2 v5lite, the default predictor) with
   admission, a slack-weighted power cap, preemption and the online GBDT
   corrector all attached; then ``benchmarks/bench_online.py``'s 1000-job
   drifting stream with the RLS and with the GBDT corrector. Sheds,
   preemptions and drift resets must all happen. The GBDT kernel is held
   bit for bit to its plain version on the corrector's ensembles (30 trees
   of depth 2 over 3 features) at 1, 24 and 64 rows, and timed there
   beside host numpy.

Ends with a JSON line of per-kernel numbers, the card line, and
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when CUDA is absent or any phase fails. Needs one card:

    python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "schedule_traces.json"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp64 without
#: tensor cores — the kernel compares and adds in fp64.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
#: ... and the dense bf16 tensor-core and fp32 (non-tensor) rates
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
REL_TOL = 1e-12
N_JOBS = 100_000
N_DEVICES = 8
ROW_SIZES = (1, 64, 512, 768, 4096, 65536)
#: (atol, rtol). fp32: the reference sweep's tolerance, the summation
#: order being the only difference; bf16: one ulp of the output, since
#: kernel and plain version both compute in fp32 and round once.
F32_TOL = (2e-5, 2e-5)
BF16_TOL = (1e-6, 2.0 ** -7)
#: cuda vs cpu logits of an fp32 model (O(1) logits; fp32 matmuls summed
#: in another order differ by ~1e-5, a wrong kernel by O(1))
CPU_TOL = (1e-3, 1e-3)
#: a bf16 model's logits with the attention kernel against the plain
#: attention: every bf16 op rounds at 2**-8 relative, so an attention
#: output one ulp away moves later roundings and O(1) logits by a few
#: ulps (2**-6 .. 2**-5); a wrong kernel moves them by O(1)
BF16_MODEL_TOL = (2.0 ** -4, 2.0 ** -4)
#: (B, S, Hq, Hkv, hd), Sk (None: = S), options: tests/test_kernels.py's
#: sweep, its windows, and right-aligned queries
ATTN_SWEEP = (
    ((1, 32, 4, 4, 16), None, {}), ((2, 64, 8, 2, 32), None, {}),
    ((1, 128, 15, 5, 64), None, {}), ((1, 48, 6, 1, 80), None, {}),
    ((2, 40, 4, 2, 128), None, {}),
    ((1, 96, 4, 4, 32), None, {"window": 4}),
    ((1, 96, 4, 4, 32), None, {"window": 16}),
    ((1, 96, 4, 4, 32), None, {"window": 64}),
    ((2, 5, 4, 2, 16), 40, {"window": 8}),
    ((1, 300, 8, 2, 96), None, {"window": 100}),
    ((1, 33, 4, 2, 112), None, {"causal": False}),
    ((2, 70, 4, 2, 20), None, {"window": 24}),   # bf16 too: SIMT route
)
SCAN_SWEEP = ((1, 16, 8, 4), (2, 64, 32, 16), (1, 40, 24, 8), (2, 33, 20, 8))
#: the serving shapes: Mistral-NeMo-12B's attention and Falcon-Mamba-7B's
#: scan for 4 prompts of 2048 tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
SERVE_ATTN = (SERVE_BATCH, SERVE_PROMPT, 32, 8, 128)
SERVE_SCAN = (SERVE_BATCH, SERVE_PROMPT, 8192, 16)
#: the golden traces of the beyond-paper layers (tests/test_golden.py)
LAYER_KEYS = ("min-energy|cap|0", "min-energy|preempt-fire|0",
              "min-energy|preempt-decline|0", "min-energy|tenant-shed|0",
              "min-energy|tenant-rescue|0")
#: phase 9: benchmarks/bench_tenants.py's tiers scenario at full size, with
#: a slack-weighted cap at the pool's idle floor plus CAP_FRAC of its
#: sprint headroom (each class's power model at max clock, full load)
TENANT_POOL = (("v5p", 2), ("v5e", 4), ("v5lite", 2))
TENANT_JOBS, TENANT_OVERLOAD, TENANT_QUANTUM = 2500, 10.0, 0.25
TENANT_LOOKAHEAD_S, CAP_FRAC = 30.0, 0.55
#: ... and benchmarks/bench_online.py's drifting stream and detector tuning
ONLINE_JOBS = 1000
DRIFT_APPS = ("SYRK", "GEMM", "2MM")
DRIFT_KW = dict(warmup=10, k=0.75, threshold=10.0, min_ref_std=0.05,
                cooldown=5)
#: the corrector's batches: a v5e or v5p ladder, a v5lite ladder, and
#: the one-row innovation
CORRECTOR_ROWS = (1, 24, 64)


def _check(ok: bool, what: str) -> None:
    """A failed phase check: raise (asserts vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = want.abs().clamp_min(1e-300)
    return float(((got - want).abs() / scale).max())


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def _time_cuda(fn, reps: int) -> float:
    """Milliseconds per call on the card's timeline, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _time_enqueue(fn, reps: int) -> float:
    """Milliseconds per call on the host clock, without waiting for the
    card: the rate at which the host can issue calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def _time_graph(fn, reps: int) -> float:
    """Milliseconds per call on the card alone: ``reps`` calls captured in
    one CUDA graph and replayed, so no host work sits between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _time_cuda(graph.replay, 5) / reps


def _time_host(fn, reps: int) -> float:
    """Milliseconds per call on the host clock (best of ``reps``)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _random_ensemble(rng, n, T, depth, F, dev):
    X = torch.from_numpy(rng.normal(size=(n, F))).to(dev)
    feats = torch.from_numpy(
        rng.integers(0, F, size=(T, depth)).astype(np.int32)).to(dev)
    thr = torch.from_numpy(rng.normal(size=(T, depth))).to(dev)
    leaves = torch.from_numpy(rng.normal(size=(T, 2 ** depth))).to(dev)
    return X, feats, thr, leaves


def _round(x: float) -> float:
    return float(f"{x:.12g}")


def _digest(records) -> str:
    """The golden projection and hash of tests/test_golden.py."""
    trace = [[r.job_id, r.name, r.device, r.clock.core_mhz, r.clock.mem_mhz,
              _round(r.start), _round(r.end), _round(r.time_s),
              _round(r.power_w), _round(r.energy_j), int(r.met_deadline),
              int(r.had_feasible_clock)] for r in records]
    blob = json.dumps(trace, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _bound_ms(n: int, T: int, depth: int, F: int) -> tuple[float, str]:
    """Least time for one call: each input read once and the output written
    once at HBM rate, or the fp64 compares and adds at the fp64 rate."""
    nbytes = n * F * 8 + T * depth * (4 + 8) + T * (2 ** depth) * 8 + n * 8
    ops = n * T * (depth + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f}"


def _device_breakdown(fn, top: int = 6) -> str:
    """Card time of one call of ``fn`` by kernel, from ``torch.profiler``
    (CUPTI): the busy total against the host wall, and the ``top`` kernels
    by self device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: a CPU op carries its kernels' time as well
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    if not rows:
        return f"no device time recorded (wall {wall * 1e3:.3f} ms)"
    parts = [f"{us / 1e3:.3f} ms x{n} {name[:70]}"
             for us, n, name in rows[:top]]
    return (f"card busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall (profiled"
            f"); top kernels: " + "; ".join(parts))


def _reset(counters) -> None:
    """Every kernel's launch count to 0 (and per route or per batch size,
    where a kernel splits its count), just before a path is driven."""
    for mod in counters:
        mod.launches = 0
        for route in getattr(mod, "route_launches", {}):
            mod.route_launches[route] = 0
        getattr(mod, "rows_launches", {}).clear()


def _fields(rec) -> tuple:
    """Every field of an ExecutionRecord, the ``compare=False`` provenance
    fields included, with the clock as its (core, mem) scales."""
    return tuple((f.name, (getattr(rec, f.name).s_core,
                           getattr(rec, f.name).s_mem)
                  if f.name == "clock" else getattr(rec, f.name))
                 for f in dataclasses.fields(rec))


def _layer_goldens(core, apps, tb, pred, feats, dev) -> dict:
    """The five golden runs of the beyond-paper layers, built as
    tests/test_golden.py builds them. Returns ``{key: (result, layer)}``
    with the layer object that proves the scenario live."""
    kw = dict(predictor=pred, app_features=feats, device=dev)
    out = {}
    jobs = core.make_workload(apps, tb, seed=0)
    out[LAYER_KEYS[0]] = (core.run_schedule(
        jobs, "min-energy", core.Testbed(seed=100), n_devices=2,
        power_coordinator=core.PowerCapCoordinator(
            120.0, grant_policy="slack-weighted", guard=0.2), **kw), None)
    jobs = list(core.rescue_stress_workload(apps, tb, n_jobs=12, seed=0,
                                            n_devices=1))
    mgr = core.PreemptionManager()
    out[LAYER_KEYS[1]] = (core.run_schedule(
        jobs, "min-energy", core.Testbed(seed=100), preemption=mgr, **kw),
        mgr)
    jobs = [dataclasses.replace(j, checkpoint_quantum=0.5)
            for j in core.make_workload(apps, tb, seed=0)]
    mgr = core.PreemptionManager()
    out[LAYER_KEYS[2]] = (core.run_schedule(
        jobs, "min-energy", core.Testbed(seed=100), preemption=mgr, **kw),
        mgr)
    jobs = list(core.multi_tenant_workload(apps, tb, n_jobs=60, seed=0,
                                           n_devices=2, overload=8.0))
    adm = core.AdmissionController(lookahead_s=20.0, threshold=0.5)
    out[LAYER_KEYS[3]] = (core.run_schedule(
        jobs, "min-energy", core.Testbed(seed=100), n_devices=2,
        admission=adm, **kw), adm)
    by_name = {a.name: a for a in apps}
    whale_app, short_app = by_name["lavaMD"], by_name["particlefilter_float"]
    t_w = tb.true_time(whale_app, tb.dvfs.default_clock)
    t_s = tb.true_time(short_app, tb.dvfs.default_clock)
    whale = dataclasses.replace(
        core.Job(app=whale_app, arrival=0.0, deadline=0.5 * t_w, job_id=0,
                 checkpoint_quantum=0.2), tier=core.BEST_EFFORT_TIER)
    s1 = dataclasses.replace(
        core.Job(app=short_app, arrival=0.25 * t_w,
                 deadline=0.25 * t_w + 1.7 * t_s, job_id=1),
        tier=core.SLO_TIER)
    s2 = dataclasses.replace(
        core.Job(app=short_app, arrival=0.25 * t_w + 0.2,
                 deadline=0.25 * t_w + 0.2 + 2.2 * t_s, job_id=2),
        tier=core.SLO_TIER)
    mgr = core.PreemptionManager()
    out[LAYER_KEYS[4]] = (core.run_schedule(
        [whale, s1, s2], "min-energy", core.Testbed(seed=100),
        preemption=mgr, **kw), mgr)
    return out


def _tenant_run(core, apps, tb, pred, feats, dev):
    """Phase 9's all-layers run: the tiers scenario with admission, the
    capped coordinator, preemption and the GBDT corrector attached."""
    pool = core.make_device_pool(*((core.DEVICE_CLASSES[n], k)
                                   for n, k in TENANT_POOL))
    idle = sum(c.idle_power() for c in pool)
    sprint = sum(c.dvfs.power(c.dvfs.max_clock, 1.0, 1.0) for c in pool)
    jobs = list(core.multi_tenant_workload(
        apps, tb, n_jobs=TENANT_JOBS, seed=0, pool=pool,
        overload=TENANT_OVERLOAD, quantum_frac=TENANT_QUANTUM))
    svc = core.PredictionService(tb.dvfs, predictor=pred, app_features=feats,
                                 testbed=tb, device=dev)
    layers = dict(
        adapter=core.OnlineAdapter(svc, corrector="gbdt"),
        coord=core.PowerCapCoordinator(idle + CAP_FRAC * (sprint - idle),
                                       grant_policy="slack-weighted"),
        mgr=core.PreemptionManager(),
        adm=core.AdmissionController(lookahead_s=TENANT_LOOKAHEAD_S))
    res = core.run_schedule(
        jobs, "min-energy", core.Testbed(seed=100), service=svc,
        device_classes=pool, feedback=layers["adapter"],
        power_coordinator=layers["coord"], preemption=layers["mgr"],
        admission=layers["adm"], device=dev)
    return res, layers


def _online_run(core, apps, tb, pred, feats, dev, corrector):
    """Phase 9's online run: bench_online's corrected run on the drifting
    stream."""
    svc = core.PredictionService(tb.dvfs, predictor=pred, app_features=feats,
                                 testbed=tb, device=dev)
    adapter = core.OnlineAdapter(svc, corrector=corrector,
                                 drift=core.DriftConfig(**DRIFT_KW),
                                 risk_scale=1.0, max_margin=0.2)
    jobs = core.drifting_workload(apps, tb, n_jobs=ONLINE_JOBS, seed=0,
                                  n_devices=1, drift_names=list(DRIFT_APPS))
    policy = core.RiskAware(tb.dvfs, margin=0.02, margin_fn=adapter.margin)
    res = core.run_schedule(jobs, policy, core.Testbed(seed=100),
                            service=svc, feedback=adapter, device=dev)
    return res, dict(adapter=adapter)


def _layers(core, gp, ops, ref, counters, apps, tb, preds, feats, dev,
            card) -> dict:
    """Phase 9: the beyond-paper layers at full size, cuda against cpu,
    then the GBDT kernel on the corrector's ensembles. Returns the K1
    numbers of this path."""
    print(f"== phase 9: the beyond-paper layers at full size; card {card}")
    runs = {"tenants": lambda d, p: _tenant_run(core, apps, tb, p, feats,
                                                d),
            "online-rls": lambda d, p: _online_run(core, apps, tb, p, feats,
                                                   d, "rls"),
            "online-gbdt": lambda d, p: _online_run(core, apps, tb, p, feats,
                                                    d, "gbdt")}
    launches, by_rows, fitted = {}, {}, None
    for name, run in runs.items():
        out = {}
        for label, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            _reset(counters)                         # this slice's path
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, layers = run(d, preds[label])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if label == "cuda":
                launches[name] = gp.launches
                by_rows[name] = dict(sorted(gp.rows_launches.items()))
                corr = layers["adapter"].corrector
                if fitted is None and getattr(corr, "_fits", None):
                    fitted = next(iter(corr._fits.values()))[1]
            out[label] = res, layers
            ad = layers["adapter"]
            n = len(res.records)
            extra = ""
            if name == "tenants":
                stats = [layers[k].stats.summary()
                         for k in ("adm", "coord", "mgr")]
                extra = (f"; shed {res.shed_count}, preemptions "
                         f"{res.preemptions}, misses by tier "
                         f"{res.misses_by_tier()}; " + "; ".join(stats))
            n_jobs = TENANT_JOBS if name == "tenants" else ONLINE_JOBS
            print(f"   {name} [{label}]: {n_jobs} jobs, {n} records in "
                  f"{wall:.3f} s = "
                  f"{n / wall:.1f} records/s (host clock); total_energy "
                  f"{float(res.total_energy)!r} J; misses {res.misses}; drift "
                  f"resets {ad.n_drifts} ({ad.summary()}){extra}",
                  flush=True)
        (rc, lc), (rh, lh) = out["cuda"], out["cpu"]
        _check(len(rc.records) == len(rh.records)
               and all(_fields(a) == _fields(b)
                       for a, b in zip(rc.records, rh.records))
               and [j.job_id for j in rc.shed] == [j.job_id
                                                    for j in rh.shed],
               f"{name}: cuda vs cpu records, field for field")
        _check(launches[name] > 0, f"{name}: the kernel never launched")
        _check(lc["adapter"].n_drifts > 0 if name != "tenants"
               else rc.shed_count > 0 and rc.preemptions > 0,
               f"{name}: the layers fired")
        print(f"   {name}: cuda == cpu field for field; kernel launches "
              f"{launches[name]}, by batch rows {by_rows[name]}",
              flush=True)

    # the kernel on the corrector's ensembles, against its plain version
    _check(fitted is not None, "the GBDT corrector fitted no model")
    tabs = fitted.device_tables()
    T, depth = tabs[0].shape
    host_tabs = tuple(a.cpu().numpy() for a in tabs)
    clocks = core.V5E_DVFS.clock_list()
    Z = np.stack([core.online.clock_basis(c) for c in clocks])
    print(f"   the corrector's time ensemble ({T} trees of depth {depth} "
          f"over {Z.shape[1]} features), ms per call: wrapper "
          f"(GBDTModel.predict: copy in, launch, copy back; host clock), "
          f"host numpy, plain on the card and the kernel alone (CUDA "
          f"graph replay); the kernel is bitwise equal to plain")
    timing, worst = {}, 0.0
    for n in CORRECTOR_ROWS:
        Zn = Z[:n]
        Zt = torch.from_numpy(Zn).to(dev)
        got = ops.gbdt_predict(Zt, *tabs, fitted.base)
        want = ref.gbdt_predict_ref(Zt, *tabs, fitted.base)
        torch.cuda.synchronize()
        _check(bool(torch.equal(got, want)),
               f"corrector ensemble, {n} rows: kernel vs plain")
        worst = max(worst, float((got - want).abs().max()))
        out_t = torch.empty(n, dtype=torch.float64, device=dev)
        w_ms = _time_host(lambda: fitted.predict(Zn), 200)
        h_ms = _time_host(lambda: ref.gbdt_predict_numpy(Zn, *host_tabs,
                                                         fitted.base), 200)
        p_ms = _time_cuda(lambda: ref.gbdt_predict_ref(Zt, *tabs,
                                                       fitted.base), 20)
        d_ms = _time_graph(lambda: gp.launch(Zt, *tabs, fitted.base, out_t),
                           50)
        b_ms, b_by = _bound_ms(n, T, depth, Z.shape[1])
        timing[n] = dict(wrapper_ms=w_ms, numpy_ms=h_ms, plain_ms=p_ms,
                         device_ms=d_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"   {n:3d} rows: wrapper {w_ms:.6f}  numpy {h_ms:.6f}  "
              f"plain {p_ms:.6f}  kernel {d_ms:.6f}  bound {b_ms:.9f} "
              f"({b_by})")
    ones = sum(r.get(1, 0) for r in by_rows.values())
    print(f"   1-row launches in phase 9's cuda runs: {ones}; at the "
          f"wrapper's {timing[1]['wrapper_ms']:.6f} ms that is "
          f"{ones * timing[1]['wrapper_ms'] / 1e3:.3f} s, host numpy would "
          f"take {ones * timing[1]['numpy_ms'] / 1e3:.3f} s", flush=True)
    return dict(launches=launches, by_rows=by_rows, timing=timing,
                max_abs_err=worst, shape=(T, depth, Z.shape[1]))


def _close(got: torch.Tensor, want: torch.Tensor, tol, what: str) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|
    everywhere."""
    atol, rtol = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    _check(bool((err <= atol + rtol * w.abs()).all()),
           f"{what}: max abs err {float(err.max())} beyond atol {atol}, "
           f"rtol {rtol}")
    return float(err.max())


def _attn_inputs(seed, B, Sq, Hq, Hkv, hd, dtype, dev, Sk=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    Sk = Sk or Sq
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                          (B, Sk, Hkv, hd))]


def _scan_inputs(seed, B, L, Di, N, dev):
    """The reference sweep's distribution: u, B, C ~ N(0,1); dt =
    softplus(N(0,1)) / 10; A = -exp(0.3 N(0,1)); D from 0.5 to 1.5."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa
    return [rnd(B, L, Di), F.softplus(rnd(B, L, Di)) * 0.1,
            -torch.exp(rnd(Di, N) * 0.3), rnd(B, L, N), rnd(B, L, N),
            torch.linspace(0.5, 1.5, Di, device=dev)]


def _attn_bound_ms(B, Sq, Sk, Hq, Hkv, hd, itemsize) -> tuple[float, str]:
    """Least time for one causal call: q, k, v read and out written once
    at HBM rate, or the two products over the live (query, key) pairs
    (4 hd operations each) at the bf16 tensor-core rate."""
    off = Sk - Sq
    live = sum(min(Sk, max(0, i + off + 1)) for i in range(Sq))
    ops = 4 * hd * B * Hq * live
    nbytes = itemsize * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _scan_bound_ms(B, L, Di, N) -> tuple[float, str]:
    """Least time for one scan: u, dt, A, B, C, D read and y, h_last
    written once at HBM rate (fp32), or the arithmetic — 7 operations per
    state update (dt*A, exp, two products, a sum, h*C and its sum) and 3
    per output (dt*u, D*u, a sum) — at the fp32 rate."""
    nbytes = 4 * (3 * B * L * Di + Di * N + 2 * B * L * N + Di + B * Di * N)
    ops = B * L * Di * (7 * N + 3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _plain_attn(ref, q, k, v, **kw):
    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw).transpose(1, 2)


def _attention_case(fa, ops, ref, q, k, v, kw, what) -> tuple[str, float,
                                                               tuple]:
    """One attention call through the wrapper against the plain version,
    at the tolerance of the route it took. Returns (route, max abs err,
    tolerance)."""
    before = dict(fa.route_launches)
    got = ops.flash_attention(q, k, v, **kw)
    want = _plain_attn(ref, q, k, v, **kw)
    torch.cuda.synchronize()
    taken = [r for r in fa.ROUTES if fa.route_launches[r] != before[r]]
    _check(len(taken) == 1, f"{what}: one route launched, got {taken}")
    tol = fa.tolerance(taken[0], q.dtype, v)
    return taken[0], _close(got, want, tol, f"{what} ({taken[0]})"), tol


def _kernels_vs_plain(dev, fa, ops, ref) -> dict:
    """Phase 5: the attention kernels (both routes) and the scan kernel
    against their plain versions on the card. Returns the serving shapes'
    inputs and max abs errors."""
    print("== phase 5: flash_attention and mamba_scan kernels vs plain "
          f"(fp32 tol {F32_TOL}, bf16 simt tol {BF16_TOL}, bf16 wgmma tol "
          "(2**-9 max|v|, 2**-7), as (atol, rtol))")
    routes = {r: 0 for r in fa.ROUTES}
    for (B, Sq, Hq, Hkv, hd), Sk, kw in ATTN_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attn_inputs(1, B, Sq, Hq, Hkv, hd, dtype, dev, Sk)
            route, err, tol = _attention_case(
                fa, ops, ref, q, k, v, kw,
                f"attention {(B, Sq, Hq, Hkv, hd)} Sk={Sk} {kw} {dtype}")
            routes[route] += 1
            print(f"   attention B={B} Sq={Sq} Sk={Sk or Sq} Hq={Hq} "
                  f"Hkv={Hkv} hd={hd} {kw} {str(dtype)[6:]} [{route}]: "
                  f"{err:.3e} (atol {tol[0]:.3e})")
    _check(all(routes.values()), f"the sweep took every route: {routes}")
    B, S, Hq, Hkv, hd = SERVE_ATTN
    qkv = _attn_inputs(2, B, S, Hq, Hkv, hd, torch.bfloat16, dev)
    route, attn_err, tol = _attention_case(fa, ops, ref, *qkv, {},
                                           "attention at the serving shape")
    _check(route == "wgmma", f"the serving shape took the {route} route")
    print(f"   attention serving shape B={B} S={S} Hq={Hq} Hkv={Hkv} "
          f"hd={hd} bf16 [{route}]: {attn_err:.3e} (atol {tol[0]:.3e}); "
          f"sweep cases by route {routes}", flush=True)
    for shape in SCAN_SWEEP + (SERVE_SCAN,):
        args = _scan_inputs(3, *shape, dev)
        y, h = ops.mamba_scan(*args)
        wy, wh = ref.mamba_scan_ref(*args)
        torch.cuda.synchronize()
        err = _close(y, wy, F32_TOL, f"scan y {shape}")
        herr = _close(h, wh, F32_TOL, f"scan h_last {shape}")
        print(f"   scan B,L,Di,N={shape}: y {err:.3e}, h_last {herr:.3e}",
              flush=True)
    return {"attn_inputs": qkv, "attn_err": attn_err, "scan_inputs": args,
            "scan_err": err}


def _kernel_times(fa, ops, ref, p5, card) -> dict:
    """Phase 6: per-call times at the serving shapes (CUDA events)."""
    q, k, v = p5["attn_inputs"]
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    a_ms = _time_cuda(lambda: ops.flash_attention(q, k, v), 20)
    # the SIMT kernel at the same shape: its C entry point, bypassing the
    # route choice (bf16 = 1, causal, no window)
    lib, out = fa.build(), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    def simt():
        _check(lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, B,
            S, S, Hq, Hkv, hd, 1, 0, hd ** -0.5, stream) == 0,
            "SIMT attention launch")
    a_simt = _time_cuda(simt, 5)
    a_plain = _time_cuda(lambda: _plain_attn(ref, q, k, v), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    a_lib = _time_cuda(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    a_bound, a_by = _attn_bound_ms(B, S, S, Hq, Hkv, hd, q.element_size())
    args = p5["scan_inputs"]
    s_ms = _time_cuda(lambda: ops.mamba_scan(*args), 10)
    s_plain = _time_cuda(lambda: ref.mamba_scan_ref(*args), 2)
    s_bound, s_by = _scan_bound_ms(*args[0].shape, args[2].shape[1])
    one = [t[:1] if t.dim() == 3 else t for t in args]   # batch row 0 alone
    s_one = _time_cuda(lambda: ops.mamba_scan(*one), 10)
    print(f"== phase 6: per-call ms at the serving shapes (CUDA events); "
          f"card {card}")
    print(f"   flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} bf16: "
          f"kernel (wgmma) {a_ms:.6f}  simt {a_simt:.6f}  plain "
          f"{a_plain:.6f}  sdpa {a_lib:.6f}  bound {a_bound:.6f} ({a_by})  "
          f"kernel/bound {a_ms / a_bound:.1f}  simt/wgmma "
          f"{a_simt / a_ms:.2f}  TFLOP/s {a_bound * 989 / a_ms:.1f}")
    print(f"   mamba_scan B,L,Di,N={tuple(args[0].shape)},"
          f"{args[2].shape[1]} fp32: kernel {s_ms:.6f}  plain "
          f"{s_plain:.6f}  bound {s_bound:.6f} ({s_by})  kernel/bound "
          f"{s_ms / s_bound:.1f}  kernel at B=1 {s_one:.6f}", flush=True)
    return {"flash_attention": dict(ms=a_ms, plain_ms=a_plain,
                                    library_ms=a_lib, bound_ms=a_bound,
                                    bound_by=a_by, simt_ms=a_simt),
            "mamba_scan": dict(ms=s_ms, plain_ms=s_plain, library_ms=None,
                               bound_ms=s_bound, bound_by=s_by,
                               ms_batch1=s_one)}


def _bf16_attention_check(cfg, fa, ops, ref, dev) -> float:
    """Phase 7: a 2-layer, full-width bf16 prefill of one serving-length
    prompt as the package runs it, then again with ``ops.flash_attention``
    swapped for the plain version (here in the harness only). Logits within
    BF16_MODEL_TOL and the same next token. Returns the max abs error."""
    from repro_torch.models import model
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = model.init(cfg2, torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    req = np.random.default_rng(14).integers(0, cfg.vocab_size,
                                             (1, SERVE_PROMPT))
    before = fa.route_launches["wgmma"]
    got, _ = model.prefill(cfg2, params, req, SERVE_PROMPT + 1, device=dev)
    _check(fa.route_launches["wgmma"] - before == cfg2.n_layers,
           "bf16 check: one wgmma launch per layer")
    kernel_attn = ops.flash_attention
    ops.flash_attention = (lambda q, k, v, causal=True, window=None:
                           _plain_attn(ref, q, k, v, causal=causal,
                                       window=window))
    try:
        want, _ = model.prefill(cfg2, params, req, SERVE_PROMPT + 1,
                                device=dev)
    finally:
        ops.flash_attention = kernel_attn
    torch.cuda.synchronize()
    err = _close(got, want, BF16_MODEL_TOL,
                 f"{cfg.name}: bf16 logits, kernel vs plain attention")
    tok, tok_want = got[:, -1].argmax(-1), want[:, -1].argmax(-1)
    _check(bool(torch.equal(tok, tok_want)),
           f"{cfg.name}: bf16 next token, kernel vs plain attention")
    print(f"   {cfg.name} bf16, 2 layers, full width, one {SERVE_PROMPT}-"
          f"token prompt: logits through the wgmma kernel vs the plain "
          f"attention max abs err {err:.3e} (tol {BF16_MODEL_TOL}; max "
          f"|logit| {float(want.float().abs().max()):.3f}); next token "
          f"{int(tok[0])} == {int(tok_want[0])}", flush=True)
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return err


def _serve(arch: str, kernel, counters, dev, phase: int) -> dict:
    """Phases 7 and 8: serve one model at full width and depth, then hold
    the port on the card to the port on the CPU. Returns the launch counts
    of greedy_generate's run, by kernel (and by route for attention)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import model_arrays, model_from_arrays
    from repro_torch.models import model
    from repro_torch.train import serve
    cfg = get_config(arch)
    B, S, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    max_seq = S + steps + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prompt = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefill = serve.make_prefill_step(cfg, max_seq, device=dev)
    step = serve.make_serve_step(cfg, device=dev)
    logits, cache = prefill(params, prompt)              # warm-up
    _check(tuple(logits.shape) == (B, S, cfg.vocab_size)
           and bool(torch.isfinite(logits).all()),
           f"{arch}: prefill logits finite, of shape (B, S, vocab)")
    del logits, cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    toks = [tok]
    del logits
    prefill_profile = _device_breakdown(lambda: prefill(params, prompt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = step(params, cache, tok, S + i)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    _check(bool(torch.isfinite(logits).all()), f"{arch}: decode logits")
    del logits
    try:   # the card's own time for one step: captured once, replayed
        step_dev_ms = _time_graph(lambda: step(params, cache, tok, S + steps),
                                  1)
    except RuntimeError as exc:  # a refused capture costs the number only
        step_dev_ms = None
        print(f"   decode step CUDA-graph capture refused: {exc}")
    del cache

    _reset(counters)                                     # the main path
    t0 = time.perf_counter()
    out = serve.greedy_generate(cfg, params, prompt, steps + 1, max_seq,
                                device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in counters}
    by_route = {m.__name__.rsplit(".", 1)[-1]: dict(m.route_launches)
                for m in counters if hasattr(m, "route_launches")}
    launches["by_route"] = by_route
    _check(kernel.launches > 0, f"{arch}: greedy_generate never launched "
           f"{kernel.__name__}")
    if hasattr(kernel, "route_launches"):   # bf16 serving: all on wgmma
        _check(kernel.route_launches["wgmma"] == kernel.launches,
               f"{arch}: attention launches by route {by_route}")
    _check(tuple(out.shape) == (B, steps + 1) and out.dtype == torch.int32
           and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
           f"{arch}: generated tokens")
    same = bool(torch.equal(out, torch.cat(toks, dim=1)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"== phase {phase}: {arch} ({n_params / 1e9:.3f} B params, "
          f"{cfg.param_dtype}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) on {dev}: init {init_s:.2f} s; {B} prompts x {S} "
          f"tokens, prefill {prefill_s:.4f} s = {B * S / prefill_s:.1f} "
          f"tokens/s; {steps} decode steps {decode_s:.4f} s = "
          f"{B * steps / decode_s:.2f} tokens/s (host clock, synchronized);"
          f" one decode step on the card alone (CUDA graph replay) "
          f"{_fmt_ms(step_dev_ms)} ms of {decode_s / steps * 1e3:.3f} ms;"
          f" greedy_generate({steps + 1} tokens) {gen_s:.4f} s, kernel "
          f"launches {launches}, tokens equal to the timed loop's: {same}; "
          f"peak device memory {peak:.2f} GiB", flush=True)
    print(f"   one prefill by kernel: {prefill_profile}", flush=True)
    del params, out, toks, tok
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                               activation_dtype="float32")
    p_cuda = model.init(cfg2, torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    p_cpu = model_from_arrays(cfg2, model_arrays(p_cuda), device="cpu")
    req = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, 128))
    errs = []
    la, ca = model.prefill(cfg2, p_cuda, req, 160, cache_dtype=torch.float32,
                           device=dev)
    lb, cb = model.prefill(cfg2, p_cpu, req, 160, cache_dtype=torch.float32,
                           device="cpu")
    errs.append(_close(la.cpu(), lb, CPU_TOL, f"{arch}: prefill cuda vs cpu"))
    nxt = lb[:, -1:].argmax(dim=-1)
    da, _ = model.decode_step(cfg2, p_cuda, ca, nxt, 128, device=dev)
    db, _ = model.decode_step(cfg2, p_cpu, cb, nxt, 128, device="cpu")
    errs.append(_close(da.cpu(), db, CPU_TOL, f"{arch}: decode cuda vs cpu"))
    print(f"   {arch} fp32, 2 layers, full width, one 128-token request: "
          f"cuda vs cpu logits max abs err prefill {errs[0]:.3e}, decode "
          f"{errs[1]:.3e} (tol {CPU_TOL}; TF32 off)", flush=True)
    del p_cuda, p_cpu, la, lb, ca, cb, da, db
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(kernel, "route_launches"):
        from repro_torch.kernels import ops, ref
        _bf16_attention_check(cfg, kernel, ops, ref, dev)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_suite import PAPER_APPS
    from repro_torch.convert import predictor_arrays, predictor_from_arrays
    from repro_torch.core import (EnergyTimePredictor, PredictionService,
                                  PredictorConfig, Testbed, V5E_DVFS,
                                  build_dataset, legacy_run_schedule,
                                  make_workload, profile_features,
                                  run_schedule, stream_workload)
    from repro_torch.core.features import clock_features
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.policies import POLICY_NAMES
    from repro_torch.kernels import build, gbdt_predict as gp
    from repro_torch.kernels import flash_attention as fa, mamba_scan as ms
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (gp, fa, ms)
    card = _card_line()
    print(f"== phase 0: card {card}; torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}); "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    for mod in counters:
        mod.build()
    print(f"   kernel build {time.perf_counter() - t0:.2f} s", flush=True)
    for line in (build.build_log or "cached library").splitlines():
        if any(w in line for w in ("==", "entry", "registers", "spill",
                                   "cached", "warning")):
            print(f"   {line.strip()}")

    # -- fixtures (host numpy): profiling campaign + production predictor --
    tb = Testbed(seed=0)
    apps = list(PAPER_APPS)
    X, yp, yt, _ = build_dataset(apps, tb, seed=0)
    rng7 = np.random.default_rng(7)
    feats = {a.name: profile_features(a, tb, rng=rng7) for a in apps}
    t0 = time.perf_counter()
    pred = EnergyTimePredictor(PredictorConfig(), device=dev).fit(X, yp, yt)
    print(f"   default predictor fit {time.perf_counter() - t0:.2f} s "
          "(host)", flush=True)
    clock_X = [clock_features(c, tb.dvfs) for c in tb.dvfs.clock_list()]
    batch = np.stack([np.concatenate([feats[a.name], cx])
                      for a in apps for cx in clock_X])        # (768, 23)

    # -- phase 1: kernel against plain on the card -------------------------
    print("== phase 1: kernel vs plain (fp64, max relative error)")
    rng = np.random.default_rng(42)
    worst = 0.0
    for n, T, depth, F in ((17, 9, 2, 5), (64, 64, 4, 23), (8, 130, 6, 8),
                           (300, 50, 8, 23), (1000, 1, 8, 40),
                           (64, 80, 3, 23), (33, 260, 5, 23),
                           (4097, 400, 4, 23), (33, 1000, 8, 23),
                           (1, 30, 2, 3), (24, 30, 2, 3), (64, 30, 2, 3)):
        args = _random_ensemble(rng, n, T, depth, F, dev)
        got = ops.gbdt_predict(*args, base=1.5)
        want = ref.gbdt_predict_ref(*args, base=1.5)
        torch.cuda.synchronize()
        err = _rel_err(got, want)
        worst = max(worst, err)
        same = bool(torch.equal(got, want))
        print(f"   n={n} T={T} D={depth} F={F}: {err:.3e} bitwise={same}")
        _check(err <= REL_TOL and same,
               f"kernel vs plain {(n, T, depth, F)}: {err}")
    prod = {}
    max_abs = 0.0
    for which in ("power", "time"):
        target = getattr(pred, which)
        Xe = torch.from_numpy(target.enc.transform(batch)).to(dev)
        f_t, thr_t, lv_t = target.gbdt.device_tables()
        prod[which] = (Xe, f_t, thr_t, lv_t, target.gbdt.base)
        got = ops.gbdt_predict(*prod[which])
        want = ref.gbdt_predict_ref(*prod[which])
        torch.cuda.synchronize()
        err = _rel_err(got, want)
        worst = max(worst, err)
        max_abs = max(max_abs, float((got - want).abs().max()))
        T, depth = f_t.shape
        same = bool(torch.equal(got, want))
        print(f"   production {which}: n={Xe.shape[0]} T={T} D={depth} "
              f"F={Xe.shape[1]}: {err:.3e} bitwise={same}")
        _check(err <= REL_TOL and same, f"production {which}: {err}")
    print(f"   worst relative error {worst:.3e} <= {REL_TOL}", flush=True)

    # the golden traces' predictor (phases 2 and 3)
    g = dict(iterations=80, depth=3, learning_rate=0.15)
    gcfg = PredictorConfig(gbdt=GBDTParams(l2_leaf_reg=5.0, **g),
                           gbdt_time=GBDTParams(l2_leaf_reg=3.0, **g))
    gpred = EnergyTimePredictor(gcfg, device=dev).fit(X, yp, yt)

    # -- phase 2: per-row time vs batch size -------------------------------
    Xe, f_t, thr_t, lv_t, base = prod["power"]
    T, depth = f_t.shape
    F = Xe.shape[1]
    Xe_host = Xe.cpu().numpy()
    host_tabs = tuple(a.cpu().numpy() for a in (f_t, thr_t, lv_t))
    print(f"== phase 2: per-row time, production power ensemble "
          f"(T={T}, D={depth}, F={F}); card {card}")
    print("   wrapper_ms: ops.gbdt_predict per call (checks + launch) and "
          "launch_ms: the bare ctypes launch into a preallocated output, "
          "both CUDA events over 200 back-to-back calls; enqueue_ms: host "
          "clock per bare launch, not waiting for the card; device_ms: "
          "bare launches replayed from one CUDA graph (card time alone)")
    print("   rows  wrapper_ms  launch_ms  enqueue_ms  device_ms  "
          "device_us/row  plain_ms  numpy_host_ms  bound_ms")
    timing = {}
    for n in ROW_SIZES:
        reps_idx = np.arange(n) % Xe_host.shape[0]
        Xn = Xe[torch.from_numpy(reps_idx).to(dev)].contiguous()
        Xn_host = Xe_host[reps_idx]
        out = torch.empty(n, dtype=torch.float64, device=dev)
        k_ms = _time_cuda(lambda: ops.gbdt_predict(Xn, f_t, thr_t, lv_t,
                                                   base), 200)
        def bare():
            gp.launch(Xn, f_t, thr_t, lv_t, base, out)
        l_ms = _time_cuda(bare, 200)
        e_ms = _time_enqueue(bare, 200)
        d_ms = _time_graph(bare, 50)
        p_ms = _time_cuda(lambda: ref.gbdt_predict_ref(Xn, f_t, thr_t, lv_t,
                                                       base),
                          3 if n > 4096 else 10)
        h_ms = _time_host(lambda: ref.gbdt_predict_numpy(Xn_host,
                                                         *host_tabs, base),
                          3 if n > 4096 else 10)
        b_ms, b_by = _bound_ms(n, T, depth, F)
        timing[n] = dict(kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                         numpy_ms=h_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"   {n:5d}  {k_ms:.6f}  {l_ms:.6f}  {e_ms:.6f}  {d_ms:.6f}  "
              f"{d_ms * 1e3 / n:.6f}  {p_ms:.6f}  {h_ms:.6f}  "
              f"{b_ms:.9f} ({b_by})")
    faster = [n for n in ROW_SIZES
              if timing[n]["kernel_ms"] < timing[n]["numpy_ms"]]
    print(f"   wrapper beats host numpy at rows {faster}", flush=True)
    gold = gpred.power
    Xg = torch.from_numpy(gold.enc.transform(batch[:64])).to(dev)
    g_tabs = gold.gbdt.device_tables()
    g_out = torch.empty(64, dtype=torch.float64, device=dev)
    g_ms = _time_graph(lambda: gp.launch(Xg, *g_tabs, gold.gbdt.base,
                                         g_out), 50)
    g_bound, g_by = _bound_ms(64, *g_tabs[0].shape, Xg.shape[1])
    _check(torch.equal(g_out, ref.gbdt_predict_ref(Xg, *g_tabs,
                                                   gold.gbdt.base)),
           "golden-shape kernel vs plain, bitwise")
    lib = gp.build()
    def empty():
        _check(lib.gbdt_launch_floor(
            torch.cuda.current_stream().cuda_stream) == 0, "empty launch")
    floor_ms = _time_graph(empty, 50)
    print(f"   golden predictor's power ensemble, 64 rows x "
          f"{g_tabs[0].shape[0]} trees x D{g_tabs[0].shape[1]} x "
          f"F{Xg.shape[1]}: device_ms {g_ms:.6f} (bitwise equal to plain), "
          f"bound {g_bound:.9f} ({g_by})")
    print(f"   launch floor (an empty kernel of the same library, graph "
          f"replay): {floor_ms:.6f} ms; the kernel at 768 rows is "
          f"{timing[768]['device_ms'] / floor_ms:.2f}x the floor, at 1 row "
          f"{timing[1]['device_ms'] / floor_ms:.2f}x", flush=True)

    # -- phase 3: golden traces through the kernel -------------------------
    golden = json.loads(GOLDEN.read_text())["traces"]
    _reset(counters)
    matched = 0
    for policy in POLICY_NAMES:
        for seed in (0, 1):
            jobs = make_workload(apps, tb, seed=seed)
            r = run_schedule(jobs, policy, Testbed(seed=100 + seed),
                             predictor=gpred, app_features=feats,
                             device=dev)
            key = f"{policy}|{seed}"
            _check(_digest(r.records) == golden[key]["digest"],
                   f"golden digest {key}")
            legacy = legacy_run_schedule(
                jobs, policy, Testbed(seed=100 + seed), predictor=gpred,
                app_features=feats, device=dev)
            _check(legacy.records == r.records, f"legacy == run {key}")
            matched += 1
    import repro_torch.core as core
    for key, (r, layer) in _layer_goldens(core, apps, tb, gpred, feats,
                                          dev).items():
        _check(_digest(r.records) == golden[key]["digest"],
               f"golden digest {key}")
        live = {LAYER_KEYS[1]: lambda: r.preemptions > 0,
                LAYER_KEYS[2]: lambda: layer.stats.boundaries > 0
                and r.preemptions == 0,
                LAYER_KEYS[3]: lambda: r.shed_count > 0,
                LAYER_KEYS[4]: lambda: layer.stats.tier_rescues > 0}
        _check(live.get(key, lambda: True)(), f"{key} scenario is live")
        matched += 1
    print(f"== phase 3: {matched}/17 golden digests reproduced on {dev} "
          f"(12 base, {len(LAYER_KEYS)} of the beyond-paper layers); "
          f"run_schedule == legacy_run_schedule; kernel launches "
          f"{gp.launches}", flush=True)
    _check(matched == 17 and gp.launches > 0, "golden phase launches")

    # -- phase 4: the main path at full size -------------------------------
    jobs = list(stream_workload(apps, tb, n_jobs=N_JOBS, seed=1,
                                n_devices=N_DEVICES))
    results = {}
    services = {}
    main_launches = None
    preds = {"cuda": pred,
             "cpu": predictor_from_arrays(predictor_arrays(pred),
                                          device="cpu")}
    for label, p in preds.items():
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = PredictionService(V5E_DVFS, predictor=p, app_features=feats,
                                testbed=tb, device=p.device)
        svc.prefetch_tables([a.name for a in apps])
        r = run_schedule(jobs, "min-energy", tb, service=svc,
                         n_devices=N_DEVICES, queue_aware=False,
                         virtual_pacing=False, device=p.device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if label == "cuda":
            main_launches = gp.launches
        results[label], services[label] = r, svc
        print(f"== phase 4 [{label}]: {len(r.records)} jobs in {wall:.3f} s "
              f"= {len(r.records) / wall:.1f} jobs/s (host clock); "
              f"total_energy {r.total_energy!r} J; misses {r.misses}; "
              f"table_builds {svc.stats.table_builds}; kernel_batches "
              f"{svc.stats.kernel_batches}; kernel launches {gp.launches}",
              flush=True)
    _check(bool(main_launches), "the main path never launched the kernel")
    for a in apps:
        tc, th = services["cuda"].table(a.name), services["cpu"].table(a.name)
        _check(np.array_equal(tc.P, th.P) and np.array_equal(tc.T, th.T),
               f"cuda vs cpu table of {a.name}")
    _check(results["cuda"].records == results["cpu"].records,
           "cuda vs cpu records")
    print(f"   cuda and cpu runs record-identical over {N_JOBS} jobs; "
          "tables bitwise equal", flush=True)

    p5 = _kernels_vs_plain(dev, fa, ops, ref)
    times = _kernel_times(fa, ops, ref, p5, card)
    attn_err, scan_err = p5["attn_err"], p5["scan_err"]
    del p5
    served = {"flash_attention": _serve("mistral-nemo-12b", fa, counters,
                                        dev, 7),
              "mamba_scan": _serve("falcon-mamba-7b", ms, counters, dev, 8)}
    layers = _layers(core, gp, ops, ref, counters, apps, tb, preds, feats,
                     dev, card)

    t768 = timing[768]
    rows = [{
        "name": "gbdt_predict",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gbdt_predict.cu",
        "replaces": "src/repro/kernels/gbdt_predict.py:90",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": t768["device_ms"],
        "plain_ms": t768["plain_ms"],
        "bound_ms": t768["bound_ms"],
        "bound_by": t768["bound_by"],
        "library_ms": None,
        "floor_ms": floor_ms,
        "golden_shape_ms": g_ms,
        # this slice's path (phase 9) and the corrector's shapes
        "launches_layers": layers["launches"],
        "launches_layers_by_rows": layers["by_rows"],
        "corrector_max_abs_err": layers["max_abs_err"],
        "corrector_shape_trees_depth_features": layers["shape"],
        "corrector_ms_by_rows": layers["timing"],
    }]
    for name, line, err in (("flash_attention", 116, attn_err),
                            ("mamba_scan", 72, scan_err)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": served[name][name],
            "max_abs_err": err, **times[name]})
    # the main path's attention kernel; the SIMT route's beside it
    rows[1]["source"] = "src/repro_torch/csrc/flash_attention_sm90.cu"
    rows[1]["simt_source"] = "src/repro_torch/csrc/flash_attention.cu"
    rows[1]["launches_by_route"] = \
        served["flash_attention"]["by_route"]["flash_attention"]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
