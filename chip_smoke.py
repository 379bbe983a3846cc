#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Builds the port's CUDA kernel from ``src/repro_torch/csrc`` and drives the
paper's pipeline on the card, in phases:

0. card identity (name and power limit from ``nvidia-smi``) and kernel
   build time;
1. the GBDT kernel against its plain PyTorch version on the card, at the
   reference test sweep's shapes, a depth-8 ensemble, and the production
   ensembles on the 768-row prefetch batch (max relative error <= 1e-12);
2. per-row kernel time vs batch size on the production ensemble, beside the
   plain version and host numpy (the routing crossover);
3. the 12 base golden traces (6 policies x seeds 0, 1) reproduced exactly
   with ``device="cuda"``, through the kernel;
4. the main path at full size: the default predictor (400 trees of depth 4
   per regressor), a CUDA ``PredictionService`` with ``prefetch_tables``,
   and the 100 000-job uniform stream on 8 devices (min-energy); then the
   same on ``device="cpu"``, which must give identical records.

Ends with a JSON line of per-kernel numbers, the card line, and
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when CUDA is absent or any phase fails. Needs one card:

    python3 chip_smoke.py
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "schedule_traces.json"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp64 without
#: tensor cores — the kernel compares and adds in fp64.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
REL_TOL = 1e-12
N_JOBS = 100_000
N_DEVICES = 8
ROW_SIZES = (1, 64, 512, 768, 4096, 65536)


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
    from repro_torch.kernels import gbdt_predict as gp
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", torch.cuda.current_device())
    card = _card_line()
    print(f"== phase 0: card {card}; torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}); "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    gp.build()
    print(f"   kernel build {time.perf_counter() - t0:.2f} s", flush=True)
    for line in (gp.build_log or "cached library").splitlines():
        if "registers" in line or "spill" in line or "cached" in line:
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
                           (300, 50, 8, 23), (1000, 1, 8, 40)):
        args = _random_ensemble(rng, n, T, depth, F, dev)
        got = ops.gbdt_predict(*args, base=1.5)
        want = ref.gbdt_predict_ref(*args, base=1.5)
        torch.cuda.synchronize()
        err = _rel_err(got, want)
        worst = max(worst, err)
        print(f"   n={n} T={T} D={depth} F={F}: {err:.3e} "
              f"bitwise={bool(torch.equal(got, want))}")
        _check(err <= REL_TOL, f"kernel vs plain {(n, T, depth, F)}: {err}")
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
        print(f"   production {which}: n={Xe.shape[0]} T={T} D={depth} "
              f"F={Xe.shape[1]}: {err:.3e} "
              f"bitwise={bool(torch.equal(got, want))}")
        _check(err <= REL_TOL, f"production {which}: {err}")
    print(f"   worst relative error {worst:.3e} <= {REL_TOL}", flush=True)

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

    # -- phase 3: golden traces through the kernel -------------------------
    golden = json.loads(GOLDEN.read_text())["traces"]
    g = dict(iterations=80, depth=3, learning_rate=0.15)
    gcfg = PredictorConfig(gbdt=GBDTParams(l2_leaf_reg=5.0, **g),
                           gbdt_time=GBDTParams(l2_leaf_reg=3.0, **g))
    gpred = EnergyTimePredictor(gcfg, device=dev).fit(X, yp, yt)
    gp.launches = 0
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
    print(f"== phase 3: {matched}/12 base golden digests reproduced on "
          f"{dev}; run_schedule == legacy_run_schedule; kernel launches "
          f"{gp.launches}", flush=True)
    _check(matched == 12 and gp.launches > 0, "golden phase launches")

    # -- phase 4: the main path at full size -------------------------------
    jobs = list(stream_workload(apps, tb, n_jobs=N_JOBS, seed=1,
                                n_devices=N_DEVICES))
    results = {}
    services = {}
    main_launches = None
    for label, p in (("cuda", pred),
                     ("cpu", predictor_from_arrays(predictor_arrays(pred),
                                                   device="cpu"))):
        gp.launches = 0
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

    t768 = timing[768]
    print(json.dumps({"kernels": [{
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
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
