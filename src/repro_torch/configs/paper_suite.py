"""The paper's 12 benchmark applications (Table I) as testbed profiles.

Latent characteristics are chosen to reproduce each application's *documented
behavior class* on the simulated v5e-class chip:

* Polybench linear algebra (GEMM/2MM/SYRK/SYR2K) — compute-bound, high
  arithmetic intensity.
* ATAX (matrix-vector) — strongly memory-bound (paper Fig. 1d shows its time
  flat in core clock).
* CORR/COVAR — mixed-bound with a non-convex energy valley (paper Fig. 1b:
  "non-convex curve between [730-920] MHz") → strong wiggle amplitudes.
* lavaMD — "completely inconsistent response to frequency variations"
  (Fig. 1a) → resonance spike + large wiggle.
* myocyte — serial ODE integration, little parallelism → overhead- and
  stall-dominated; clocks barely help (paper Fig. 11 discussion).
* backprop / particlefilter — dependency-stall-heavy; faster execution without
  max clock (paper Fig. 10 observation for backprop/particle_float).

Pairs of similar apps (particlefilter_naive/float; GEMM/2MM; CORR/COVAR)
exist so the K-means correlation (Table IV) has structure to find.
"""
from __future__ import annotations

from repro_torch.core.simulator import AppProfile

PAPER_APPS: tuple[AppProfile, ...] = (
    AppProfile(name="particlefilter_naive", flops=2e+13, hbm_bytes=3.33e+11,
               overhead_s=0.175, stall_frac=0.25, wiggle_time=0.05,
               wiggle_power=0.04, seed=101),
    AppProfile(name="particlefilter_float", flops=1.67e+13, hbm_bytes=3e+11,
               overhead_s=0.15, stall_frac=0.22, wiggle_time=0.05,
               wiggle_power=0.04, seed=102),
    AppProfile(name="myocyte", flops=3.33e+11, hbm_bytes=6.67e+09,
               overhead_s=1.25, stall_frac=0.70, wiggle_time=0.03,
               wiggle_power=0.03, seed=103),
    AppProfile(name="lavaMD", flops=2.67e+14, hbm_bytes=1.33e+12,
               overhead_s=0.1, stall_frac=0.05, wiggle_time=0.10,
               wiggle_power=0.08, spike=0.25, seed=104),
    AppProfile(name="backprop", flops=3.33e+12, hbm_bytes=1e+12,
               overhead_s=0.125, stall_frac=0.30, wiggle_time=0.05,
               wiggle_power=0.05, seed=105),
    AppProfile(name="SYRK", flops=1e+14, hbm_bytes=2.5e+11,
               overhead_s=0.05, wiggle_time=0.03, wiggle_power=0.03, seed=106),
    AppProfile(name="SYR2K", flops=2e+14, hbm_bytes=5e+11,
               overhead_s=0.06, wiggle_time=0.03, wiggle_power=0.03, seed=107),
    AppProfile(name="GEMM", flops=1.67e+14, hbm_bytes=2.47e+11,
               overhead_s=0.04, wiggle_time=0.02, wiggle_power=0.02, seed=108),
    AppProfile(name="COVAR", flops=6.67e+13, hbm_bytes=5.33e+11,
               overhead_s=0.075, wiggle_time=0.07, wiggle_power=0.08, seed=109),
    AppProfile(name="CORR", flops=7e+13, hbm_bytes=5.67e+11,
               overhead_s=0.075, wiggle_time=0.07, wiggle_power=0.08, seed=110),
    AppProfile(name="ATAX", flops=1.67e+11, hbm_bytes=1.67e+12,
               overhead_s=0.05, stall_frac=0.10, wiggle_time=0.04,
               wiggle_power=0.04, seed=111),
    AppProfile(name="2MM", flops=3.33e+14, hbm_bytes=5e+11,
               overhead_s=0.05, wiggle_time=0.02, wiggle_power=0.02, seed=112),
)

PAPER_APP_NAMES = tuple(a.name for a in PAPER_APPS)
