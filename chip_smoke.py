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
3. the 20 golden traces reproduced exactly with ``device="cuda"``,
   through the kernel: the 12 base ones (6 policies x seeds 0, 1), the
   five the beyond-paper layers pin (power cap, preemption fired and
   declined, tenant shedding and tier rescue), and cold start, federation
   and the model-derived mix, built as ``tests/test_golden.py`` builds
   them and each checked live;
4. the main path at full size: the default predictor (400 trees of depth 4
   per regressor), a CUDA ``PredictionService`` with ``prefetch_tables``,
   and the 100 000-job uniform stream on 8 devices (min-energy); then the
   same on ``device="cpu"``, which must give identical records;
5. the flash-attention kernels (both routes: ``wgmma`` on the tensor cores
   for bf16, ``simt`` for the rest) and the Mamba-1 scan kernel against
   their plain PyTorch versions on the card: the reference test sweep's
   shapes, the window and right-aligned cases, and the serving shapes,
   phases 11-15's among them (Whisper's bidirectional encoder and its
   cross-attention over 1500 frames, head dim 112, Mixtral's window of
   4096 at 6144 tokens, the 7168-channel, 64-state scan of Zamba2's
   Mamba-2 prefill, and ``falcon-mamba-7b.prefill``'s scans: one prompt
   of 512 to 8192 tokens at Di 8192, N 16), each case printed with its
   route (fp32 2e-5; bf16 one output ulp, 2**-7 relative, on the SIMT
   route, and 2**-9 max|v| more on the wgmma route, which rounds p to
   bf16);
6. their per-call times at the serving shapes, beside the plain versions,
   the bound, for attention the SIMT kernel at the same shape and
   PyTorch's own SDPA as a yardstick; then the decode-attention kernel
   (K4) at the decode cells' layers (Mistral-NeMo-12B's and Zamba2-7B's,
   B 32 over a 2048-slot bf16 cache at position 1279), checked against
   its plain version at its tolerance derived from the inputs (faults of
   one slot or a 16-row step planted must each fail it) and timed
   (median of 20) beside its bound (the live K and V read once), the
   plain version and SDPA with the boolean mask; then K3's Mamba-2 route
   (``mamba2_scan``: every head and B/C group in one launch) at
   Zamba2-7B's layer, B 1 at L 2048 and 4096 and B 32 at L 512, in bf16
   as served: checked against its plain version, bit for bit against the
   route it replaced, and timed (median of 20) beside that route's two
   Mamba-1 calls, the plain version and ``perfbench/counts/hybrid.scan``'s
   bound; then K3's Mamba-1 kernel at ``falcon-mamba-7b.prefill``'s
   scans (B 1, L 512 to 8192, Di 8192, N 16, fp32 as the block passes
   them; median of 20) beside ``perfbench/counts/ssm.scan``'s bound (the
   benchmark's ``mamba1_scan_roofline.prefill`` prices the same), the
   fp32 bytes' bound and the floor of its exps (one a state element and
   step, on the SFUs, which no bound above prices);
7. Mistral-NeMo-12B served at full width and depth (random bf16 weights
   from a seed): 4 prompts of 2048 tokens, then 32 greedy decode steps
   through ``greedy_generate``; every flash-attention launch of it must
   take the wgmma route, and every decode step must launch K4 once a
   layer. Prefill and decode are timed apart; one prefill
   is broken down by kernel (``torch.profiler``) and one decode step timed
   on the card alone (CUDA-graph replay). Then the same model at fp32 with
   2 layers, cuda against cpu, logits within 1e-3 (an fp32 decode takes
   the plain attention on both devices: K4 takes bf16 alone); and at
   bf16 with 2 layers, a prefill through the kernel against one through
   the plain attention (logits within 2**-4, the same next tokens);
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
   beside host numpy;
10. cold start, federation and model-derived apps at full size, on the
   card and on the CPU, records equal field for field (provenance fields
   included): ``benchmarks/bench_coldstart.py``'s frozen and corrected
   runs (12 profiled apps, 6 novel ones, 800 jobs on 4 devices), the
   federated arm and straggler rescue run of
   ``benchmarks/bench_federation.py`` (8 v5p + 48 v5e + 8 v5lite in 8
   racks of 8, 10 000 jobs, its per-class predictor), and
   ``benchmarks/bench_models_sched.py``'s capped headline mix (120
   serving + 30 training jobs, max-clock and min-energy). Each run must
   be live (novel apps served from synthesized tables; escalations and a
   billed cross-rack migration; decode, train steps and two
   architectures), and K1's launches are counted per scenario;
11-15. the MoE, VLM, hybrid and audio families served as phase 7 serves
   (random bf16 weights from a seed, full width, depth cut only where one
   card cannot hold the model, each cut printed; FAMILY_PHASES):
   Mixtral-8x22B (8 of 56 layers, 2 prompts of 6144 tokens, past its
   4096 window), Kimi-K2 (1 dense + 1 MoE layer of 384 experts and a
   shared expert, 16 steps), Zamba2-7B (all 81 Mamba-2 blocks, 13
   shared-attention applications; each Mamba-2 prompt one launch of K3's
   Mamba-2 kernel), Whisper-large-v3 (32 + 32 layers,
   1500 stub frames, a 64-token decoder prompt), InternVL2-76B (24 of 80
   layers, 256 stub vision embeddings + 1792 text tokens). Every prefill
   launches exactly the kernels its layers call, every bf16 attention
   launch on the wgmma route, and every decode step K4 once a cached
   self-attention; then a cuda-vs-cpu check at fp32 (2 layers,
   Whisper 2 + 2, Zamba2 7 for one application and a tail, one 128-token
   request) or, for Kimi-K2 (68 GB at fp32), the served bf16 weights
   with fp32 activations on both devices (64 tokens, CPU_TOL; their
   decodes take the plain attention on both), and in bf16 as served,
   printed only (routing flips at 384 experts).
16. training: SmolLM-360M at full width and depth (361 821 120 bf16
   params, remat "full", AdamW with fp32 state) on SyntheticLM batches of
   16 x 4096 tokens in 8 microbatches of 2 (train_4k's global batch of 256
   cut to 16); 2 untimed and 5 timed steps, each loss finite, step ms,
   tokens/s, 6*N*tokens TFLOP/s against the dense bf16 peak, peak memory,
   one step by kernel; no attention or scan kernel may launch. The trained
   model is then served (greedy_generate: its prefill launches the
   attention kernel 32 times, all on the wgmma route, and each decode
   step K4 32 times), and 2 steps are
   taken with int8 optimizer state (its bytes printed against fp32's).
   Then every one of the 10 reduced architectures (fp32) takes one train
   step on the card and on the CPU from the same weights and batch (loss,
   ce, aux, grad_norm 1e-5 relative; grads 1e-4 of each leaf's max), and a
   TrainingRunner run with an injected failure equals the clean run bit
   for bit on the card, with deterministic algorithms on.
17. distribution on the card, over a one-rank NCCL group (a ``file://``
   store): ``compressed_psum`` for 3 rounds of error feedback on a
   gradient-shaped tree at SmolLM-360M's full width and depth (361 821 120
   fp32 values from a seed), result and residual bit for bit with the CPU
   port's (a gloo group in the same process) and the residual within
   max|g|/127, ms per round; ``moe_sharded`` on a (1, 1) data x model
   CUDA mesh over one Kimi-K2 MoE layer at full width (384 experts,
   d_model 7168, the shared expert, bf16), bit for bit with ``moe``; one
   Zamba2-7B Mamba-2 block (fp32) on that mesh, its scan in K3's Mamba-2
   kernel on the rank's heads (one launch), within 1e-5 of the meshless
   block; the
   elastic restore of SmolLM-360M's bf16 params and int8 AdamW state onto
   a one-rank CUDA mesh by the spec trees, every shard bit for bit with
   the saved arrays (psum and the restore are timed before the dry runs
   start); and the dry run (``python -m
   repro_torch.launch.dryrun``) as subprocesses on four production
   cells, smollm-360m train_4k (query-parallel attention: 15 heads on
   16) and whisper-large-v3 decode_32k (1500 frames and a 51 866-token
   vocab split unevenly over 16) on 16x16 with ``--device cuda`` and
   ``--device cpu`` (identical counts), zamba2-7b train_4k on 16x16 (the
   Mamba-2 block on each rank's heads) and kimi-k2-1t-a32b decode_32k on
   2x16x16 (``fsdp_over_pod``), each printed per device with its wall
   time (the recorder counts as XLA's cost analysis on the CPU:
   elementwise FLOPs, fused bytes).
18. the dry run -> scheduler path: ``repro_torch.examples.quickstart``
   (the 12 paper apps profiled, the default predictor, mc/dc/d-dvfs),
   then ``repro_torch.examples.schedule_jobs`` on phase 17's four cells
   (their per-device roofline as framework jobs of 20 steps, FLOP, GB
   and arithmetic intensity printed; mc/dc/d-dvfs/oracle through one
   PredictionService) and again with no dry-run file (the reference's
   four built-in profiles); each run on the card, where K1 builds every
   table, and on the CPU, record for record (energy, misses, makespan
   per policy), with its wall and K1's launches by batch rows.

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
import os
import pathlib
import statistics
import subprocess
import sys
import time

# phase 16's restart check runs with deterministic algorithms, which need
# cuBLAS's fixed workspace; it must be set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

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
#: phases 11-15's new attention shapes, bf16 (the wgmma route): name,
#: (B, Sq, Hq, Hkv, hd), Sk (None: = Sq), options
FAMILY_ATTN = (
    ("whisper encoder", (4, 1500, 20, 20, 64), None, {"causal": False}),
    ("whisper cross", (4, 64, 20, 20, 64), 1500, {"causal": False}),
    ("whisper decoder", (4, 64, 20, 20, 64), None, {}),
    ("zamba2", (4, 2048, 32, 32, 112), None, {}),
    ("kimi-k2", (4, 2048, 64, 8, 112), None, {}),
    ("internvl2", (4, 2048, 64, 8, 128), None, {}),
    ("mixtral window", (2, 6144, 48, 8, 128), None, {"window": 4096}),
)
#: ... and zamba2-7b's Mamba-2 prefill as a Mamba-1 scan (B, L, Di, N)
FAMILY_SCAN = (4, 2048, 7168, 64)
#: falcon-mamba-7b.prefill's K3 calls (B, L, Di, N): one prompt a
#: prefill at the prefill ladder's lengths, FalconMamba-7B's Di and N
FALCON_SCAN = tuple((1, L, 8192, 16) for L in (512, 1024, 2048, 4096,
                                                8192))
#: exp2 results a clock an SM on the special-function units (sm_90: 16)
SFU_EXPS_PER_CLOCK_SM = 16
#: Zamba2-7B's Mamba-2 layer (H, P, G, N) and the Mamba-2 route's (B, L):
#: the prefill cell's prompts at B 1, the decode cell's batch prefill
MAMBA2_LAYER = (112, 64, 2, 64)
MAMBA2_SHAPES = ((1, 2048), (1, 4096), (32, 512))
#: the decode cells' attention layers (B, Hq, Hkv, hd), over a bf16 cache
#: of DECODE_SLOTS at DECODE_POS (mid-batch of decode-b32's 512 -> 2048)
DECODE_ATTN = (("mistral-nemo-12b", (32, 32, 8, 128)),
               ("zamba2-7b", (32, 32, 32, 224)))
DECODE_SLOTS, DECODE_POS = 2048, 1279
#: phases 11-15: the MoE, VLM, hybrid and audio families at full width,
#: depth cut only where one card cannot hold the model (bf16 weights: 262,
#: 1913 and 131 GiB whole for Mixtral, Kimi-K2 and InternVL2). Each entry:
#: config, {kernel: launches in one prefill}, _serve's options (the decode
#: step's cached self-attentions, the depth, the traffic, and the
#: cuda-vs-cpu check's config changes)
FAMILY_PHASES = {
    11: ("mixtral-8x22b", {"fa": 8},
         dict(attentions=8, layers={"n_layers": 8}, batch=2, prompt=6144)),
    12: ("kimi-k2-1t-a32b", {"fa": 2},
         dict(attentions=2, layers={"n_layers": 2}, steps=16,
              check={"served": True, "prompt": 64})),
    13: ("zamba2-7b", {"fa": 13, "m2": 81},
         # 7 blocks keep one shared-attention application and a tail
         dict(attentions=13, check={"n_layers": 7})),
    # the decoder's 32 self-attentions (its cross-attentions have no mask)
    14: ("whisper-large-v3", {"fa": 96},
         dict(attentions=32, prompt=64, check={"n_encoder_layers": 2})),
    15: ("internvl2-76b", {"fa": 24},
         dict(attentions=24, layers={"n_layers": 24}, prompt=2048 - 256)),
}
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
#: the golden traces of the cold-start, federation and model-derived layers
NEW_KEYS = ("min-energy|coldstart|0", "min-energy|federation|0",
            "min-energy|models|0")
#: phase 10: benchmarks/bench_coldstart.py's full frozen and corrected
#: runs (12 profiled apps, 6 novel ones, 800 jobs on 4 devices) ...
COLD_JOBS, COLD_NOVEL, COLD_DEVICES, COLD_SEED = 800, 6, 4, 11
#: ... benchmarks/bench_federation.py's full federated arm and its
#: straggler rescue run (8 v5p + 48 v5e + 8 v5lite in 8 racks of 8, the
#: cap at the idle floor + 0.65 of the uncapped peak headroom, 4 degraded
#: v5e at 4x) ...
FED_POOL = (("v5p", 8), ("v5e", 48), ("v5lite", 8))
FED_RACKS = (8,) * 8
FED_JOBS = 10_000
FED_UTIL, FED_CAP_FRAC, FED_GUARD = 0.5, 0.65, 0.2
FED_DEGRADED, FED_SLOWDOWN = (8, 9, 10, 11), 4.0
#: ... and benchmarks/bench_models_sched.py's full headline mix (120
#: serving + 30 training jobs, capped at the idle floor + 0.7 of the
#: uncapped max-clock peak headroom)
MODEL_POOL = ("v5p", "v5e", "v5e", "v5lite")
MODEL_SERVE, MODEL_TRAIN, MODEL_OVERLOAD = 120, 30, 1.3
MODEL_CAP_FRAC, MODEL_GUARD = 0.7, 0.15
#: phase 16: SmolLM-360M trained at full width and depth, at train_4k's
#: sequence length; its global batch of 256 is cut to 16 (8 microbatches
#: of 2) to fit the run's time. Untimed steps, timed steps, the int8-state
#: steps; the served prompt after training
TRAIN_ARCH, TRAIN_PARAMS = "smollm-360m", 361_821_120
TRAIN_SEQ, TRAIN_BATCH, TRAIN_FULL_BATCH, TRAIN_MICRO = 4096, 16, 256, 8
TRAIN_WARM, TRAIN_TIMED, TRAIN_INT8 = 2, 5, 2
TRAIN_SERVE = (2, 256, 4)                 # prompts, tokens, greedy steps
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
#: the every-family cuda == cpu step: reduced configs (fp32), one batch of
#: FAMILY_TRAIN_ROWS rows of FAMILY_TRAIN_SEQ text tokens; lr of the step
FAMILY_TRAIN_ROWS, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_LR = 2, 32, 1e-3
#: the restart on the card: reduced configs, the clean run against one
#: with a failure at RESTART_FAIL, checkpointed every RESTART_INTERVAL
RESTART_ARCHS = ("smollm-360m", "mixtral-8x22b")
RESTART_STEPS, RESTART_INTERVAL, RESTART_FAIL = 10, 4, 6
#: phase 17: compressed_psum's rounds over SmolLM-360M's gradient shapes;
#: the Kimi-K2 MoE layer's tokens (rows, tokens); the dry-run cells
PSUM_ROUNDS = 3
DIST_MOE_TOKENS = (2, 64)
DIST_MAMBA2_TOKENS = 512
DRYRUN_CELLS = (("smollm-360m", "train_4k", False, ("cuda", "cpu")),
                ("kimi-k2-1t-a32b", "decode_32k", True, ("cuda",)),
                ("whisper-large-v3", "decode_32k", False, ("cuda", "cpu")),
                ("zamba2-7b", "train_4k", False, ("cuda",)))


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


def _device_breakdown(fn, top: int = 6, by_op: bool = False) -> str:
    """Card time of one call of ``fn`` by kernel, from ``torch.profiler``
    (CUPTI): the busy total against the host wall, and the ``top`` kernels
    by self device time; with ``by_op``, also the ``top`` PyTorch ops by
    the device time of the kernels each launched itself."""
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
    out = (f"card busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall (profiled"
           f"); top kernels: " + "; ".join(parts))
    if by_op:
        ops = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0), reverse=True)
        out += "; top ops: " + "; ".join(
            f"{us / 1e3:.3f} ms x{n} {name}" for us, n, name in ops[:top])
    return out


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


def _new_goldens(core, apps, tb, pred, feats, dev) -> dict:
    """The cold-start, federation and model-derived golden runs, built as
    tests/test_golden.py builds them. Returns ``{key: (result, live)}``
    with the check that proves the scenario live."""
    kw = dict(predictor=pred, device=dev)
    out = {}
    held = {a.name for a in apps[-4:]}
    synth = core.ColdStartSynthesizer()
    svc = core.PredictionService(tb.dvfs, predictor=pred,
                                 app_features={n: v for n, v in feats.items()
                                               if n not in held},
                                 testbed=tb, device=dev)
    r = core.run_schedule(core.make_workload(apps, tb, seed=0), "min-energy",
                          core.Testbed(seed=100), service=svc,
                          coldstart=synth, device=dev)
    out[NEW_KEYS[0]] = (r, synth.stats.registered == len(held)
                        and svc.stats.synthesized_builds > 0
                        and held <= {x.name for x in r.records})
    jobs = list(core.multi_rack_workload(apps, tb, n_devices=4, n_jobs=16,
                                         seed=0, utilization=0.7))
    fac = core.FacilityCoordinator(375.0, (2, 2),
                                   share_policy="demand-weighted",
                                   escalation=True, guard=0.2)
    pre = core.FederatedPreemptionManager((2, 2), dvfs=tb.dvfs,
                                          device_slowdown={0: 3.0})
    r = core.run_schedule(jobs, "min-energy", core.Testbed(seed=100),
                          app_features=feats, n_devices=4,
                          power_coordinator=fac, preemption=pre, **kw)
    out[NEW_KEYS[1]] = (r, fac.stats.escalations >= 1 and r.migrations >= 1
                        and pre.fed.migration_j > 0)
    suite = core.model_app_suite()
    mfeats = dict(feats)
    mfeats.update(core.register_model_apps(None, tb))
    pool = [core.V5P_CLASS, core.V5E_CLASS]
    jobs = core.merge_workloads(
        core.serving_workload(suite, tb, n_jobs=14, seed=0, n_devices=2,
                              pool=pool),
        core.training_workload(suite, tb, n_jobs=4, seed=1, n_devices=2,
                               pool=pool))
    r = core.run_schedule(jobs, "min-energy", core.Testbed(seed=100),
                          app_features=mfeats, n_devices=2,
                          device_classes=pool, **kw)
    out[NEW_KEYS[2]] = (r, _models_live(r))
    return out


def _models_live(res) -> bool:
    """At least one decode job, one train step and two architectures."""
    names = {x.name for x in res.records}
    return (any(n.endswith(":decode") for n in names)
            and any(n.endswith(":train_step") for n in names)
            and len({n.split(":")[0] for n in names if ":" in n}) >= 2)


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


def _novel_apps(bases, n: int, seed: int = 42) -> list:
    """benchmarks/bench_coldstart.py's never-profiled variants: a profiled
    app's static counters with divergent latents."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = bases[i % len(bases)]
        out.append(dataclasses.replace(
            b, name=f"novel-{i}", seed=500 + i,
            stall_frac=float(rng.uniform(0.25, 0.55)),
            core_eff=float(rng.uniform(0.55, 0.8)),
            mem_eff=float(rng.uniform(0.55, 0.8)),
            wiggle_time=0.06, wiggle_power=0.05))
    return out


def _coldstart_runs(core, apps, tb, pred, feats, dev) -> dict:
    """Phase 10, cold start: bench_coldstart's frozen run (synthesized
    tables only) and corrected run (the RLS adapter over them)."""
    novel = _novel_apps(apps[-4:], COLD_NOVEL)
    jobs = list(core.stream_workload(apps + novel, tb, n_jobs=COLD_JOBS,
                                     seed=COLD_SEED, n_devices=COLD_DEVICES,
                                     utilization=0.65))
    names = {a.name for a in novel}
    out = {}
    for arm in ("frozen", "corrected"):
        svc = core.PredictionService(core.V5E_DVFS, predictor=pred,
                                     app_features=dict(feats), testbed=tb,
                                     device=dev)
        synth = core.ColdStartSynthesizer()
        adapter = (core.OnlineAdapter(svc, risk_scale=1.0, max_margin=0.2)
                   if arm == "corrected" else None)
        policy = core.RiskAware(core.V5E_DVFS, margin=0.05,
                                margin_fn=adapter and adapter.margin)
        res = core.run_schedule(jobs, policy, core.Testbed(seed=100),
                                service=svc, n_devices=COLD_DEVICES,
                                coldstart=synth, feedback=adapter,
                                device=dev)
        out[arm] = res, (synth.stats.registered == COLD_NOVEL
                         and svc.stats.synthesized_builds > 0
                         and names <= {x.name for x in res.records}), \
            f"{synth.stats.summary()}; {svc.stats.summary()}"
    return out


def _hetero_fixture(core, apps):
    """benchmarks/bench_hetero.py's full fixture: one profiling campaign
    per device class, the default predictor fitted over their union."""
    classes = (core.V5P_CLASS, core.V5E_CLASS, core.V5LITE_CLASS)
    class_features, Xs, yps, yts = {}, [], [], []
    for ci, cls in enumerate(classes):
        tb_cls = core.Testbed(dvfs=cls.dvfs, seed=0)
        rng = np.random.default_rng(7 + ci)
        feats = {a.name: core.profile_features(a, tb_cls, rng=rng)
                 for a in apps}
        class_features[cls.name] = feats
        X, yp, yt, _ = core.build_dataset(apps, tb_cls, seed=ci,
                                          app_features=feats)
        Xs.append(X), yps.append(yp), yts.append(yt)
    return (class_features,
            (np.concatenate(Xs), np.concatenate(yps), np.concatenate(yts)))


def _federation_runs(core, apps, class_features, pred, dev) -> dict:
    """Phase 10, federation: bench_federation's uncapped sizing run, its
    federated arm (demand-weighted shares, escalation) and its straggler
    rescue run on the degraded fleet, on one service."""
    tb = core.Testbed(seed=0)
    pool = core.make_device_pool(*((core.DEVICE_CLASSES[n], k)
                                   for n, k in FED_POOL))
    jobs = list(core.multi_rack_workload(apps, tb, n_jobs=FED_JOBS, seed=0,
                                         utilization=FED_UTIL,
                                         device_classes=pool))
    svc = core.PredictionService(
        core.V5E_DVFS, predictor=pred,
        app_features=class_features[core.V5E_CLASS.name],
        class_features=class_features, testbed=tb, device=dev)

    def run(coord=None, pre=None):
        return core.run_schedule(
            jobs, core.RiskAware(core.V5E_DVFS, margin=0.05),
            core.Testbed(seed=100), service=svc, device_classes=pool,
            power_coordinator=coord, preemption=pre, device=dev)

    out = {"uncapped": (run(), True, "")}
    led = core.PowerTelemetry.from_result(out["uncapped"][0], pool=pool)
    floor = sum(c.idle_power() for c in pool)
    cap = floor + FED_CAP_FRAC * (led.peak_w - floor)
    for arm in ("federated", "rescue"):
        fac = core.FacilityCoordinator(cap, list(FED_RACKS),
                                       share_policy="demand-weighted",
                                       escalation=True, guard=FED_GUARD)
        pre = (core.FederatedPreemptionManager(
            list(FED_RACKS), dvfs=core.V5E_CLASS.dvfs,
            device_slowdown={d: FED_SLOWDOWN for d in FED_DEGRADED})
            if arm == "rescue" else None)
        res = run(fac, pre)
        live = fac.stats.escalations >= 1
        note = f"cap {cap!r} W; {fac.stats.summary()}"
        if pre is not None:
            live = live and res.migrations >= 1 and pre.fed.migration_j > 0
            note += f"; {pre.fed.summary()}; migrations {res.migrations}"
        out[arm] = res, live, note
    return out


def _models_runs(core, apps, tb, pred, feats, dev) -> dict:
    """Phase 10, model-derived apps: bench_models_sched's headline mix,
    max-clock and min-energy under the same slack-weighted cap."""
    suite = core.model_app_suite()
    features = dict(feats)
    features.update(core.register_model_apps(None, tb))
    pool = [core.DEVICE_CLASSES[n] for n in MODEL_POOL]
    jobs = core.merge_workloads(
        core.serving_workload(suite, tb, n_jobs=MODEL_SERVE, seed=0,
                              n_devices=len(pool), pool=pool,
                              overload=MODEL_OVERLOAD),
        core.training_workload(suite, tb, n_jobs=MODEL_TRAIN, seed=1,
                               n_devices=len(pool), pool=pool))

    def run(policy, coord=None):
        return core.run_schedule(
            jobs, policy, core.Testbed(seed=100), predictor=pred,
            app_features=features, n_devices=len(pool), device_classes=pool,
            power_coordinator=coord, device=dev)

    led = core.PowerTelemetry.from_result(run("mc"), pool=pool)
    idle = sum(c.idle_power() for c in pool)
    cap = idle + MODEL_CAP_FRAC * max(led.peak_w - idle, 1.0)
    out = {}
    for policy in ("mc", "min-energy"):
        coord = core.PowerCapCoordinator(cap, grant_policy="slack-weighted",
                                         guard=MODEL_GUARD)
        res = run(policy, coord)
        out[policy] = res, _models_live(res), (f"cap {cap!r} W; "
                                               f"{coord.stats.summary()}")
    return out


def _phase10(core, gp, counters, apps, tb, preds, feats, fed_preds,
             class_features, dev, card) -> dict:
    """Phase 10: the cold-start, federation and model-derived layers at
    full size, on the card and on the CPU, records equal field for field.
    Returns K1's launches (by batch rows too) and walls per scenario."""
    print(f"== phase 10: cold start, federation and model-derived apps at "
          f"full size; card {card}")
    scenarios = {
        "coldstart": lambda d, label: _coldstart_runs(
            core, apps, tb, preds[label], feats, d),
        "federation": lambda d, label: _federation_runs(
            core, apps, class_features, fed_preds[label], d),
        "models": lambda d, label: _models_runs(
            core, apps, tb, preds[label], feats, d)}
    report = {}
    for name, scenario in scenarios.items():
        runs = {}
        for label, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            _reset(counters)                         # this slice's path
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[label] = scenario(d, label)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if label == "cuda":
                report[name] = dict(
                    launches=gp.launches,
                    by_rows=dict(sorted(gp.rows_launches.items())),
                    wall_s=wall)
            else:
                report[name]["cpu_wall_s"] = wall
            for arm, (res, _, note) in runs[label].items():
                print(f"   {name}/{arm} [{label}]: {len(res.records)} "
                      f"records, misses {res.misses}, total_energy "
                      f"{float(res.total_energy)!r} J; {note}", flush=True)
            print(f"   {name} [{label}]: {wall:.3f} s (host clock)"
                  + (f"; kernel launches {report[name]['launches']}, by "
                     f"batch rows {report[name]['by_rows']}"
                     if label == "cuda" else ""), flush=True)
        for arm, (rc, live, _) in runs["cuda"].items():
            rh = runs["cpu"][arm][0]
            _check(len(rc.records) == len(rh.records)
                   and all(_fields(a) == _fields(b)
                           for a, b in zip(rc.records, rh.records))
                   and rc.total_energy == rh.total_energy,
                   f"{name}/{arm}: cuda vs cpu records, field for field")
            _check(live and runs["cpu"][arm][1], f"{name}/{arm} is live")
        _check(report[name]["launches"] > 0,
               f"{name}: the kernel never launched")
        print(f"   {name}: cuda == cpu field for field in every run; "
              f"every run live", flush=True)
    return report


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


def _live_pairs(Sq, Sk, causal=True, window=None) -> int:
    """(query, key) pairs the mask keeps, queries right-aligned: row i sits
    at position i + Sk - Sq."""
    live = 0
    for i in range(Sq):
        pos = i + Sk - Sq
        hi = min(Sk, pos + 1) if causal else Sk
        lo = max(0, pos - window + 1) if window else 0
        live += max(0, hi - lo)
    return live


def _attn_bound_ms(B, Sq, Sk, Hq, Hkv, hd, itemsize, causal=True,
                   window=None) -> tuple[float, str]:
    """Least time for one call: q, k, v read and out written once at HBM
    rate, or the two products over the live (query, key) pairs (4 hd
    operations each) at the bf16 tensor-core rate."""
    ops = 4 * hd * B * Hq * _live_pairs(Sq, Sk, causal, window)
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
    family_errs = {}
    for name, (B, Sq, Hq, Hkv, hd), Sk, kw in FAMILY_ATTN:
        q, k, v = _attn_inputs(5, B, Sq, Hq, Hkv, hd, torch.bfloat16, dev, Sk)
        route, err, tol = _attention_case(fa, ops, ref, q, k, v, kw,
                                          f"attention, {name}")
        _check(route == "wgmma", f"{name} took the {route} route")
        family_errs[name] = err
        print(f"   attention {name}: B={B} Sq={Sq} Sk={Sk or Sq} Hq={Hq} "
              f"Hkv={Hkv} hd={hd} {kw} bf16 [{route}]: {err:.3e} (atol "
              f"{tol[0]:.3e})", flush=True)
        del q, k, v
    errs, h_errs = {}, {}
    # SERVE_SCAN last: phase 6 times its inputs
    for shape in SCAN_SWEEP + (FAMILY_SCAN,) + FALCON_SCAN + (SERVE_SCAN,):
        args = _scan_inputs(3, *shape, dev)
        y, h = ops.mamba_scan(*args)
        wy, wh = ref.mamba_scan_ref(*args)
        torch.cuda.synchronize()
        errs[shape] = _close(y, wy, F32_TOL, f"scan y {shape}")
        h_errs[shape] = _close(h, wh, F32_TOL, f"scan h_last {shape}")
        print(f"   scan B,L,Di,N={shape}: y {errs[shape]:.3e}, h_last "
              f"{h_errs[shape]:.3e}", flush=True)
        del y, h, wy, wh
    return {"attn_inputs": qkv, "attn_err": attn_err, "scan_inputs": args,
            "scan_err": errs[SERVE_SCAN], "family_attn_err": family_errs,
            "family_scan_err": errs[FAMILY_SCAN],
            "falcon_scan_err": {s: (errs[s], h_errs[s])
                                for s in FALCON_SCAN}}


def _kernel_times(fa, ops, ref, p5, card, dev) -> dict:
    """Phase 6: per-call times at the serving shapes (CUDA events), and at
    phases 11-15's new shapes."""
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
    family_attn = []
    for name, (B, Sq, Hq, Hkv, hd), Sk, kw in FAMILY_ATTN:
        q, k, v = _attn_inputs(5, B, Sq, Hq, Hkv, hd, torch.bfloat16, dev, Sk)
        Sk = Sk or Sq
        ms_ = _time_cuda(lambda: ops.flash_attention(q, k, v, **kw), 10)
        plain = _time_cuda(lambda: _plain_attn(ref, q, k, v, **kw), 2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if "window" in kw:   # SDPA has no window: its boolean mask
            qi = torch.arange(Sq, device=dev)[:, None] + Sk - Sq
            kj = torch.arange(Sk, device=dev)[None, :]
            mask = (kj <= qi) & (kj > qi - kw["window"])
        causal = kw.get("causal", True) and mask is None
        lib = _time_cuda(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=True),
            10)
        bound, by = _attn_bound_ms(B, Sq, Sk, Hq, Hkv, hd, 2,
                                   kw.get("causal", True), kw.get("window"))
        family_attn.append(dict(
            name=name, shape=[B, Sq, Sk, Hq, Hkv, hd], options=kw, ms=ms_,
            plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
            max_abs_err=p5["family_attn_err"][name]))
        print(f"   flash_attention {name} B={B} Sq={Sq} Sk={Sk} Hq={Hq} "
              f"Hkv={Hkv} hd={hd} {kw} bf16: kernel (wgmma) {ms_:.6f}  "
              f"plain {plain:.6f}  sdpa {lib:.6f}  bound {bound:.6f} ({by})"
              f"  kernel/bound {ms_ / bound:.1f}  kernel/sdpa "
              f"{ms_ / lib:.2f}", flush=True)
        del q, k, v, qt, kt, vt
    args = _scan_inputs(3, *FAMILY_SCAN, dev)
    f_ms = _time_cuda(lambda: ops.mamba_scan(*args), 10)
    f_plain = _time_cuda(lambda: ref.mamba_scan_ref(*args), 1)
    f_bound, f_by = _scan_bound_ms(*FAMILY_SCAN)
    print(f"   mamba_scan B,L,Di,N={FAMILY_SCAN} fp32 (zamba2-7b's Mamba-2 "
          f"prefill): kernel {f_ms:.6f}  plain {f_plain:.6f}  bound "
          f"{f_bound:.6f} ({f_by})  kernel/bound {f_ms / f_bound:.1f}",
          flush=True)
    family_scan = dict(shape=list(FAMILY_SCAN), ms=f_ms, plain_ms=f_plain,
                       library_ms=None, bound_ms=f_bound, bound_by=f_by,
                       max_abs_err=p5["family_scan_err"])
    return {"flash_attention": dict(ms=a_ms, plain_ms=a_plain,
                                    library_ms=a_lib, bound_ms=a_bound,
                                    bound_by=a_by, simt_ms=a_simt,
                                    family_shapes=family_attn),
            "mamba_scan": dict(ms=s_ms, plain_ms=s_plain, library_ms=None,
                               bound_ms=s_bound, bound_by=s_by,
                               ms_batch1=s_one, family_shapes=[family_scan])}


def _sfu_exps_per_s(dev) -> float:
    """The card's exp2 rate: the SFUs' results a clock an SM, times the
    SMs, times the SM clock's maximum (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return SFU_EXPS_PER_CLOCK_SM * sms * mhz * 1e6


def _mamba1_scan_times(ms, ops, p5, dev) -> list:
    """Phase 6's K3 Mamba-1 kernel (``ops.mamba_scan``) at
    ``falcon-mamba-7b.prefill``'s scans, checked in phase 5: one launch a
    call, timed (median of 20, CUDA events) beside the bound of
    ``perfbench/counts/ssm.scan`` (bf16 x, dt, y, B, C: what
    ``mamba1_scan_roofline.prefill`` prices), the bound of the fp32
    bytes the kernel moves (``_scan_bound_ms``), and the floor of its
    B·L·Di·N exps at the SFU rate."""
    from perfbench.counts import ssm as scounts
    exps_per_s = _sfu_exps_per_s(dev)
    rows = []
    for shape in FALCON_SCAN:
        B, L, Di, N = shape
        args = _scan_inputs(3, *shape, dev)
        n0 = ms.launches
        ops.mamba_scan(*args)
        torch.cuda.synchronize()
        _check(ms.launches - n0 == 1, "one Mamba-1 scan launch a call")
        ms_ = _time_cuda_median(lambda: ops.mamba_scan(*args))
        ops_, nbytes = scounts.scan(B, L, Di, N)
        bound = max(ops_ / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        fp32_bound, fp32_by = _scan_bound_ms(*shape)
        exp_floor = B * L * Di * N / exps_per_s * 1e3
        err, herr = p5["falcon_scan_err"][shape]
        rows.append(dict(shape=list(shape), ms=ms_, bound_ms=bound,
                         bound_by="bytes", roofline_pct=100 * bound / ms_,
                         fp32_bound_ms=fp32_bound, fp32_bound_by=fp32_by,
                         exp_floor_ms=exp_floor, exps_per_s=exps_per_s,
                         max_abs_err=err, h_last_max_abs_err=herr))
        print(f"   mamba_scan (K3, Mamba-1 route) falcon-mamba-7b.prefill "
              f"B={B} L={L} Di={Di} N={N} fp32: kernel {ms_:.6f}  bound "
              f"{bound:.6f} (counts/ssm.scan)  roofline "
              f"{100 * bound / ms_:.2f} %  fp32 bound {fp32_bound:.6f} "
              f"({fp32_by})  exp floor {exp_floor:.6f} "
              f"({exps_per_s / 1e12:.3f} T exp2/s)  max abs err y "
              f"{err:.3e} h_last {herr:.3e}", flush=True)
        del args
        _free()
    return rows


def _time_cuda_median(fn, reps: int = 20) -> float:
    """Milliseconds of one call on the card's timeline (CUDA events around
    each of ``reps`` calls after a warm-up), the median. Each call is
    queued behind a ~1 ms sleep kernel, so that the host's time to issue
    it (~0.05 ms of Python) does not count as the card's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _worst_ratio(got, want, tol) -> float:
    """The largest |got - want| / (atol + rtol |want|): above 1 fails."""
    atol, rtol = tol
    w = want.double()
    err = (got.double() - w).abs()
    return float(torch.where(err == 0, 0.0, err / (atol + rtol * w.abs()))
                 .max())


def _decode_attention_times(da, ops, ref, dev) -> list:
    """Phase 6's end: K4 at the decode cells' layers against its plain
    version (``da.tolerance``, derived from the inputs), with faults of
    one slot planted in the kernel's arguments (the slot at ``pos``
    dropped, one past it added) and of a 16-row step in the plain
    version's mask, each of which must fail the same check; and its time
    beside its bound (the live K and V, q and out, each read or written
    once at HBM rate), the plain version's (``_gqa``, which casts the
    whole cache to fp32) and SDPA's over the same boolean mask (a
    yardstick only: the port never calls it)."""
    rows = []
    for name, (B, Hq, Hkv, hd) in DECODE_ATTN:
        gen = torch.Generator(device=dev).manual_seed(9)
        q = torch.randn((B, 1, Hq, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B, Hkv, DECODE_SLOTS, hd), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        pos = DECODE_POS
        want = da.plain(q, k, v, pos)
        tol = da.tolerance(q, k, v, pos)
        got = ops.decode_attention(q, k, v, pos)
        err = _close(got, want, tol, f"K4 {name}")
        worst = _worst_ratio(got, want, tol)
        kj = torch.arange(DECODE_SLOTS, device=dev)
        faults = {"slot at pos dropped": ops.decode_attention(q, k, v,
                                                              pos - 1),
                  "slot past pos added": ops.decode_attention(q, k, v,
                                                              pos + 1),
                  "a 16-row step skipped": ref.gqa_ref(
                      q, k, v, (kj <= pos) & ((kj < 640) | (kj >= 656)))}
        caught = {f: _worst_ratio(g, want, tol) for f, g in faults.items()}
        for f, r in caught.items():
            _check(r > 1.0, f"K4 {name}: the fault '{f}' passes the check "
                   f"(|err| / bound up to {r})")
        del got, want, tol, faults
        ms_ = _time_cuda_median(lambda: ops.decode_attention(q, k, v, pos))
        valid = torch.arange(DECODE_SLOTS, device=dev) <= pos
        plain = _time_cuda_median(lambda: ref.gqa_ref(q, k, v, valid))
        qt = q.transpose(1, 2)
        lib = _time_cuda_median(lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=valid[None], enable_gqa=True))
        nbytes = 2 * (2 * B * Hkv * (pos + 1) * hd + 2 * B * Hq * hd)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(name=name, shape=[B, Hq, Hkv, hd, DECODE_SLOTS],
                         pos=pos, ms=ms_, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by="bytes", max_abs_err=err,
                         worst_of_bound=worst, faults_of_bound=caught))
        print(f"   decode_attention (K4) {name} B={B} Hq={Hq} Hkv={Hkv} "
              f"hd={hd} S_max={DECODE_SLOTS} pos={pos} bf16: kernel "
              f"{ms_:.6f}  plain {plain:.6f}  sdpa {lib:.6f}  bound "
              f"{bound:.6f} (bytes)  kernel/bound {ms_ / bound:.2f}  "
              f"plain/kernel {plain / ms_:.1f}  max abs err {err:.3e}, "
              f"{worst:.3f} of its bound; planted faults "
              + ", ".join(f"{f} {r:.2f}" for f, r in caught.items())
              + " of it", flush=True)
        del q, k, v
    return rows


def _mamba2_scan_times(m2, ops, ref, dev) -> list:
    """Phase 6's Mamba-2 route (K3, ``ops.mamba2_scan``) at Zamba2-7B's
    layer: B 1 at L 2 048 and 4 096, and the decode cell's batch prefill,
    B 32 L 512, in bf16 as served (x, B and C strided views of one
    projection, y written in bf16). Checked against the plain version
    (y within F32_TOL's atol and one bf16 ulp, the state within
    F32_TOL), equal bit for bit to the route it replaced (the Mamba-1
    kernel once a group on the expanded fp32 inputs, y rounded once to
    bf16), one launch a call; timed (median of 20, CUDA events)
    beside that route's two Mamba-1 calls alone and with its copies, the
    plain version and the bound of ``perfbench/counts/hybrid.scan``."""
    from perfbench.counts import hybrid as hcounts
    H, P, G, N = MAMBA2_LAYER
    rows = []
    for B, L in MAMBA2_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(16)
        Di = H * P
        xBC = torch.randn((B, L, Di + 2 * G * N), generator=gen,
                          device=dev).to(torch.bfloat16)
        x = xBC[..., :Di].unflatten(-1, (H, P))
        Bm = xBC[..., Di:Di + G * N].unflatten(-1, (G, N))
        Cm = xBC[..., Di + G * N:].unflatten(-1, (G, N))
        dt = F.softplus(torch.randn((B, L, H), generator=gen, device=dev)
                        - 1.0)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        D = torch.linspace(0.5, 1.5, H, device=dev)
        args = (x, dt, A, Bm, Cm, D)
        n0 = m2.launches
        y, h = ops.mamba2_scan(*args)
        torch.cuda.synchronize()
        _check(m2.launches - n0 == 1, "one Mamba-2 scan launch a call")
        _check(y.dtype == torch.bfloat16, "mamba2_scan: y not in bf16")
        wy, wh = ref.mamba2_scan_ref(*args)
        # both round an fp32 sum once: the sums' tolerance and one ulp
        err = _close(y, wy, (F32_TOL[0], BF16_TOL[1] + F32_TOL[1]),
                     f"mamba2_scan y {B, L}")
        herr = _close(h, wh, F32_TOL, f"mamba2_scan h_last {B, L}")
        oy, oh = ref.mamba2_scan_ref(*args, scan=ops.mamba_scan)
        _check(torch.equal(y, oy) and torch.equal(h, oh),
               f"mamba2_scan {B, L}: not the Mamba-1 route's bits")
        del y, h, wy, wh, oy, oh
        ms_ = _time_cuda_median(lambda: ops.mamba2_scan(*args))
        # the route it replaced: dt, A and D expanded to every channel,
        # fp32 copies, one Mamba-1 call a group
        dt_c = dt.bfloat16().float().repeat_interleave(P, dim=-1)
        A_c = A.repeat_interleave(P)[:, None].expand(Di, N).contiguous()
        D_c = D.repeat_interleave(P)
        c = Di // G
        expanded = [(x.flatten(2)[..., g * c:(g + 1) * c].float()
                     .contiguous(), dt_c[..., g * c:(g + 1) * c].contiguous(),
                     A_c[g * c:(g + 1) * c].contiguous(),
                     Bm[:, :, g].float().contiguous(),
                     Cm[:, :, g].float().contiguous(),
                     D_c[g * c:(g + 1) * c].contiguous()) for g in range(G)]
        two = _time_cuda_median(lambda: [ops.mamba_scan(*e)
                                         for e in expanded])
        whole = _time_cuda_median(lambda: ref.mamba2_scan_ref(
            *args, scan=ops.mamba_scan))
        del expanded, dt_c, A_c
        plain = _time_cuda(lambda: ref.mamba2_scan_ref(*args), 1)
        ops_, nbytes = hcounts.scan(B, L, H, P, G, N)
        bound = max(ops_ / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        rows.append(dict(shape=[B, L, H, P, G, N], ms=ms_,
                         mamba1_two_calls_ms=two, replaced_route_ms=whole,
                         plain_ms=plain, bound_ms=bound, bound_by="bytes",
                         roofline_pct=100 * bound / ms_, max_abs_err=err,
                         h_last_max_abs_err=herr))
        print(f"   mamba2_scan (K3, Mamba-2 route) B={B} L={L} H={H} P={P} "
              f"G={G} N={N} bf16: kernel {ms_:.6f}  two Mamba-1 calls "
              f"{two:.6f}  with their copies {whole:.6f}  plain "
              f"{plain:.6f}  bound {bound:.6f} (counts/hybrid.scan)  "
              f"roofline {100 * bound / ms_:.2f} %  max abs err y {err:.3e}"
              f" h_last {herr:.3e}; the replaced route's bits", flush=True)
        del xBC, x, Bm, Cm, dt, args
        _free()
    return rows


def _bf16_attention_check(cfg, fa, ops, ref, dev) -> float:
    """Phase 7's end: a 2-layer, full-width bf16 prefill of one serving-length
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


def _gib(module) -> float:
    return sum(p.numel() * p.element_size()
               for p in module.parameters()) / 2 ** 30


def _free():
    """Return the card's cached blocks after the caller dropped its
    references."""
    gc.collect()
    torch.cuda.empty_cache()


def _serve(arch: str, per_prefill: dict, counters, dev, phase: int, *,
           attentions=0, layers=None, batch=SERVE_BATCH,
           prompt=SERVE_PROMPT, steps=SERVE_STEPS, check=None) -> dict:
    """Phases 7, 8 and 11-15: serve one model at full width (depth cut to
    ``layers`` where one card cannot hold it), then hold the port on the
    card to the port on the CPU (:func:`_cpu_check`, with ``check``'s
    config changes). ``per_prefill`` maps each kernel module of the path to
    its launches in one prefill, which greedy_generate's run must show
    exactly; every bf16 attention launch must take the wgmma route; and
    the decode-attention kernel (K4) must serve each of a decode step's
    ``attentions`` cached self-attentions on every decode step. Returns
    the launch counts of greedy_generate's run, by kernel (and by
    route for attention)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.train import serve
    cfg = get_config(arch)
    full = cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, **layers)
    B, S = batch, prompt
    V = cfg.vision_tokens if cfg.family == "vlm" else 0
    max_seq = V + S + steps + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    tokens = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = model.extra_inputs(cfg, B, S, "prefill",
                               torch.Generator(device=dev).manual_seed(4),
                               device=dev)
    positions = B * (V + S + (cfg.encoder_seq if cfg.family == "audio"
                              else 0))
    prefill = serve.make_prefill_step(cfg, max_seq, device=dev)
    step = serve.make_serve_step(cfg, device=dev)
    logits, cache = prefill(params, tokens, extra)       # warm-up
    _check(tuple(logits.shape) == (B, V + S, cfg.vocab_size)
           and bool(torch.isfinite(logits).all()),
           f"{arch}: prefill logits finite, of shape (B, S, vocab)")
    del logits, cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, extra)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    toks = [tok]
    del logits
    prefill_profile = _device_breakdown(lambda: prefill(params, tokens,
                                                        extra))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = step(params, cache, tok, V + S + i)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    _check(bool(torch.isfinite(logits).all()), f"{arch}: decode logits")
    del logits
    try:   # the card's own time for one step: captured once, replayed
        step_dev_ms = _time_graph(
            lambda: step(params, cache, tok, V + S + steps), 1)
    except RuntimeError as exc:  # a refused capture costs the number only
        step_dev_ms = None
        print(f"   decode step CUDA-graph capture refused: {exc}")
    del cache

    _reset(counters)                                     # the main path
    t0 = time.perf_counter()
    out = serve.greedy_generate(cfg, params, tokens, steps + 1, max_seq,
                                extra=extra, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in counters}
    by_route = {m.__name__.rsplit(".", 1)[-1]: dict(m.route_launches)
                for m in counters if hasattr(m, "route_launches")}
    launches["by_route"] = by_route
    for kernel, n in per_prefill.items():
        _check(kernel.launches == n, f"{arch}: greedy_generate launched "
               f"{kernel.__name__} {kernel.launches} times, one prefill "
               f"has {n}")
        if hasattr(kernel, "route_launches"):   # bf16 serving: all wgmma
            _check(kernel.route_launches["wgmma"] == kernel.launches,
                   f"{arch}: attention launches by route {by_route}")
    _check(launches["decode_attention"] == attentions * steps,
           f"{arch}: greedy_generate's {steps} decode steps launched the "
           f"decode-attention kernel {launches['decode_attention']} times, "
           f"not once for each of {attentions} attentions a step")
    _check(tuple(out.shape) == (B, steps + 1) and out.dtype == torch.int32
           and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
           f"{arch}: generated tokens")
    same = bool(torch.equal(out, torch.cat(toks, dim=1)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cut = ("" if cfg.n_layers == full.n_layers else
           f", depth cut from {full.n_layers} (one card holds "
           f"{_gib(params):.1f} of {full.param_count() * 2 / 2 ** 30:.0f} "
           f"GiB)")
    what = f"{B} prompts x {S} tokens" + (
        f" after {V} vision embeddings" if V else "") + (
        f" over {cfg.encoder_seq} stub frames each" if
        cfg.family == "audio" else "")
    print(f"== phase {phase}: {arch} ({n_params / 1e9:.3f} B params, "
          f"param_count() {cfg.param_count() / 1e9:.3f} B, "
          f"{_gib(params):.2f} GiB, {cfg.param_dtype}, {cfg.n_layers} "
          f"layers{cut}, d_model {cfg.d_model}) on {dev}: init {init_s:.2f} "
          f"s; {what}, prefill {prefill_s:.4f} s = {positions / prefill_s:.1f}"
          f" positions/s; {steps} decode steps {decode_s:.4f} s = "
          f"{B * steps / decode_s:.2f} tokens/s (host clock, synchronized);"
          f" one decode step on the card alone (CUDA graph replay) "
          f"{_fmt_ms(step_dev_ms)} ms of {decode_s / steps * 1e3:.3f} ms;"
          f" greedy_generate({steps + 1} tokens) {gen_s:.4f} s, kernel "
          f"launches {launches}, tokens equal to the timed loop's: {same}; "
          f"peak device memory {peak:.2f} GiB", flush=True)
    print(f"   one prefill by kernel: {prefill_profile}", flush=True)
    del out, toks, tok
    check = dict(check or {})
    served = params if check.pop("served", False) else None
    del params
    _free()
    _cpu_check(cfg, dev, served, **check)
    return launches


def _routed_prefill(cfg, params, req, max_seq, dev):
    """A bf16 prefill of the one request ``req`` as served, each MoE
    layer's routing recorded here in the harness. Returns the logits on the
    CPU and, stacked over the MoE layers, (S, E) booleans: the top-k
    experts of each token, and those of them that their expert's capacity
    kept (slots go to tokens in order, the reference's stable sort)."""
    from repro_torch.models import model
    from repro_torch.models import moe as moe_mod
    routed, kept = [], []
    inner = moe_mod.moe

    def recording(p, x, c):
        S, E = x.shape[1], c.n_experts
        top_i = torch.topk(torch.softmax(x[0].float() @ p.router, dim=-1),
                           c.top_k, dim=-1).indices
        m = torch.zeros(S, E, dtype=torch.bool, device=x.device)
        m.scatter_(1, top_i, True)
        earlier = m.long().cumsum(0) - m.long()     # earlier tokens per expert
        routed.append(m.cpu())
        kept.append((m & (earlier < moe_mod.capacity(c, S))).cpu())
        return inner(p, x, c)

    moe_mod.moe = recording
    try:
        logits, _ = model.prefill(cfg, params, req, max_seq, device=dev)
    finally:
        moe_mod.moe = inner
    _check(len(routed) > 0, f"{cfg.name}: the prefill ran no MoE layer")
    return logits.cpu(), torch.stack(routed), torch.stack(kept)


def _cpu_check(cfg, dev, served=None, prompt: int = 128,
               **changes) -> None:
    """One ``prompt``-token request prefilled and one step decoded on the
    card and on the CPU, logits within CPU_TOL: the model at fp32, 2
    layers (or ``changes``), full width; or, given the ``served`` model
    (for Kimi-K2, whose MoE layer is 68 GB at fp32), its bf16 weights
    copied to the CPU as they are and run with fp32 activations on both
    devices (each product casts its weight exactly). Either way the
    decode's attention is the plain path on both devices (K4 takes bf16
    alone). The served model is
    then also compared in bf16 as served: a bf16 router input one ulp
    apart can move a token's 8th of 384 experts, which moves its logits by
    O(1), so the routing of each device is the witness
    (:func:`_routed_prefill`), and the tokens whose routing agrees on both
    are held within 2**-4 of max |logit|."""
    from repro_torch.convert import model_arrays, model_from_arrays
    from repro_torch.models import model
    if served is None:
        cfg2 = dataclasses.replace(cfg, **{"n_layers": 2, **changes},
                                   param_dtype="float32",
                                   activation_dtype="float32")
        p_cuda = model.init(cfg2, torch.Generator(device=dev).manual_seed(1),
                            device=dev)
        p_cpu = model_from_arrays(cfg2, model_arrays(p_cuda), device="cpu")
    else:
        cfg2 = dataclasses.replace(cfg, activation_dtype="float32")
        p_cuda, p_cpu = served, type(served)(cfg, "cpu")
        p_cpu.load_state_dict(served.state_dict())
    req = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, prompt))
    extra = model.extra_inputs(cfg2, 1, prompt, "prefill",
                               torch.Generator(device=dev).manual_seed(5),
                               device=dev)
    V = cfg2.vision_tokens if cfg2.family == "vlm" else 0
    max_seq = V + prompt + 32
    errs = []
    la, ca = model.prefill(cfg2, p_cuda, req, max_seq, extra,
                           cache_dtype=torch.float32, device=dev)
    lb, cb = model.prefill(cfg2, p_cpu, req, max_seq,
                           {k: v.cpu() for k, v in extra.items()},
                           cache_dtype=torch.float32, device="cpu")
    errs.append(_close(la.cpu(), lb, CPU_TOL,
                       f"{cfg.name}: prefill cuda vs cpu"))
    nxt = lb[:, -1:].argmax(dim=-1)
    da, _ = model.decode_step(cfg2, p_cuda, ca, nxt, V + prompt, device=dev)
    db, _ = model.decode_step(cfg2, p_cpu, cb, nxt, V + prompt, device="cpu")
    errs.append(_close(da.cpu(), db, CPU_TOL,
                       f"{cfg.name}: decode cuda vs cpu"))
    del la, lb, ca, cb, da, db
    _free()
    depth = (f"{cfg2.n_encoder_layers} + {cfg2.n_layers}"
             if cfg2.family == "audio" else f"{cfg2.n_layers}")
    what = ("its served bf16 weights with fp32 activations" if served
            is not None else "fp32")
    after = f" after {V} vision embeddings" if V else ""
    print(f"   {cfg.name} {what}, {depth} layers, full width, one "
          f"{prompt}-token request{after}: cuda vs cpu logits max abs err "
          f"prefill {errs[0]:.3e}, decode {errs[1]:.3e} (tol {CPU_TOL}; "
          f"TF32 off)", flush=True)
    if served is not None:
        ba, ra, ka = _routed_prefill(cfg, p_cuda, req, max_seq, dev)
        bb, rb, kb = _routed_prefill(cfg, p_cpu, req, max_seq, "cpu")
        flipped = (ra != rb).any(-1).any(0)              # (S,) top-k sets
        moved = flipped | (ka != kb).any(-1).any(0)      # ... or kept sets
        held = ~moved
        _check(int(held.sum()) >= prompt // 2,
               f"{cfg.name}: routing agrees for {int(held.sum())} of "
               f"{prompt} tokens, fewer than half to hold")
        tol = 2.0 ** -4 * float(bb.abs().max())
        err = float((ba - bb)[0, held].abs().max())
        _check(err <= tol, f"{cfg.name}: bf16 cuda vs cpu at the "
               f"{int(held.sum())} tokens whose routing agrees: max abs "
               f"err {err:.3e} > {tol:.3e}")
        agree = float((ba.argmax(-1) == bb.argmax(-1)).float().mean())
        print(f"   ... in bf16 as served: top-{cfg.top_k} expert sets differ"
              f" for {int(flipped.sum())} of {prompt} tokens, kept sets "
              f"(capacity) for {int(moved.sum())}; the other "
              f"{int(held.sum())}: max abs err {err:.3e} (tol 2**-4 max "
              f"|logit| = {tol:.3e}); all tokens: max abs err "
              f"{float((ba - bb).abs().max()):.3e}, next token equal at "
              f"{agree:.3f} of positions (not held)", flush=True)
        del ba, bb
    del p_cuda, p_cpu
    _free()


def _state_bytes(state) -> int:
    """Bytes of an optimizer state's moments (m and v)."""
    from repro_torch.optim import adamw
    total = 0
    for side in (state.m, state.v):
        for val in side.values():
            for t in (val if isinstance(val, adamw.QuantState) else (val,)):
                total += t.numel() * t.element_size()
    return total


def _train_smollm(counters, fa, ms, dev, card) -> dict:
    """Phase 16's main path: SmolLM-360M at full width and depth, AdamW with
    fp32 state, train_4k's sequence, TRAIN_BATCH rows in TRAIN_MICRO
    microbatches; no attention or scan kernel may launch. Then the trained
    model served through greedy_generate (its prefill launches K2 once a
    layer, on the wgmma route), and TRAIN_INT8 steps with int8 state."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import serve
    from repro_torch.train.step import make_train_step
    cfg = get_config(TRAIN_ARCH)
    _check(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
           f"{TRAIN_ARCH}: remat 'full', bf16 params as configured")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    _check(n_params == TRAIN_PARAMS == cfg.param_count(),
           f"{TRAIN_ARCH}: {n_params} params")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0, order=2))
    t0 = time.perf_counter()
    n_steps = TRAIN_WARM + TRAIN_TIMED + 1 + TRAIN_INT8
    batches = [data.batch(s) for s in range(n_steps)]
    data_s = time.perf_counter() - t0
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    print(f"== phase 16: {TRAIN_ARCH} trained at full width and depth "
          f"({n_params} params, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size} tied, "
          f"{cfg.param_dtype}, remat {cfg.remat}) on {dev}; card {card}; "
          f"SyntheticLM order 2 seed 0, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"a step in {TRAIN_MICRO} microbatches of "
          f"{TRAIN_BATCH // TRAIN_MICRO} (cut: train_4k's global batch "
          f"{TRAIN_FULL_BATCH} -> {TRAIN_BATCH} to fit the run's time); "
          f"{n_steps} batches made in {data_s:.2f} s (host)", flush=True)

    ocfg = adamw.AdamWConfig(**TRAIN_OPT)
    opt = adamw.init(params, ocfg)
    step = make_train_step(cfg, ocfg, microbatches=TRAIN_MICRO, device=dev)
    _reset(counters)                                     # the main path
    times, losses = [], []
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, opt, batches[i])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss = float(m["loss"])
        _check(np.isfinite(loss), f"{TRAIN_ARCH}: step {i} loss {loss}")
        losses.append(loss)
        timed = i >= TRAIN_WARM
        if timed:
            times.append(dt)
        print(f"   step {i} ({'timed' if timed else 'untimed'}): loss "
              f"{loss:.6f} grad_norm {float(m['grad_norm']):.6f} lr "
              f"{float(m['lr']):.3e}; {dt * 1e3:.1f} ms", flush=True)
    train_launches = {m_.__name__.rsplit(".", 1)[-1]: m_.launches
                      for m_ in counters}
    _check(fa.launches == 0 and ms.launches == 0,
           f"{TRAIN_ARCH}: training launched kernels {train_launches}")
    step_s = float(np.mean(times))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tflops = flops / step_s / 1e12
    print(f"   {TRAIN_TIMED} timed steps: mean {step_s * 1e3:.1f} ms "
          f"(min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}; host "
          f"clock, synchronized) = {tokens / step_s:.1f} tokens/s; "
          f"6*N*tokens = {flops / 1e12:.2f} TFLOP a step = {tflops:.2f} "
          f"TFLOP/s = {tflops * 1e12 / BF16_OPS_PER_S * 100:.2f} % of the "
          f"H100 SXM's dense bf16 peak ({BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s, NVIDIA data sheet); peak device memory {peak:.2f} GiB;"
          f" kernel launches during training {train_launches}", flush=True)
    profile = _device_breakdown(
        lambda: step(params, opt, batches[TRAIN_WARM + TRAIN_TIMED]),
        top=10, by_op=True)
    print(f"   one train step by kernel: {profile}", flush=True)
    _check(fa.launches == 0 and ms.launches == 0,
           f"{TRAIN_ARCH}: the profiled step launched a kernel")

    B, S, n = TRAIN_SERVE
    prompt = np.random.default_rng(16).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    _reset(counters)
    out = serve.greedy_generate(cfg, params, prompt, n, S + n + 1,
                                device=dev)
    torch.cuda.synchronize()
    served = {m_.__name__.rsplit(".", 1)[-1]: m_.launches for m_ in counters}
    served["by_route"] = {"flash_attention": dict(fa.route_launches)}
    _check(fa.launches == cfg.n_layers
           and fa.route_launches["wgmma"] == cfg.n_layers
           and ms.launches == 0
           and served["decode_attention"] == cfg.n_layers * (n - 1),
           f"{TRAIN_ARCH}: serving the trained model launched {served}")
    _check(tuple(out.shape) == (B, n) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"{TRAIN_ARCH}: generated tokens")
    print(f"   the trained model served: {B} prompts x {S} tokens, "
          f"greedy_generate({n}) launches {served}", flush=True)

    fp32_bytes = _state_bytes(opt)
    del opt
    _free()
    ocfg8 = adamw.AdamWConfig(state_dtype="int8", **TRAIN_OPT)
    opt8 = adamw.init(params, ocfg8)
    int8_bytes = _state_bytes(opt8)
    n_quant = sum(p.numel() for p in params.parameters()
                  if adamw.quantizable(p.shape))
    step8 = make_train_step(cfg, ocfg8, microbatches=TRAIN_MICRO,
                            device=dev)
    _reset(counters)
    for i in range(TRAIN_INT8):
        _, _, m = step8(params, opt8, batches[-TRAIN_INT8 + i])
        loss = float(m["loss"])
        _check(np.isfinite(loss), f"{TRAIN_ARCH}: int8 step {i} loss {loss}")
        print(f"   int8-state step {i}: loss {loss:.6f} grad_norm "
              f"{float(m['grad_norm']):.6f}", flush=True)
    _check(fa.launches == 0 and ms.launches == 0,
           f"{TRAIN_ARCH}: int8 training launched a kernel")
    print(f"   optimizer state (m, v): int8 {int8_bytes} B against fp32 "
          f"{fp32_bytes} B ({int8_bytes / fp32_bytes:.3f}); {n_quant} of "
          f"{n_params} params have a last axis that is a multiple of 128",
          flush=True)
    del opt8, params, batches
    _free()
    return {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "tflops": tflops, "peak_gib": peak, "losses": losses,
            "train_launches": train_launches, "served": served,
            "int8_bytes": int8_bytes, "fp32_bytes": fp32_bytes}


def _family_batch(cfg, rows=FAMILY_TRAIN_ROWS, seed=1) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    batch = dict(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=FAMILY_TRAIN_SEQ,
        global_batch=rows, seed=seed)).batch(0))
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (rows, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _train_families(dev) -> float:
    """Every reduced architecture (fp32) takes one train step on the card
    and on the CPU from the same weights and batch: loss, ce, aux and
    grad_norm within 1e-5 relative, every grad leaf within 1e-4 of its
    max |g|, the new params within 2 lr and within 1e-5 on 99.9 % of the
    entries. Returns the worst grad error relative to its leaf's max."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.convert import model_arrays, model_from_arrays
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.step import loss_fn, make_train_step
    worst = 0.0
    ocfg = adamw.AdamWConfig(lr=FAMILY_TRAIN_LR, warmup_steps=1,
                             total_steps=50)
    for arch in ARCH_IDS:
        cfg = reduce_for_smoke(get_config(arch))
        arrays = model_arrays(model.init(
            cfg, torch.Generator().manual_seed(2), device="cpu"))
        batch = _family_batch(cfg)
        out = []
        for d in (dev, torch.device("cpu")):
            params = model_from_arrays(cfg, arrays, device=d)
            params.requires_grad_(True)
            loss, _ = loss_fn(params, batch, cfg, device=d)
            named = dict(params.named_parameters())
            grads = dict(zip(named, torch.autograd.grad(
                loss, list(named.values()))))
            step = make_train_step(cfg, ocfg, device=d)
            _, _, m = step(params, adamw.init(params, ocfg), batch)
            out.append(({k: float(v) for k, v in m.items()},
                        {n: g.cpu() for n, g in grads.items()},
                        {n: p.detach().cpu() for n, p in named.items()}))
        (mc, gc_, pc), (mh, gh, ph) = out
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            _check(abs(mc[k] - mh[k]) <= 1e-5 * abs(mh[k]),
                   f"{arch}: train step {k} cuda {mc[k]} cpu {mh[k]}")
        for n, g in gh.items():
            err = float((gc_[n] - g).abs().max()) / max(
                float(g.abs().max()), 1e-30)
            worst = max(worst, err)
            _check(err <= 1e-4, f"{arch}: grad {n} cuda vs cpu {err:.3e}")
        close = total = 0
        for n, p in ph.items():
            d_ = (pc[n] - p).abs()
            _check(float(d_.max()) <= 2 * FAMILY_TRAIN_LR * (1 + 1e-3),
                   f"{arch}: new {n} cuda vs cpu {float(d_.max()):.3e}")
            close += int((d_ <= 1e-5).sum())
            total += d_.numel()
        _check(close >= 0.999 * total, f"{arch}: {close} of {total} new "
               "params within 1e-5")
        print(f"   {arch} (reduced, fp32): train step cuda == cpu: loss "
              f"{mc['loss']:.6f} / {mh['loss']:.6f}, aux {mc['aux']:.6f} / "
              f"{mh['aux']:.6f}, grad_norm {mc['grad_norm']:.6f} / "
              f"{mh['grad_norm']:.6f}; new params within 1e-5 at "
              f"{close / total:.5f}", flush=True)
    return worst


def _train_leaves(p, o) -> list:
    """(name, tensor) of every parameter and optimizer-state tensor."""
    out = list(p.named_parameters()) + [("step", o.step)]
    for side, vals in (("m", o.m), ("v", o.v)):
        for n, v in vals.items():
            for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                out.append((f"{side}.{n}.{i}", t))
    return out


def _restart_on_card(dev) -> None:
    """A TrainingRunner run with an injected failure equals the clean run
    bit for bit on the card, with deterministic algorithms on (the
    embedding backward's and the MoE's index accumulations take their
    deterministic kernels)."""
    import copy
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.dist import (FailureInjector, RunnerConfig,
                                  TrainingRunner)
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    torch.use_deterministic_algorithms(True)
    try:
        for arch in RESTART_ARCHS:
            cfg = reduce_for_smoke(get_config(arch))
            params = model.init(cfg, torch.Generator(device=dev).manual_seed(
                3), device=dev, trainable=True)
            ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=50)
            step = make_train_step(cfg, ocfg, device=dev)

            def data_fn(s, cfg=cfg):
                return _family_batch(cfg, rows=4, seed=100 + s)
            runs = {}
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
                for label, fail in (("clean", ()), ("faulty",
                                                    (RESTART_FAIL,))):
                    p = copy.deepcopy(params)
                    runner = TrainingRunner(
                        RunnerConfig(f"{d}/{label}",
                                     ckpt_interval=RESTART_INTERVAL),
                        step, data_fn, injector=FailureInjector(fail))
                    p, o, m = runner.run(p, adamw.init(p, ocfg), 0,
                                         RESTART_STEPS)
                    runs[label] = ({"p": p, "o": o}, runner.restarts,
                                   float(m["loss"]))
            (a, ra, la), (b, rb, lb) = runs["clean"], runs["faulty"]
            _check(ra == 0 and rb == 1, f"{arch}: restarts {ra}, {rb}")
            n = 0
            for (path, x), (_, y) in zip(_train_leaves(**a),
                                         _train_leaves(**b)):
                _check(torch.equal(x, y), f"{arch}: restart leaf {path}")
                n += 1
            print(f"   {arch} (reduced): {RESTART_STEPS} steps with a "
                  f"failure at step {RESTART_FAIL} and a restart from step "
                  f"{RESTART_FAIL // RESTART_INTERVAL * RESTART_INTERVAL}: "
                  f"all {n} leaves of params and optimizer state equal the "
                  f"clean run's bit for bit; final loss {lb!r} == {la!r} "
                  f"(deterministic algorithms on)", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)


def _dist_group(tmp: str) -> None:
    """A one-rank process group over a file store: NCCL for the card's
    tensors, gloo for the host's."""
    import torch.distributed as dist
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)


def _psum_on_card(dev, card) -> None:
    """Phase 17(a): int8 compressed_psum with error feedback over the
    one-rank group, on the card and on the host, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import compressed_psum, init_error
    from repro_torch.models import model
    import torch.distributed as dist
    cfg = get_config(TRAIN_ARCH)
    shapes = {n: p.shape for n, p in model._family_module(cfg).LM(
        cfg, "meta").named_parameters()}
    n_vals = sum(int(np.prod(s)) for s in shapes.values())
    _check(n_vals == TRAIN_PARAMS, f"{n_vals} gradient values")
    gen = torch.Generator().manual_seed(17)
    g_cpu = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    g_dev = {n: t.to(dev) for n, t in g_cpu.items()}
    g_max = max(float(t.abs().max()) for t in g_cpu.values())
    group = dist.group.WORLD
    e_cpu, e_dev = init_error(g_cpu), init_error(g_dev)
    ms = []
    for r in range(PSUM_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o_dev, e_dev = compressed_psum(g_dev, group, e_dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        o_cpu, e_cpu = compressed_psum(g_cpu, group, e_cpu)
        host_ms = (time.perf_counter() - t0) * 1e3
        for n in shapes:
            _check(torch.equal(o_dev[n].cpu(), o_cpu[n]) and
                   torch.equal(e_dev[n].cpu(), e_cpu[n]),
                   f"compressed_psum round {r} {n}: card != host")
        worst = max(float(t.abs().max()) for t in e_cpu.values())
        _check(worst <= g_max / 127 + 1e-6, f"residual {worst} > bound")
        print(f"   compressed_psum round {r}: {n_vals} fp32 values in "
              f"{len(shapes)} leaves, card {ms[-1]:.3f} ms (host clock "
              f"around a sync), host port {host_ms:.1f} ms; result and "
              f"residual bit for bit; max|err| {worst:.3e} <= max|g|/127 "
              f"{g_max / 127:.3e}", flush=True)
    print(f"   compressed_psum ms per round on the card {ms} ({card})",
          flush=True)


def _moe_on_mesh(dev) -> None:
    """Phase 17(b): Kimi-K2's MoE layer at full width, moe_sharded on a
    (1, 1) CUDA mesh against moe, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import moe as moe_mod
    cfg = get_config("kimi-k2-1t-a32b")
    p = moe_mod.MoE(cfg, dev)
    p.reset_parameters(torch.Generator(device=dev).manual_seed(12))
    B, S = DIST_MOE_TOKENS
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(13), device=dev).to(torch.bfloat16)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    with torch.no_grad():
        want, want_aux = moe_mod.moe(p, x, cfg)
        with set_mesh(mesh):
            got, aux = moe_mod.moe(p, x, cfg)
    torch.cuda.synchronize()
    _check(torch.equal(got.to_local(), want) and
           torch.equal(aux.to_local(), want_aux),
           "moe_sharded on a (1, 1) mesh != moe")
    n_w = sum(t.numel() for t in p.parameters())
    print(f"   moe_sharded, kimi-k2 MoE layer ({cfg.n_experts} experts, "
          f"d_model {cfg.d_model}, shared expert, {n_w / 1e9:.3f} B bf16 "
          f"params), {B}x{S} tokens on a (1, 1) cuda mesh: bit for bit "
          f"with moe (aux {float(want_aux):.6f})", flush=True)
    del p, x, got, want
    _free()


def _mamba2_on_mesh(dev) -> int:
    """Phase 17(b'): one Zamba2-7B Mamba-2 block at full width (fp32) on
    the (1, 1) CUDA mesh, the serving route: its scan runs in K3's
    Mamba-2 kernel (``mamba2_scan``) on each rank's heads (one launch, as
    without the mesh), the output within
    1e-5 of its max of the meshless block's (the gated norm sums its
    squares per rank there), the final state bit for bit. Returns K3's
    launches on the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import ssm
    from repro_torch.models.common import P, sanitize_spec, to_dtensor
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = dataclasses.replace(get_config("zamba2-7b"), param_dtype="float32")
    p = ssm.Mamba2(cfg, dev)
    p.reset_parameters(torch.Generator(device=dev).manual_seed(14))
    x = torch.randn((1, DIST_MAMBA2_TOKENS, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(15),
                    device=dev)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    # the block's parameters laid out by its specs, as the model path's
    specs = ssm.spec_mamba(cfg)
    dp = ssm.Mamba2(cfg, "meta")
    for name, t in p.named_parameters():
        dp._parameters[name] = torch.nn.Parameter(to_dtensor(
            t, mesh, sanitize_spec(specs[name], tuple(t.shape), mesh)),
            requires_grad=False)
    with torch.no_grad():
        want, want_st = ssm.mamba2_block(p, x, cfg)
        n0 = m2.launches
        with implicit_replication(), set_mesh(mesh):
            got, st = ssm.mamba2_block(
                dp, to_dtensor(x, mesh, P("data", None, None)), cfg)
        launches = m2.launches - n0
    torch.cuda.synchronize()
    got, h = got.to_local(), st["ssm"].to_local()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    _check(launches == 1, f"mamba2_block on a (1, 1) mesh launched K3 "
           f"{launches} times")
    _check(err <= 1e-5 * scale and torch.equal(h, want_st["ssm"]),
           f"mamba2_block on a (1, 1) mesh != meshless: {err} of {scale}")
    print(f"   mamba2_block, zamba2-7b (d_inner {cfg.d_inner}, "
          f"{cfg.d_inner // cfg.ssm_head_dim} heads, state "
          f"{cfg.ssm_state}, fp32), 1x{DIST_MAMBA2_TOKENS} tokens on a "
          f"(1, 1) cuda mesh: K3 launched {launches} time on the rank's "
          f"heads; output max|diff| {err:.3e} of max {scale:.3e} against "
          f"the meshless block, final state bit for bit", flush=True)
    del p, dp, x, got, want
    _free()
    return launches


def _restore_on_mesh(dev, tmp: str) -> None:
    """Phase 17(c): SmolLM-360M's bf16 params and int8 AdamW state saved,
    then restored onto a one-rank CUDA mesh by the spec trees."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), param_dtype="bfloat16")
    params = model._family_module(cfg).LM(cfg, "cpu")
    named = dict(params.named_parameters())
    gen = torch.Generator().manual_seed(21)

    def bf16(shape):     # random finite bf16 bit patterns, drawn fast
        return torch.randint(0, 2 ** 14, shape, dtype=torch.int16,
                             generator=gen).view(torch.bfloat16)

    def m_of(shape):
        if not adamw.quantizable(shape):
            return torch.rand(shape, generator=gen)
        return adamw.QuantState(
            q=torch.randint(-127, 128, shape, dtype=torch.int8,
                            generator=gen),
            scale=torch.rand(shape[:-1] + (shape[-1] // adamw.BLOCK,),
                             generator=gen))
    with torch.no_grad():
        for p in named.values():
            p.copy_(bf16(p.shape))
    state = adamw.AdamWState(
        step=torch.tensor(7, dtype=torch.int32),
        m={n: m_of(tuple(p.shape)) for n, p in named.items()},
        v={n: bf16(p.shape) if adamw.quantizable(p.shape) else
           torch.rand(p.shape, generator=gen) for n, p in named.items()})
    t0 = time.perf_counter()
    ckpt.save(tmp, 0, {"params": params, "opt": state})
    save_s = time.perf_counter() - t0
    p_specs = model.named_specs(model.param_specs(cfg), params)
    o_specs = adamw.state_specs(p_specs, {n: p.shape for n, p in
                                          named.items()},
                                adamw.AdamWConfig(state_dtype="int8"))
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    t0 = time.perf_counter()
    got, _ = ckpt.restore(tmp, {"params": params, "opt": state}, mesh=mesh,
                          specs={"params": p_specs, "opt": o_specs})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved = dict(ckpt._flatten({"params": params, "opt": state}))
    back = dict(ckpt._flatten(got))
    _check(set(saved) == set(back), "restored leaves")
    n_dt = n_bytes = 0
    for path, want in saved.items():
        leaf = back[path]
        if hasattr(leaf, "to_local"):
            n_dt += 1
            _check(leaf.device_mesh is mesh, f"{path} mesh")
            leaf = leaf.to_local()
        _check(leaf.device.type == dev.type and torch.equal(leaf.cpu(), want),
               f"restored shard of {path}")
        n_bytes += want.numel() * want.element_size()
    _check(n_dt == len(saved), f"{n_dt} leaves placed by their spec")
    print(f"   elastic restore: {len(saved)} leaves ({n_bytes / 1e9:.3f} GB: "
          f"bf16 params, int8 m with its scales, bf16 v, step) saved in "
          f"{save_s:.1f} s, restored onto a (1, 1) cuda mesh by the spec "
          f"trees in {restore_s:.1f} s; every shard bit for bit", flush=True)


def _start_dryrun(tmp: str) -> tuple:
    """Phase 17(d): the dry run on four production cells, each run in a
    process of its own (a process opens one process group), all started
    together, on the host's cores while the card runs phase 17's other
    parts. Returns (the processes, their start); :func:`_dryrun_cells`
    collects them."""
    procs = {}
    t0 = time.perf_counter()
    for arch, shape, multi_pod, devices in DRYRUN_CELLS:
        for d in devices:
            out = os.path.join(tmp, f"{arch}-{shape}-{d}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--device", d,
                   "--out", out] + (["--multi-pod"] if multi_pod else [])
            procs[arch, shape, d] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))))
    return procs, t0


def _dryrun_cells(procs: dict, t0: float) -> list:
    """Phase 17(d), collected: each cell's counts printed and checked
    (equal on ``--device cuda`` and ``cpu`` where both ran). Returns the
    ``--device cuda`` runs' result rows."""
    keys = ("flops", "bytes_accessed", "coll_bytes_raw",
            "coll_bytes_modeled", "coll_counts", "compute_s", "memory_s",
            "collective_s", "dominant")
    runs, rows = {}, []
    for (arch, shape, d), (out, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        wall = time.perf_counter() - t0
        _check(proc.returncode == 0 and "0 errors" in stdout,
               f"dry run {arch} {shape} --device {d}: {stdout[-1500:]} "
               f"{stderr[-3000:]}")
        (res,) = json.loads(pathlib.Path(out).read_text())
        _check(res["status"] == "ok", f"dry run {arch} {shape} status")
        if d == "cuda":
            rows.append(res)
        rl, mem = res["roofline"], res["memory_per_device"]
        by_kind = res["coll_by_kind"]
        runs[arch, shape, d] = ({k: rl[k] for k in keys}, mem, by_kind)
        print(f"   dry run {arch} {shape} on {res['mesh']} "
              f"({res['n_chips']} ranks), --device {d}: per device "
              f"flops {rl['flops']:.6e}, bytes "
              f"{rl['bytes_accessed']:.6e}, collectives "
              f"{rl['coll_counts']}, modeled bytes by kind {by_kind}, "
              f"memory {mem}, {rl['dominant']}-bound (compute "
              f"{rl['compute_s']:.4f} s, memory {rl['memory_s']:.4f} s, "
              f"collective {rl['collective_s']:.4f} s, v5e data model); "
              f"trace {res['compile_s']} s + analysis "
              f"{res['analysis_compile_s']} s; done {wall:.1f} s after "
              f"the start", flush=True)
    for arch, shape, _, devices in DRYRUN_CELLS:
        if len(devices) > 1:
            _check(runs[arch, shape, "cuda"] == runs[arch, shape, "cpu"],
                   f"dry run {arch} {shape}: --device cuda != cpu")
            print(f"   {arch} {shape}: identical counts with --device cuda "
                  f"and --device cpu", flush=True)
    return rows


def _phase17(dev, card) -> tuple:
    import tempfile
    import torch.distributed as dist
    t0 = time.perf_counter()
    print(f"== phase 17: distribution on the card over a one-rank NCCL "
          f"group; card {card}", flush=True)
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            _dist_group(tmp)
            try:
                # the two timed parts first, on an idle host
                _psum_on_card(dev, card)
                _restore_on_mesh(dev, os.path.join(tmp, "ckpt"))
                procs, t1 = _start_dryrun(tmp)
                _moe_on_mesh(dev)
                launches = _mamba2_on_mesh(dev)
            finally:
                dist.destroy_process_group()
            _free()
        except BaseException:
            for _, proc in procs.values():
                proc.kill()
            raise
        rows = _dryrun_cells(procs, t1)
    print(f"   phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, launches


def _phase18(gp, counters, dev, card, rows) -> dict:
    """Phase 18: the dry run -> scheduler path. The paper's quickstart,
    then ``schedule_jobs`` on phase 17's four dry-run cells (their
    per-device roofline as framework jobs of 20 steps) and on the
    reference's built-in profiles (no file), each on the card (K1 builds
    the tables) and on the CPU, record for record."""
    import tempfile
    from repro_torch.examples import quickstart, schedule_jobs as sj
    t0 = time.perf_counter()
    print(f"== phase 18: dry run -> scheduler (quickstart, schedule_jobs); "
          f"card {card}", flush=True)
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun.json")
        pathlib.Path(path).write_text(json.dumps(rows))
        jobs = sj.arch_apps(20, path)
        _check([a.name for a in jobs] == [f"{r['arch']}/{r['shape']}"
                                          for r in rows],
               "schedule_jobs read phase 17's cells")
        for a in jobs:
            print(f"   framework job {a.name}: {a.flops / 1e12:.6f} TFLOP, "
                  f"{a.hbm_bytes / 1e9:.6f} GB, {a.coll_bytes / 1e9:.6f} GB "
                  f"collective, AI {a.arithmetic_intensity:.6f} FLOP/B "
                  f"(20 steps, per device)", flush=True)
        absent = os.path.join(tmp, "absent.json")
        runs = {
            "quickstart": lambda d: quickstart.run(d, verbose=False),
            "schedule_jobs (dry run)": lambda d: sj.run(
                sj.arch_apps(20, path)[:16], 20, d, verbose=False)[0],
            "schedule_jobs (built-in)": lambda d: sj.run(
                sj.arch_apps(20, absent)[:16], 20, d, verbose=False)[0],
        }
        for name, fn in runs.items():
            got, walls = {}, {}
            for label, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
                _reset(counters)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got[label] = fn(d)
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t1
                if label == "cuda":
                    launches = gp.launches
                    by_rows = dict(sorted(gp.rows_launches.items()))
            _check(launches > 0, f"phase 18 {name}: K1 never launched")
            for policy, r in got["cuda"].items():
                c = got["cpu"][policy]
                _check([_fields(x) for x in r.records]
                       == [_fields(x) for x in c.records]
                       and (r.total_energy, r.misses, r.makespan)
                       == (c.total_energy, c.misses, c.makespan),
                       f"phase 18 {name} {policy}: cuda != cpu")
            report[name] = dict(launches=launches, by_rows=by_rows,
                                wall_s=walls["cuda"],
                                cpu_wall_s=walls["cpu"])
            print(f"   {name}: " + "; ".join(
                f"{p} energy {float(r.total_energy)!r} J, misses "
                f"{r.misses}, makespan {float(r.makespan)!r} s"
                for p, r in got["cuda"].items())
                + f"; cuda == cpu record for record; wall {walls['cuda']:.3f}"
                f" s on the card ({walls['cpu']:.3f} s on the CPU); K1 "
                f"launches {launches}, by batch rows {by_rows}", flush=True)
    print(f"   phase 18: {time.perf_counter() - t0:.1f} s", flush=True)
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCH_IDS
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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa, mamba_scan as ms
    from repro_torch.kernels import mamba2_scan as m2, ops, ref

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (gp, fa, ms, da, m2)
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
    for key, (r, live) in _new_goldens(core, apps, tb, gpred, feats,
                                       dev).items():
        _check(_digest(r.records) == golden[key]["digest"],
               f"golden digest {key}")
        _check(live, f"{key} scenario is live")
        matched += 1
    print(f"== phase 3: {matched}/20 golden digests reproduced on {dev} "
          f"(12 base, {len(LAYER_KEYS)} of the beyond-paper layers, "
          f"{len(NEW_KEYS)} of cold start, federation and model-derived "
          f"apps, each live); run_schedule == legacy_run_schedule; kernel "
          f"launches {gp.launches}", flush=True)
    _check(matched == 20 and gp.launches > 0, "golden phase launches")

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
    times = _kernel_times(fa, ops, ref, p5, card, dev)
    decode_times = _decode_attention_times(da, ops, ref, dev)
    mamba2_times = _mamba2_scan_times(m2, ops, ref, dev)
    mamba1_times = _mamba1_scan_times(ms, ops, p5, dev)
    attn_err, scan_err = p5["attn_err"], p5["scan_err"]
    del p5
    from repro_torch.configs import get_config
    served = {7: _serve("mistral-nemo-12b", {fa: 40}, counters, dev, 7,
                        attentions=40)}
    _bf16_attention_check(get_config("mistral-nemo-12b"), fa, ops, ref, dev)
    served[8] = _serve("falcon-mamba-7b", {ms: 64}, counters, dev, 8)
    layers = _layers(core, gp, ops, ref, counters, apps, tb, preds, feats,
                     dev, card)
    t0 = time.perf_counter()
    class_features, hetero_data = _hetero_fixture(core, apps)
    fed_pred = EnergyTimePredictor(PredictorConfig(), device=dev).fit(
        *hetero_data)
    fed_preds = {"cuda": fed_pred,
                 "cpu": predictor_from_arrays(predictor_arrays(fed_pred),
                                              device="cpu")}
    print(f"   phase 10's per-class profiling and predictor fit "
          f"{time.perf_counter() - t0:.2f} s (host)", flush=True)
    derived = _phase10(core, gp, counters, apps, tb, preds, feats,
                       fed_preds, class_features, dev, card)
    del preds, fed_preds, fed_pred, services, results
    _free()
    for phase, (arch, kernels, kw) in FAMILY_PHASES.items():
        per_prefill = {{"fa": fa, "ms": ms, "m2": m2}[k]: n
                       for k, n in kernels.items()}
        served[phase] = _serve(arch, per_prefill, counters, dev, phase, **kw)
    t0 = time.perf_counter()
    trained = _train_smollm(counters, fa, ms, dev, card)
    served[16] = trained["served"]
    _reset(counters)
    worst_grad = _train_families(dev)
    _restart_on_card(dev)
    _check(fa.launches == 0 and ms.launches == 0,
           f"the cuda == cpu steps and the restart launched {fa.launches} "
           f"attention and {ms.launches} scan kernels")
    print(f"   phase 16: all {len(ARCH_IDS)} reduced archs train alike on "
          f"cuda and cpu (worst grad error {worst_grad:.3e} of its leaf's "
          f"max); {time.perf_counter() - t0:.1f} s in all", flush=True)
    _free()
    _reset(counters)
    dryrun_rows, p17_scans = _phase17(dev, card)
    _check(fa.launches == 0 and gp.launches == 0 and ms.launches == 0 and
           m2.launches == 2 * p17_scans == 2,
           "phase 17 launched a kernel but the Mamba-2 blocks' K3")
    p18 = _phase18(gp, counters, dev, card, dryrun_rows)

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
        # phase 10: cold start, federation and model-derived apps
        "launches_phase10": {k: v["launches"] for k, v in derived.items()},
        "launches_phase10_by_rows": {k: v["by_rows"]
                                     for k, v in derived.items()},
        # phase 18: the dry run -> scheduler path
        "launches_phase18": {k: v["launches"] for k, v in p18.items()},
        "launches_phase18_by_rows": {k: v["by_rows"]
                                     for k, v in p18.items()},
    }]
    for name, line, err, main in (("flash_attention", 116, attn_err, 7),
                                  ("mamba_scan", 72, scan_err, 8)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": served[main][name],
            "max_abs_err": err, **times[name],
            # phase 16: the training steps launch no attention or scan
            "launches_train": trained["train_launches"][name],
            # greedy_generate's launches in each serving phase
            "launches_by_phase": {str(ph): got[name]
                                  for ph, got in served.items()
                                  if got[name]}})
    # the main path's attention kernel; the SIMT route's beside it
    rows[1]["source"] = "src/repro_torch/csrc/flash_attention_sm90.cu"
    rows[1]["simt_source"] = "src/repro_torch/csrc/flash_attention.cu"
    rows[1]["launches_by_route"] = \
        served[7]["by_route"]["flash_attention"]
    rows[1]["launches_by_route_by_phase"] = {
        str(ph): got["by_route"]["flash_attention"]
        for ph, got in served.items() if got["flash_attention"]}
    # the Mamba-1 scan at falcon-mamba-7b.prefill's calls
    rows[2]["cell_shapes"] = mamba1_times
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": None,   # the reference's decode attention is einsums
        "launches": served[7]["decode_attention"],
        "launches_by_phase": {str(ph): got["decode_attention"]
                              for ph, got in served.items()},
        "cell_shapes": decode_times})
    rows.append({
        "name": "mamba2_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba2_scan.cu",
        # K3's Mamba-2 route: the reference runs its plain recurrence
        "replaces": "src/repro/kernels/mamba_scan.py:72",
        "launches": served[13]["mamba2_scan"],
        "launches_by_phase": {str(ph): got["mamba2_scan"]
                              for ph, got in served.items()},
        # phase 17: the Mamba-2 block on the (1, 1) mesh
        "launches_phase17_mesh": p17_scans,
        "cell_shapes": mamba2_times})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
