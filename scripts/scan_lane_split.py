#!/usr/bin/env python3
"""Time the Mamba-1 scan kernel at several lane splits on one NVIDIA card.

The scan kernel (``src/repro_torch/csrc/mamba_scan.cu``) splits a
channel's N states over LPC lanes, N / LPC states each. This script builds
copies of that source with the N = 16 instance set to other splits (and
other chunk lengths), checks each against the plain version
(``repro_torch.kernels.ref.mamba_scan_ref``, fp32 tolerance 2e-5), and
times them in turns at the Falcon-Mamba-7B serving shape (B=4, L=2048,
Di=8192, N=16) and at B=1, with CUDA events. The builds go to
``build/scan_lane_split/`` (git-ignored). Needs one card and ``nvcc``::

    python3 scripts/scan_lane_split.py
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "mamba_scan.cu"
OUT = ROOT / "build" / "scan_lane_split"
SHIPPED = "launch<16, 2>"
CHUNK = "constexpr int kChunk = 32;"
#: name -> (lanes per channel at N = 16, chunk length)
VARIANTS = {"2x8_c32": (2, 32), "4x4_c32": (4, 32), "1x16_c32": (1, 32),
            "2x8_c64": (2, 64), "4x4_c16": (4, 16)}
TOL = 2e-5


def _build(nvcc: str) -> dict:
    text = SOURCE.read_text()
    if text.count(SHIPPED) != 1 or text.count(CHUNK) != 1:
        raise RuntimeError("mamba_scan.cu no longer has the N = 16 launch "
                           "or the chunk constant this script edits")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (lpc, chunk) in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(text.replace(SHIPPED, f"launch<16, {lpc}>").replace(
            CHUNK, f"constexpr int kChunk = {chunk};"))
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
             str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.mamba_scan_fwd.argtypes = ([ctypes.c_void_p] * 8
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        lib.mamba_scan_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _inputs(seed, B, L, Di, N, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa
    return [rnd(B, L, Di), F.softplus(rnd(B, L, Di)) * 0.1,
            -torch.exp(rnd(Di, N) * 0.3), rnd(B, L, N), rnd(B, L, N),
            torch.linspace(0.5, 1.5, Di, device=dev)]


def _call(lib, args):
    B, L, Di = args[0].shape
    N = args[2].shape[1]
    y = torch.empty_like(args[0])
    h = torch.empty(B, Di, N, device=args[0].device)
    err = lib.mamba_scan_fwd(*(t.data_ptr() for t in args), y.data_ptr(),
                             h.data_ptr(), B, L, Di, N,
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan launch failed: {err}")
    return y, h


def _time(fn, reps: int = 20) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_lane_split: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card {card}")
    libs = _build(str(pathlib.Path(CUDA_HOME or "/usr/local/cuda")
                      / "bin" / "nvcc"))
    dev = torch.device("cuda")
    for shape in ((3, 100, 130, 16), (2, 77, 70, 16), (4, 2048, 8192, 16)):
        args = _inputs(3, *shape, dev)
        want_y, want_h = ref.mamba_scan_ref(*args)
        for name, lib in libs.items():
            y, h = _call(lib, args)
            torch.cuda.synchronize()
            ok = all(bool(((g - w).abs() <= TOL + TOL * w.abs()).all())
                     for g, w in ((y, want_y), (h, want_h)))
            print(f"   {shape} {name}: y {float((y - want_y).abs().max()):.3e}"
                  f" h_last {float((h - want_h).abs().max()):.3e} "
                  f"{'ok' if ok else 'BEYOND TOLERANCE'}")
            if not ok:
                return 1
    for B in (4, 1):
        args = _inputs(4, B, 2048, 8192, 16, dev)
        order = list(libs) + list(libs)[::-1]          # in turns, there and
        times = {name: [] for name in libs}            # back
        for name in order:
            times[name].append(_time(lambda: _call(libs[name], args)))
        print(f"ms per call at B={B}, L=2048, Di=8192, N=16 (two turns): "
              + "; ".join(f"{name} " + " ".join(f"{t:.6f}" for t in ts)
                          for name, ts in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
