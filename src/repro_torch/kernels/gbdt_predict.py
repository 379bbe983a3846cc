"""Bind and launch the CUDA GBDT inference kernel.

The kernel (``csrc/gbdt_predict.cu``) is the Hopper counterpart of the
Pallas TPU kernel ``repro/kernels/gbdt_predict.py::gbdt_predict``. It is
built with the port's other kernels into one library on first use
(:mod:`repro_torch.kernels.build`); nothing here runs at import time.

A row's trees are summed on a group of lanes, one lane per chain of
numpy's pairwise order (:func:`repro_torch.kernels.ref.lane_schedule`,
cached per T on each device). :func:`group_width` picks the group from
the chain count, the batch and the card's SM count; any width gives the
same bits.

:data:`launches` counts kernel launches: :func:`launch` adds one each time
the kernel is launched, and nothing else touches it except a caller
resetting it to 0. :data:`rows_launches` splits the same count by the
batch's row count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import library
from .ref import lane_schedule

__all__ = ["MAX_DEPTH", "build", "fill_lanes", "group_width", "launch",
           "schedule"]

MAX_DEPTH = 8
#: The widest lane group a row gets; more chains than this take turns.
MAX_GROUP = 64
#: Lanes (rows x group) per SM past which groups narrow toward 8: the card
#: is full, and narrower groups share each tree's loads between more rows
#: of a warp.
FILL_LANES_PER_SM = 512
#: Rows from which one lane walks a whole row: all 32 rows of a warp then
#: read the same tree (on the H100 faster than 8 lanes at 65536 rows,
#: slower at 16384; PERF.md).
ONE_LANE_ROWS = 32768

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0
#: The same launches by batch rows: ``{n: launches}``.
rows_launches: dict[int, int] = {}

#: (T, device) -> (schedule int32 on the device, n_blocks, n_pairs, chains)
_schedules: dict = {}


@functools.cache
def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind this kernel's C entry
    points."""
    lib = library()
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.gbdt_predict_f64.argtypes = [
        ptr, ptr, ptr, ptr, ptr, cint, cint, ctypes.c_double, ptr, cint,
        cint, cint, cint, cint, ptr]
    lib.gbdt_predict_f64.restype = cint
    lib.gbdt_launch_floor.argtypes = [ptr]
    lib.gbdt_launch_floor.restype = cint
    lib.gbdt_predict_error_string.argtypes = [cint]
    lib.gbdt_predict_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def fill_lanes(device: torch.device) -> int:
    """Lanes that fill ``device``: :data:`FILL_LANES_PER_SM` per SM."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * FILL_LANES_PER_SM


def group_width(n: int, chains: int, fill: int) -> int:
    """Lanes per row: one for a single chain or from
    :data:`ONE_LANE_ROWS` rows on, else the smallest power of two >= the
    chain count, at most :data:`MAX_GROUP`, halved toward 8 while ``n``
    rows would take more than ``fill`` lanes (:func:`fill_lanes`)."""
    if chains <= 1 or n >= ONE_LANE_ROWS:
        return 1
    g = min(1 << (chains - 1).bit_length(), MAX_GROUP)
    while g > 8 and n * g > fill:
        g //= 2
    return g


def schedule(T: int, device: torch.device) -> tuple:
    """T's lane schedule flattened for the kernel (block (first, length)
    pairs, then the combine program's slot pairs), cached on ``device``."""
    key = (T, device)
    if key not in _schedules:
        s = lane_schedule(T)
        flat = [v for pair in s.blocks + s.pairs for v in pair] or [0]
        _schedules[key] = (torch.tensor(flat, dtype=torch.int32,
                                        device=device),
                           len(s.blocks), len(s.pairs), s.chains)
    return _schedules[key]


def launch(X: torch.Tensor, feats: torch.Tensor, thresholds: torch.Tensor,
           leaves: torch.Tensor, base: float, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream; the caller has validated
    every argument (:func:`repro_torch.kernels.ops.gbdt_predict`). Raises if
    the runtime refuses the launch."""
    global launches
    lib = build()
    n, F = X.shape
    T, depth = thresholds.shape
    sched, n_blocks, n_pairs, chains = schedule(T, X.device)
    group = group_width(n, chains, fill_lanes(X.device))
    # the library's runtime launches into whichever card is current
    with torch.cuda.device(X.device):
        err = lib.gbdt_predict_f64(
            X.data_ptr(), feats.data_ptr(), thresholds.data_ptr(),
            leaves.data_ptr(), sched.data_ptr(), n_blocks, n_pairs,
            float(base), out.data_ptr(), n, F, T, depth, group,
            torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        msg = lib.gbdt_predict_error_string(err).decode()
        raise RuntimeError(f"gbdt_predict kernel launch failed (n={n}, "
                           f"T={T}, depth={depth}, F={F}, group={group}): "
                           f"{msg}")
    launches += 1
    rows_launches[n] = rows_launches.get(n, 0) + 1
