"""Frozen operation and byte counts, worked out from a configuration's
shapes alone, and the chip's peaks they are held to.

A count is what the inputs need: every weight and input byte read once,
every output byte written once, the products' multiply-adds as two
operations each, attention over the (query, key) pairs its mask keeps.
Nothing here reads the program: a kernel that does more work than its
inputs need reads below 100 % of its roofline, and one that reads above
it counts too little time or too much work.
"""
from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def peaks(device_kind: str) -> "dict | None":
    """The published peaks of the card named ``device_kind``, or None for
    a card the table lacks (every roofline share is then left out)."""
    return PEAKS.get(device_kind)


def least_seconds(flops: float, nbytes: float, peak: dict,
                  rate: str = "bf16_flops_per_s") -> float:
    """The least time the chip could take: the larger of the operations
    at ``rate`` and the bytes at the HBM rate."""
    return max(flops / peak[rate], nbytes / peak["hbm_bytes_per_s"])


def live_pairs(sq: int, sk: int, causal: bool = True, window=None) -> int:
    """(query, key) pairs a mask keeps, the ``sq`` queries right-aligned
    on the ``sk`` keys (row i sits at position ``i + sk - sq``)."""
    if not causal:
        return sq * sk
    if window is None:
        # rows at positions sk-sq .. sk-1 see position + 1 keys each
        first = sk - sq + 1
        return sq * first + sq * (sq - 1) // 2
    live = 0
    for i in range(sq):
        pos = i + sk - sq
        live += max(0, min(sk, pos + 1) - max(0, pos - window + 1))
    return live


def attention(B: int, sq: int, sk: int, hq: int, hkv: int, hd: int,
              itemsize: int, causal: bool = True, window=None
              ) -> tuple[int, int]:
    """One attention call's (operations, bytes): the two products over the
    live pairs (``4 hd`` operations a pair and query head), and q, k, v
    read and the output written once at the head dim as given."""
    ops = 4 * hd * B * hq * live_pairs(sq, sk, causal, window)
    nbytes = itemsize * (2 * B * sq * hq * hd + 2 * B * sk * hkv * hd)
    return ops, nbytes
