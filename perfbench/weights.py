"""The benchmark's weights, made on the device from the seed.

One ``torch.Generator`` on the card, seeded from ``--seed``, draws every
weight in the served dtype, one call for each stacked tensor of the
reference's :func:`weight_shapes` (a dozen calls for a whole model), in
that order. The same seed gives the same weights, so the reference makes
them again after the program's run instead of reading the program's.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, prompts, the
    sample), so the streams never overlap."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, *tags])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def make(shapes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} for ``shapes`` ({name: (shape, init[, dtype])}):
    ``init`` a standard deviation (mean 0), a (mean, standard deviation)
    pair, or ``"norm"`` (``1 + N(0, 0.1^2)``); a third entry
    ``"float32"`` keeps that tensor in fp32 (a parameter the program
    holds in fp32 whatever it serves in)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    out = {}
    for name, (shape, init, *kind) in shapes.items():
        t = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32 if kind == ["float32"] else dtype)
        if init == "norm":
            init = (1.0, 0.1)
        mean, std = init if isinstance(init, tuple) else (0.0, init)
        t.mul_(float(std)).add_(float(mean))
        out[name] = t
    return out
