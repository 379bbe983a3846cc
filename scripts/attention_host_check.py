#!/usr/bin/env python3
"""Check the fp32 attention case of
``tests/test_torch_cuda.py::test_flash_kernel_matches_plain_version[shape0-kw0-f32]``
against an fp64 truth, in a fresh process: the kernel, its plain version on
the card, and the plain version on the host CPU four times in a row.

    python3 scripts/attention_host_check.py [cuda|cpu]

Prints the CPU's capability and matmul precision settings, then each
result's max |error| against fp64 causal attention. The test once saw the
kernel and the card's plain version agree while the host-CPU plain version
was ~7e-5 away; run this several times, each in a new process, to see
which side errs.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels import ops, ref  # noqa: E402

#: the test's first case: (B, S, Hq, Hkv, hd), causal, fp32, seed 1
SHAPE = (1, 32, 4, 4, 16)


def _plain(q, k, v):
    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)


def _truth(q, k, v) -> torch.Tensor:
    """Causal attention in fp64 on the host."""
    qd, kd, vd = (t.cpu().double().transpose(1, 2) for t in (q, k, v))
    S, hd = qd.shape[-2], qd.shape[-1]
    scores = (qd @ kd.transpose(-1, -2)) / hd ** 0.5
    future = torch.ones(S, S, dtype=torch.bool).triu(1)
    scores = scores.masked_fill(future, float("-inf"))
    return (torch.softmax(scores, -1) @ vd).transpose(1, 2)


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mkl = getattr(torch.backends.mkldnn, "matmul", None)
    print(f"cpu capability {torch.backends.cpu.get_cpu_capability()}; "
          f"float32 matmul precision {torch.get_float32_matmul_precision()}"
          f"; threads {torch.get_num_threads()}; mkldnn fp32 precision "
          f"{getattr(mkl, 'fp32_precision', None)}")
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    B, S, Hq, Hkv, hd = SHAPE
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dev) for s in ((B, S, Hq, hd), (B, S, Hkv, hd),
                                  (B, S, Hkv, hd)))
    got = ops.flash_attention(q, k, v)
    card_plain = _plain(q, k, v)
    host = [ops.flash_attention(q.cpu(), k.cpu(), v.cpu()) for _ in range(4)]
    truth = _truth(q, k, v)

    def err(t):
        return float((t.cpu().double() - truth).abs().max())

    print(f"max |error| against fp64: kernel {err(got)!r}, plain on "
          f"{dev.type} {err(card_plain)!r}, plain on the host CPU x4 "
          f"{[err(h) for h in host]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
