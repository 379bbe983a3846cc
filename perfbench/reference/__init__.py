"""Plain PyTorch references, one module per family, computed in fp32
with TF32 off. They import nothing of the program: each is written from
the architecture as published and takes the benchmark's own weights (the
tensors :mod:`perfbench.weights` makes from the seed)."""
from __future__ import annotations

import torch

#: e4m3's largest finite value
FP8_MAX = 448.0


def exact_fp32() -> None:
    """fp32 products stay fp32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one absmax scale per slice along
    ``dim`` (the reduced dim), back in fp32: the values an fp8 product
    multiplies, as fp8 tensor cores take them, accumulating in fp32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` for a projection ``w`` stored (in, out): exact fp32, or
    with ``precision="fp8"`` (the control) x per row and w per output
    column rounded to fp8 first."""
    w = w.float()
    if precision == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    if precision != "fp32":
        raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
    return x @ w
