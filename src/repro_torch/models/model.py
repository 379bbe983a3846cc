"""Model dispatcher: one API over the families the port serves.

  init(cfg, generator, device)                         → params (nn.Module)
  forward(cfg, params, tokens, extra, device)          → (logits, aux_loss)
  prefill(cfg, params, tokens, max_seq, extra, …)      → (logits, cache)
  decode_step(cfg, params, cache, tokens, pos, device) → (logits, cache)
  init_cache(cfg, batch, max_seq, dtype, device)       → cache
  text_len(cfg, seq)

The ``dense`` and ``ssm`` (Mamba-1) families are ported. The others (moe,
hybrid, vlm, audio) raise ``NotImplementedError`` naming the ROADMAP item
that ports them. Every entry point takes ``device`` (default ``"cuda"``,
which raises where CUDA is absent; pass ``device="cpu"``), checks that the
params live there and moves the tokens there.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import ssm_lm, transformer

def _family_module(cfg):
    if cfg.family == "dense":
        return transformer
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family in ("moe", "hybrid", "vlm", "audio"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet (ROADMAP "
            "§1 item 12b); the port serves the dense and ssm families")
    raise ValueError(f"unknown family {cfg.family!r}")


def _on(params, tokens, device):
    dev = resolve_device(device)
    where = {p.device for p in params.parameters()}
    if where != {dev}:
        raise ValueError(f"params are on {sorted(map(str, where))}, not "
                         f"on the requested device {dev}")
    return torch.as_tensor(tokens, device=dev)


def init(cfg, generator: "torch.Generator | None" = None,
         device=DEFAULT_DEVICE):
    """Random parameters for ``cfg`` on ``device``, drawn from
    ``generator`` (a ``torch.Generator`` on that device; default: one
    seeded with 0)."""
    mod = _family_module(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return mod.init_lm(cfg, generator, dev)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=DEFAULT_DEVICE):
    return _family_module(cfg).init_cache(cfg, batch, max_seq, dtype,
                                          resolve_device(device))


def text_len(cfg, seq: int) -> int:
    """Text-token count so total decoder sequence == seq for VLM."""
    if cfg.family == "vlm":
        return seq - cfg.vision_tokens
    return seq


def _no_extra(cfg, extra):
    if extra:
        raise ValueError(f"{cfg.family} models take no extra inputs, got "
                         f"{sorted(extra)}")


def forward(cfg, params, tokens, extra: Optional[dict] = None,
            device=DEFAULT_DEVICE):
    mod = _family_module(cfg)
    _no_extra(cfg, extra)
    return mod.forward(params, _on(params, tokens, device), cfg)


def prefill(cfg, params, tokens, max_seq: int, extra: Optional[dict] = None,
            cache_dtype=torch.bfloat16, device=DEFAULT_DEVICE):
    mod = _family_module(cfg)
    _no_extra(cfg, extra)
    return mod.prefill(params, _on(params, tokens, device), cfg, max_seq,
                       cache_dtype=cache_dtype)


def decode_step(cfg, params, cache, tokens, pos: int,
                device=DEFAULT_DEVICE):
    mod = _family_module(cfg)
    return mod.decode_step(params, cache, _on(params, tokens, device),
                           int(pos), cfg)
