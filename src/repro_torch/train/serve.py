"""Serving steps: prefill and batched decode, and the greedy loop over
them. Each runs on ``device`` (default ``"cuda"``, which raises where CUDA
is absent; pass ``device="cpu"``) with no autograd."""
from __future__ import annotations

import torch

from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import model as model_lib


def make_serve_step(cfg, device=DEFAULT_DEVICE):
    """decode_step(params, cache, tokens (B,1), pos) → (logits, cache):
    one new token against the cache, as one ``serve.decode_step`` span
    (:mod:`repro_torch.obs`) that ends when the step's work is
    dispatched."""
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        with obs.span("serve.decode_step"):
            return model_lib.decode_step(cfg, params, cache, tokens, pos,
                                         device=dev)

    return serve_step


def make_prefill_step(cfg, max_seq: int, device=DEFAULT_DEVICE,
                      impl: str = "flash"):
    """prefill(params, tokens, extra) → (logits, cache), through the
    kernels (``impl="flash"``) or the plain route (``"xla"``, what the dry
    run traces), as one ``serve.prefill`` span."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, tokens, extra=None):
        with obs.span("serve.prefill"):
            return model_lib.prefill(cfg, params, tokens, max_seq, extra,
                                     device=dev, impl=impl)

    return prefill_step


@torch.no_grad()
def greedy_generate(cfg, params, prompt, n_steps: int, max_seq: int,
                    extra=None, device=DEFAULT_DEVICE):
    """Prefill ``prompt`` (B, S) (a tensor or numpy array), then decode
    greedily: returns the ``n_steps`` generated tokens (B, n_steps) int32,
    the first from the prefill logits and one per decode step after it."""
    logits, cache = model_lib.prefill(cfg, params, prompt, max_seq, extra,
                                      device=device)
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    out = [tok]
    pos0 = int(prompt.shape[1]) + (
        cfg.vision_tokens if cfg.family == "vlm" else 0)
    for i in range(n_steps - 1):
        logits, cache = model_lib.decode_step(cfg, params, cache, tok,
                                              pos0 + i, device=device)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
