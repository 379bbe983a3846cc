"""Model dispatcher: one API over every architecture family.

  init(cfg, generator, device, trainable)              → params (nn.Module)
  forward(cfg, params, tokens, extra, device, impl)    → (logits, aux_loss)
  prefill(cfg, params, tokens, max_seq, extra, …)      → (logits, cache)
  decode_step(cfg, params, cache, tokens, pos, device) → (logits, cache)
  decode_graphable(cfg)                                → bool
  graph_policy(cfg)                                    → GraphPolicy
  count_decode_step(cfg, cache, pos)                   → None
  init_cache(cfg, batch, max_seq, dtype, device)       → cache
  extra_inputs(cfg, batch, seq, mode, generator, …)    → modality stubs
  text_len(cfg, seq)
  param_specs(cfg) / cache_specs(cfg)                  → spec trees
  named_specs(spec_tree, params)                       → {param name: spec}

The dense, moe and vlm families are :mod:`.transformer`, ssm (Mamba-1) is
:mod:`.ssm_lm`, hybrid (Mamba-2 with a shared attention block) is
:mod:`.hybrid` and audio (Whisper-style encoder-decoder) is
:mod:`.encdec`. ``extra`` carries the modality stubs: ``frames`` for
audio (forward and prefill), ``vision_embeds`` for vlm; a key a family
does not take raises. Every entry point takes ``device`` (default
``"cuda"``, which raises where CUDA is absent; pass ``device="cpu"``),
checks that the params live there and moves the tokens and the extra
inputs there. ``forward`` takes the kernels (``impl="flash"``, the default,
forward-only) or the differentiable plain route the train step runs
(``impl="xla"``); ``prefill`` and ``decode_step`` serve, with no autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import encdec, hybrid, ssm_lm, transformer
from .common import dtype_of

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": ssm_lm, "hybrid": hybrid, "audio": encdec}
#: the extra inputs each family's forward and prefill take
_EXTRA = {"vlm": ("vision_embeds",), "audio": ("frames",)}


def _family_module(cfg):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}") from None


def _on(params, tokens, device):
    dev = resolve_device(device)
    where = {p.device for p in params.parameters()}
    if where != {dev}:
        raise ValueError(f"params are on {sorted(map(str, where))}, not "
                         f"on the requested device {dev}")
    return torch.as_tensor(tokens, device=dev)


def _extra(cfg, extra, device) -> dict:
    """The family's keyword arguments from ``extra``, on ``device``."""
    extra = dict(extra or {})
    takes = _EXTRA.get(cfg.family, ())
    unknown = sorted(set(extra) - set(takes))
    if unknown:
        raise ValueError(f"{cfg.family} models take the extra inputs "
                         f"{list(takes)}, got {unknown}")
    dev = resolve_device(device)
    return {k: None if v is None else torch.as_tensor(v, device=dev)
            for k, v in extra.items()}


def init(cfg, generator: "torch.Generator | None" = None,
         device=DEFAULT_DEVICE, trainable: bool = False):
    """Random parameters for ``cfg`` on ``device``, drawn from
    ``generator`` (a ``torch.Generator`` on that device; default: one
    seeded with 0). They are frozen for serving unless ``trainable``."""
    mod = _family_module(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return mod.init_lm(cfg, generator, dev).requires_grad_(trainable)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=DEFAULT_DEVICE):
    return _family_module(cfg).init_cache(cfg, batch, max_seq, dtype,
                                          resolve_device(device))


def extra_inputs(cfg, batch: int, seq: int, mode: str = "train",
                 generator: "torch.Generator | None" = None,
                 device=DEFAULT_DEVICE) -> dict:
    """Stub tensors for the modality frontends, in the activation dtype:
    ``vision_embeds`` (batch, vision_tokens, D) for vlm, ``frames`` (batch,
    encoder_seq, D) for audio in the train and prefill modes. Standard
    normal draws from ``generator`` (on ``device``), or zeros without
    one. ``seq`` is unused, as in the reference."""
    del seq
    dev = resolve_device(device)
    dt = dtype_of(cfg.activation_dtype)

    def stub(shape):
        if generator is None:
            return torch.zeros(shape, dtype=dt, device=dev)
        return torch.randn(shape, generator=generator, device=dev).to(dt)
    out = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = stub((batch, cfg.vision_tokens, cfg.d_model))
    if cfg.family == "audio" and mode in ("train", "prefill"):
        out["frames"] = stub((batch, cfg.encoder_seq, cfg.d_model))
    return out


def param_specs(cfg):
    """The parameter spec tree: the reference's, each stacked subtree's
    leading layer entry dropped (the port keeps one module per layer)."""
    return _family_module(cfg).lm_param_specs(cfg)


def cache_specs(cfg):
    """The cache spec tree (the cache keeps the reference's stacked
    layout, so these are the reference's specs)."""
    return _family_module(cfg).cache_specs(cfg)


def named_specs(spec_tree, params) -> dict:
    """{parameter name: spec} for ``params`` (a module, or the names of
    its parameters): ``layers.3.attn.wq`` reads ``spec_tree["layers"]
    ["attn"]["wq"]``, the layer index skipped."""
    names = (dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else params)
    out = {}
    for name in names:
        node = spec_tree
        for part in name.split("."):
            if not part.isdigit():
                node = node[part]
        out[name] = node
    return out


def text_len(cfg, seq: int) -> int:
    """Text-token count so total decoder sequence == seq for VLM."""
    if cfg.family == "vlm":
        return seq - cfg.vision_tokens
    return seq


def forward(cfg, params, tokens, extra: Optional[dict] = None,
            device=DEFAULT_DEVICE, impl: str = "flash"):
    mod = _family_module(cfg)
    return mod.forward(params, _on(params, tokens, device), cfg,
                       **_extra(cfg, extra, device), impl=impl)


@torch.no_grad()
def prefill(cfg, params, tokens, max_seq: int, extra: Optional[dict] = None,
            cache_dtype=torch.bfloat16, device=DEFAULT_DEVICE,
            impl: str = "flash"):
    mod = _family_module(cfg)
    return mod.prefill(params, _on(params, tokens, device), cfg, max_seq,
                       cache_dtype=cache_dtype, impl=impl,
                       **_extra(cfg, extra, device))


def decode_graphable(cfg) -> bool:
    """Whether ``cfg``'s family declares its decode step capturable in a
    CUDA graph: it takes its position as a device tensor and makes no
    host sync (the family module's ``GRAPH_DECODE_FAMILIES``)."""
    return cfg.family in getattr(_family_module(cfg),
                                 "GRAPH_DECODE_FAMILIES", ())


@dataclasses.dataclass(frozen=True)
class GraphPolicy:
    """How :func:`repro_torch.train.serve.make_serve_step` holds a
    family's cache under its decode graph (the family module's
    ``RECURRENT_CACHE`` and ``GRAPH_RECAPTURES``). ``recurrent``: the
    cache entries a step rewrites beyond its own position (a recurrent
    state), kept across the eager steps run before a capture.
    ``recaptures``: the graph holds its cache weakly, and a call after
    the caller dropped that cache captures anew on the call's cache
    (else the graph keeps its cache alive and copies another one in)."""
    recurrent: tuple = ()
    recaptures: bool = False


def graph_policy(cfg) -> GraphPolicy:
    mod = _family_module(cfg)
    return GraphPolicy(tuple(getattr(mod, "RECURRENT_CACHE", ())),
                       bool(getattr(mod, "GRAPH_RECAPTURES", False)))


def count_decode_step(cfg, cache, pos: int) -> None:
    """Count on the host (:mod:`repro_torch.obs`) what one decode step
    at ``pos`` over ``cache`` reads, as its eager int-``pos`` step counts
    it (a replayed graph counts nothing itself)."""
    _family_module(cfg).count_decode_step(cfg, cache, pos)


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos, device=DEFAULT_DEVICE):
    """``pos``: an int, or for a family that :func:`decode_graphable`
    names a 0-d int64 tensor on ``device`` (other families take its
    value)."""
    mod = _family_module(cfg)
    tokens = _on(params, tokens, device)
    if isinstance(pos, torch.Tensor) and decode_graphable(cfg):
        if pos.dim() or pos.dtype != torch.int64 or \
                pos.device != tokens.device:
            raise ValueError(f"a tensor pos must be 0-d int64 on "
                             f"{tokens.device}, got {tuple(pos.shape)} "
                             f"{pos.dtype} on {pos.device}")
    else:
        pos = int(pos)
    return mod.decode_step(params, cache, tokens, pos, cfg)
