"""Serving steps: prefill and batched decode, and the greedy loop over
them. Each runs on ``device`` (default ``"cuda"``, which raises where CUDA
is absent; pass ``device="cpu"``) with no autograd."""
from __future__ import annotations

import weakref

import torch

from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import model as model_lib
from ..models.common import current_mesh

#: eager steps run on the capture stream before a decode step is captured
#: (cuBLAS handles and workspaces, the allocator's blocks)
GRAPH_WARM_UP = 3


def make_serve_step(cfg, device=DEFAULT_DEVICE):
    """decode_step(params, cache, tokens (B,1), pos) → (logits, cache):
    one new token against the cache, as one ``serve.decode_step`` span
    (:mod:`repro_torch.obs`) that ends when the step's work is
    dispatched.

    On a CUDA device, with no mesh, plain cache tensors, no stream capture
    under way, and a family whose decode step can be captured
    (``model.decode_graphable``), the step is a CUDA graph: captured on
    the first call for each token shape and cache layout (after
    ``GRAPH_WARM_UP`` eager steps, which rewrite the same cache slot with
    the same values), then replayed. The graph binds ``params``, the cache
    tensors it was captured on (kept alive), a (B, 1) int64 token buffer
    and a 0-d int64 position buffer, which each call fills before the
    replay. A call with another cache copies it into the bound one, device
    to device, and leaves it unwritten; the returned cache is always the
    bound one, so pass back what the step returned. Another ``params``
    captures anew. The logits are a fresh tensor each call. Inner spans
    run at capture only; what the eager step counts
    (``model.count_decode_step``) is counted here for each call, and each
    call counts one of ``serve.graph_captures``,
    ``serve.graph_cache_copies`` (it then replays) or
    ``serve.graph_replays``. Everywhere else the step is eager; a capture
    that fails raises.

    The family's ``model.graph_policy`` adapts this to a recurrent cache
    (the hybrid's conv and SSM state): its recurrent entries are kept
    across the warm-up steps (which would advance them), and the graph
    holds its cache weakly: a call made after the caller dropped the
    bound cache captures anew on the call's cache, so that a new
    request's cache is never held beside the last one's."""
    dev = resolve_device(device)
    graphable = dev.type == "cuda" and model_lib.decode_graphable(cfg)
    policy = model_lib.graph_policy(cfg)
    graphs: dict = {}

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        with obs.span("serve.decode_step"):
            if not (graphable and _plain_cache(cache)):
                return model_lib.decode_step(cfg, params, cache, tokens, pos,
                                             device=dev)
            key = (tuple(tokens.shape), _layout(cache))
            g = graphs.pop(key, None)
            if g is None or g.params is not params or g.cache is None:
                del g                 # its memory pool before the next one
                g = _DecodeGraph(cfg, params, cache, tokens, pos, dev,
                                 policy)
                obs.count("serve.graph_captures", 1)
            elif g.bound(cache):
                obs.count("serve.graph_replays", 1)
            else:
                g.copy_in(cache)
                obs.count("serve.graph_cache_copies", 1)
            graphs[key] = g
            bound = g.cache
            if obs.on:
                model_lib.count_decode_step(cfg, bound, int(pos))
            return g(tokens, pos), bound

    return serve_step


def _leaves(cache) -> list:
    """The cache's tensors, in a fixed order: ``{stack: {"k": …, "v": …}}``
    (the transformer's) or ``{name: tensor}`` (the hybrid's)."""
    return [t for n in sorted(cache) for t in (
        [cache[n][s] for s in sorted(cache[n])]
        if isinstance(cache[n], dict) else [cache[n]])]


def _map_cache(cache, fn):
    """``cache`` with ``fn`` applied to each tensor, its layout kept."""
    return {n: fn(v) if not isinstance(v, dict) else _map_cache(v, fn)
            for n, v in cache.items()}


def _layout(cache) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(cache))


def _plain_cache(cache) -> bool:
    """No mesh, no capture under way (the caller's own graph takes the
    eager step), and the cache's tensors plain ones (not DTensors)."""
    return (current_mesh() is None
            and not torch.cuda.is_current_stream_capturing()
            and all(type(t) is torch.Tensor for t in _leaves(cache)))


class _DecodeGraph:
    """One captured decode step: the graph, what it binds (``params``,
    ``cache``, the token and position buffers) and its logits. Under a
    ``policy`` that recaptures, the cache is held weakly: ``cache`` is
    None once the caller has dropped it."""

    def __init__(self, cfg, params, cache, tokens, pos, dev, policy):
        self.params = params
        self._cache = None if policy.recaptures else cache
        self._weak = (_map_cache(cache, weakref.ref) if policy.recaptures
                      else None)
        self.tokens = torch.empty(tuple(tokens.shape), dtype=torch.int64,
                                  device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self._load(tokens, pos)
        # the warm-up steps advance a recurrent state: kept, put back
        kept = {n: cache[n].clone() for n in policy.recurrent}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(GRAPH_WARM_UP):
                model_lib.decode_step(cfg, params, cache, self.tokens,
                                      self.pos, device=dev)
        torch.cuda.current_stream(dev).wait_stream(stream)
        for n, t in kept.items():
            cache[n].copy_(t)
        del kept
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.logits, _ = model_lib.decode_step(
                cfg, params, cache, self.tokens, self.pos, device=dev)

    def _load(self, tokens, pos) -> None:
        self.tokens.copy_(torch.as_tensor(tokens))
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(pos)

    @property
    def cache(self):
        """The bound cache, or None once a weakly held one was dropped."""
        if self._weak is None:
            return self._cache
        cache = _map_cache(self._weak, lambda ref: ref())
        return None if any(t is None for t in _leaves(cache)) else cache

    def bound(self, cache) -> bool:
        """Whether ``cache``'s tensors are the bound ones."""
        return all(a.data_ptr() == b.data_ptr() and a.shape == b.shape
                   and a.dtype == b.dtype and a.stride() == b.stride()
                   for a, b in zip(_leaves(cache), _leaves(self.cache)))

    def copy_in(self, cache) -> None:
        for dst, src in zip(_leaves(self.cache), _leaves(cache)):
            dst.copy_(src)

    def __call__(self, tokens, pos):
        self._load(tokens, pos)
        self.graph.replay()
        return self.logits.clone()


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
