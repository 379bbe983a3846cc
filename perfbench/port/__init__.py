"""The system under test: the port's model, built around the benchmark's
weights, and its serving steps (``repro_torch.train.serve``).

The model is laid out on the ``meta`` device and each of its parameters
then set to the benchmark's tensor of the same name (a view into one
stacked tensor, so nothing is copied and memory holds one set of
weights). ``port/<family>.py`` gives the port's ``ModelConfig`` for a
configuration file and the port module holding that family's ``LM``.
"""
from __future__ import annotations

import importlib

import torch
from torch import nn


def _key(name: str) -> tuple[str, "int | None"]:
    """The benchmark's tensor for the port's parameter ``name`` and the
    layer in it: ``layers.3.attn.wq`` is layer 3 of ``layers.attn.wq``."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1].isdigit():
        return ".".join([parts[0], *parts[2:]]), int(parts[1])
    return name, None


def build(c: dict, W: dict, device):
    """(port config, port model) for configuration ``c`` holding ``W``."""
    family = importlib.import_module(f"perfbench.port.{c['family']}")
    cfg = family.config(c)
    lm = importlib.import_module(family.MODULE).LM(cfg, torch.device("meta"))
    used = set()
    for name, p in list(lm.named_parameters()):
        key, layer = _key(name)
        t = W[key] if layer is None else W[key][layer]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: the benchmark's {tuple(t.shape)} "
                             f"{t.dtype}, the port's {tuple(p.shape)} "
                             f"{p.dtype}")
        owner, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(owner), leaf,
                nn.Parameter(t, requires_grad=False))
        used.add(key)
    if set(W) - used:
        raise ValueError(f"weights the port's model has no place for: "
                         f"{sorted(set(W) - used)}")
    return cfg, lm


class System:
    """The port serving configuration ``c`` with the weights ``W``:
    :meth:`prefill` (``serve.make_prefill_step``, through the kernels) and
    :meth:`step` (``serve.make_serve_step``)."""

    def __init__(self, c: dict, W: dict, device):
        from repro_torch.train import serve
        self.device = torch.device(device)
        self.cfg, self.params = build(c, W, self.device)
        self._make_prefill = serve.make_prefill_step
        self._prefill = {}
        self._step = serve.make_serve_step(self.cfg, device=self.device)

    def prefill(self, tokens: torch.Tensor, max_seq: int):
        """(logits, cache) of the prompts ``tokens`` (B, S) in a cache of
        ``max_seq`` positions."""
        if max_seq not in self._prefill:
            self._prefill[max_seq] = self._make_prefill(
                self.cfg, max_seq, device=self.device)
        return self._prefill[max_seq](self.params, tokens)

    def step(self, cache, tokens: torch.Tensor, pos: int):
        """(logits, cache) of one decode step of ``tokens`` (B, 1) written
        at position ``pos``."""
        return self._step(self.params, cache, tokens, pos)
