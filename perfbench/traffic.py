"""The one traffic generator: it reads a mix (``mixes/<traffic>.json``)
and makes its requests from the seed.

A mix is data: ``batch`` prompts a request (a rectangular batch: the
port's prefill takes no ragged one), ``prompt_lengths`` taken in this
fixed order, cycling (so the work does not depend on the seed),
``output_tokens`` generated greedily a sequence (1: the first token only,
as a prefill pool serves), and ``check_requests``, the sequences the
check compares after the window. The loop is closed: a request is sent
when the one before it has finished. The seed draws the token ids only.
"""
from __future__ import annotations

import dataclasses

import torch

from .weights import sub_seed


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    batch: int
    prompt_len: int
    output_tokens: int

    @property
    def max_seq(self) -> int:
        """Cache positions the request fills: the prompt, then each
        generated token but the last, which is never fed back."""
        return self.prompt_len + self.output_tokens


class Traffic:
    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        self.device = torch.device(device)
        self.lengths = [int(n) for n in mix["prompt_lengths"]]
        if not self.lengths or min(self.lengths) < 1:
            raise ValueError("a mix needs positive prompt lengths")
        if int(mix["output_tokens"]) < 1 or int(mix["batch"]) < 1:
            raise ValueError("a mix needs a batch and output tokens")

    def request(self, i: int) -> Request:
        return Request(i, int(self.mix["batch"]),
                       self.lengths[i % len(self.lengths)],
                       int(self.mix["output_tokens"]))

    def warm_up_requests(self) -> list:
        """One request of each distinct prompt length (index -1 - k: their
        prompts are drawn apart from the window's)."""
        seen = sorted(set(self.lengths))
        return [dataclasses.replace(self.request(self.lengths.index(n)),
                                    index=-1 - k)
                for k, n in enumerate(seen)]

    def prompt(self, req: Request) -> torch.Tensor:
        """The token ids (batch, prompt_len), int64, on the device."""
        g = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, 1, req.index + 2 ** 20))
        return torch.randint(0, self.vocab, (req.batch, req.prompt_len),
                             generator=g, device=self.device)
