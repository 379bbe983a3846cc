"""How ``correct`` is decided: the served tokens against the plain fp32
reference.

After the window a sample of the served requests is drawn from the
seed: for single-prompt requests the longest one and ``check_requests -
1`` more, for batches the batch that was served the most tokens and one
sequence from each of ``check_requests`` equal parts of it. A request
the window's close cut short is compared up to the last token it was
served: each token is an answer that came. For each sampled sequence the
reference runs once over its prompt and the tokens it was served, and at
every position whose logits the program returned (each prompt position
of the prefill's logits, then each decode step) it reads how far the
logit of the program's greedy token lies below the reference's best.
The number compared is the widest such gap (``max_logit_gap``).

The control (:func:`control_gap`) puts the reference, computed in the
next precision below the served bf16 (fp8 e4m3 products), in the
program's place: at the same positions the token fp8 puts first, read on
the fp32 reference. The limits and the readings they were set from are
in ``PERF.md``; each cell's limit is in its ``workloads/<cell>.json``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .weights import sub_seed


@dataclasses.dataclass
class Record:
    """One request as the window served it: when it was sent, when each
    of its tokens reached the host, the tokens (host), and the argmax of
    the prefill's logits at every position it returned (device)."""
    req: object
    issued: float
    arrivals: list = dataclasses.field(default_factory=list)
    served: list = dataclasses.field(default_factory=list)
    argmax: "torch.Tensor | None" = None


def choose(records: list, mix: dict, seed: int) -> list:
    """(record, row) pairs to compare, drawn from the seed among the
    requests that were served a token."""
    done = [r for r in records if r.arrivals]
    if not done:
        return []
    rng = np.random.default_rng(sub_seed(seed, 2))
    n = int(mix["check_requests"])
    if done[0].req.batch == 1:
        longest = max(r.req.prompt_len for r in done)
        top = [r for r in done if r.req.prompt_len == longest]
        first = top[int(rng.integers(len(top)))]
        rest = [r for r in done if r is not first]
        picks = rng.choice(len(rest), size=min(n - 1, len(rest)),
                           replace=False) if rest else []
        return [(first, 0)] + [(rest[int(i)], 0) for i in sorted(picks)]
    most = max(len(r.arrivals) for r in done)
    top = [r for r in done if len(r.arrivals) == most]
    rec = top[int(rng.integers(len(top)))]
    B = rec.req.batch
    edges = np.linspace(0, B, n + 1).astype(int)
    return [(rec, int(rng.integers(lo, hi)))
            for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def _sequence(rec, row, prompt):
    """(sequence fed to the reference, first position compared, the
    program's token at each compared position)."""
    served = torch.cat(rec.served, dim=1)[row]                 # (G,)
    am = rec.argmax[row].cpu()                                 # (S',)
    S = prompt.shape[0]
    seq = torch.cat([prompt.cpu(), served[:-1]]).to(prompt.device)
    return seq, S - am.shape[0], torch.cat([am, served[1:]])


def _gaps(ref, c, W, seq, first, tokens):
    """Widest gap of ``tokens`` (one a position from ``first``) below the
    fp32 reference's best, and how many of them are its argmax."""
    widest, agree = 0.0, 0
    for lo, logits in ref.logit_blocks(c, W, seq, "fp32", first):
        t = tokens[lo - first:lo - first + logits.shape[0]].to(
            logits.device)
        best, arg = logits.max(dim=-1)
        gap = best - logits.gather(-1, t[:, None].long())[:, 0]
        widest = max(widest, float(gap.max()))
        agree += int((arg == t).sum())
    return widest, agree


@torch.no_grad()
def program_gap(ref, c, W, samples, prompts) -> dict:
    """The program's widest gap over ``samples``, with ``prompts`` the
    sampled requests' prompts (index of record → (B, S) tensor)."""
    widest, agree, n = 0.0, 0, 0
    for rec, row in samples:
        seq, first, toks = _sequence(rec, row, prompts[rec.req.index][row])
        g, a = _gaps(ref, c, W, seq, first, toks)
        widest, agree, n = max(widest, g), agree + a, n + toks.shape[0]
    return {"max_logit_gap": widest, "positions": n, "agree": agree}


@torch.no_grad()
def control_gap(ref, c, W, samples, prompts) -> dict:
    """The control's widest gap at the same positions: the token the fp8
    reference puts first, on the fp32 reference."""
    widest, agree, n = 0.0, 0, 0
    for rec, row in samples:
        seq, first, _ = _sequence(rec, row, prompts[rec.req.index][row])
        toks = torch.cat([lg.argmax(dim=-1).cpu() for _, lg in
                          ref.logit_blocks(c, W, seq, "fp8", first)])
        g, a = _gaps(ref, c, W, seq, first, toks)
        widest, agree, n = max(widest, g), agree + a, n + toks.shape[0]
    return {"max_logit_gap": widest, "positions": n, "agree": agree}
