"""Tiny cells for the CPU tests: a copy of the benchmark's files with a
dense configuration cut to a test's size, two small mixes and their
cells added as files, and the ``BENCHMARK.json`` entries that name them.
Nothing here runs in a benchmark run."""
from __future__ import annotations

import copy
import json
import pathlib
import shutil

HERE = pathlib.Path(__file__).resolve().parent

TINY = {"name": "tiny-dense", "source": "test", "family": "dense",
        "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 128, "vocab_size": 256, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "hidden_act": "silu",
        "tie_word_embeddings": False, "sliding_window": None,
        "torch_dtype": "bfloat16"}
MIXES = {"tiny-prefill": {"batch": 1, "prompt_lengths": [8, 16, 32],
                          "output_tokens": 1, "check_requests": 2},
         "tiny-decode": {"batch": 4, "prompt_lengths": [16],
                         "output_tokens": 8, "check_requests": 2}}
#: tiny cells' limit: the bf16 port reads at most ~0.02 here, the fp8
#: control ~0.3
LIMIT = 0.1
CELLS = {"tiny.prefill": "tiny-prefill", "tiny.decode": "tiny-decode"}


def _write(path: pathlib.Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_home(tmp: pathlib.Path) -> tuple[pathlib.Path, dict]:
    """(a copy of the benchmark's files with the tiny cells added, the
    spec naming them)."""
    home = tmp / "perfbench"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns(
        "__pycache__"))
    _write(home / "configs" / "tiny-dense.json", TINY)
    for name, mix in MIXES.items():
        _write(home / "mixes" / f"{name}.json", mix)
    for cell in CELLS:
        _write(home / "workloads" / f"{cell}.json",
               {"limits": {"max_logit_gap": LIMIT}})
    spec = copy.deepcopy(json.loads((HERE.parent / "BENCHMARK.json")
                                    .read_text()))
    spec["workloads"] += [{"name": cell, "config": "tiny-dense",
                           "traffic": mix, "chips": 1, "why": "a test"}
                          for cell, mix in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                w.replace("mistral-nemo-12b", "tiny")
                for w in m["workloads"]]
    return home, spec
