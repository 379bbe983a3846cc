"""The dry run's mesh path held to the reference where the port once
answered differently, on the CPU.

Both packages run in subprocesses through
``scripts/dryrun_small_vs_reference.py`` (the reference compiles for host
devices, the port traces on a fake process group), each cell's costs
depth-extrapolated as the dry run reports them:

* Uneven splits: the reference's activation constraints keep a mesh
  axis that does not divide the dim (its partitioner pads the split). A
  reduced Whisper whose 15 encoder frames the 2-way ``model`` axis does
  not divide, and whisper-large-v3 decode_32k at full size (1500 frames
  on 16; the port projected every frame's cross K/V on every ``model``
  rank: 12.3x the reference's FLOPs), FLOPs less casts within x1.25.
* Zamba2's Mamba-2 block on the 4x2 mesh: modeled collective bytes
  within [0.65, 1.25] of the reference's (1.28 when its backward gathered
  the Di-split activations over ``model``; 3.29 at train_4k on 16x16),
  the same dominant term.
* Query heads that do not divide ``model`` (query-parallel attention): a
  reduced SmolLM with 3 heads on 1 KV head on 4x2, and smollm-360m
  train_4k at full size (1.95x the reference's collective bytes with
  key-parallel attention).
* Memory: ``fits_hbm`` and every memory field of falcon-mamba-7b
  prefill_32k at full size (the port's temp was 19.9 GB against 2.4: a
  convolution's zeros made at the global shape, and eager intermediates
  XLA's fusion never holds); the verdicts of stablelm-3b and
  whisper-large-v3 train_4k (each rematerialised layer's input once kept
  whole over ``model``) and of whisper-large-v3 and zamba2-7b
  prefill_32k; and stablelm-3b decode_32k, where the verdicts differ by
  the reference's artifact: XLA casts the whole stacked K/V cache to
  f32.
* ``split_spec``, the uneven activation spec, on stand-in meshes.
"""
from __future__ import annotations

import functools
import importlib.util
import os

import pytest

from repro_torch.models.common import P, split_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "_dryrun_small_vs_reference",
        os.path.join(ROOT, "scripts", "dryrun_small_vs_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _mesh_cells():
    mod = _script()
    return mod.compare(cells=mod.MESH_CELLS)


@functools.lru_cache(maxsize=1)
def _production():
    return _script().compare(production=[
        ("whisper-large-v3", "decode_32k"), ("smollm-360m", "train_4k")])


#: the cells whose ``fits_hbm`` the port once answered otherwise than the
#: reference, held at full size where the port's full-depth trace is cheap
FITS_CELLS = (("stablelm-3b", "train_4k"), ("whisper-large-v3", "train_4k"),
              ("whisper-large-v3", "prefill_32k"),
              ("zamba2-7b", "prefill_32k"))


@functools.lru_cache(maxsize=1)
def _memory():
    return _script().compare(memory=True, production=[
        ("falcon-mamba-7b", "prefill_32k"), ("stablelm-3b", "decode_32k"),
        *FITS_CELLS])


# ---------------------------------------------------------------------- #
#  F1: uneven splits (Whisper's frames and vocab)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_whisper_uneven_frames_flops_within_reference(mode):
    """15 frames on 2 ``model`` ranks: 8 and 7 rows of cross and encoder
    K/V a rank, as the reference's padded split (decode read 1.33x before:
    every frame projected on both ranks)."""
    c = _mesh_cells()[f"whisper-large-v3 enc15 {mode}"]
    assert 0.8 <= c["ratio"]["net"] <= 1.25
    assert c["port"]["dominant"] == c["reference"]["dominant"]


def test_whisper_decode_32k_flops_within_reference():
    c = _production()["whisper-large-v3 decode_32k"]
    assert 0.8 <= c["ratio"]["net"] <= 1.25
    # the cross K/V products alone were 2.517e12 a device
    assert c["port"]["flops"] < 2.5e11
    assert c["port"]["dominant"] == c["reference"]["dominant"]


# ---------------------------------------------------------------------- #
#  F2: Zamba2's Mamba-2 backward
# ---------------------------------------------------------------------- #
def test_zamba2_train_collectives_within_reference():
    c = _mesh_cells()["zamba2-7b train"]
    assert 0.65 <= c["ratio"]["coll"] <= 1.25
    assert c["port"]["dominant"] == c["reference"]["dominant"] == "memory"
    assert 0.8 <= c["ratio"]["net"] <= 1.25


def test_zamba2_block_gathers_no_activation_over_model():
    """What is gathered over ``model`` (2 ranks) at depth 4 is B and C
    (their grads reduce-scattered), the shared attention block's q and
    the FSDP weights' ``model`` shards: no Di-split activation."""
    c = _mesh_cells()["zamba2-7b train"]["port"]
    gathered = c["depths"]["4"]["by_kind"].get("all-gather", 0.0)
    ref = _mesh_cells()["zamba2-7b train"]["reference"]
    assert gathered <= 1.25 * ref["depths"]["4"]["by_kind"]["all-gather"]


# ---------------------------------------------------------------------- #
#  F4: query heads that do not divide ``model``
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_smollm_three_heads_within_reference(mode):
    c = _mesh_cells()[f"smollm-360m h3 {mode}"]
    assert 0.65 <= c["ratio"]["coll"] <= 1.25
    assert 0.8 <= c["ratio"]["net"] <= 1.25
    assert c["port"]["dominant"] == c["reference"]["dominant"]


def test_smollm_train_4k_query_parallel_within_reference():
    c = _production()["smollm-360m train_4k"]
    assert 0.65 <= c["ratio"]["coll"] <= 1.25
    assert 0.8 <= c["ratio"]["flops"] <= 1.25
    assert c["port"]["dominant"] == c["reference"]["dominant"]


# ---------------------------------------------------------------------- #
#  F3: the memory verdict
# ---------------------------------------------------------------------- #
def test_falcon_mamba_prefill_memory_as_reference():
    c = _memory()["falcon-mamba-7b prefill_32k"]
    r, p = c["reference"]["mem"], c["port"]["mem"]
    assert (p["total_bytes"] < 16e9) == (r["total_bytes"] < 16e9)
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert p[k] == pytest.approx(r[k], rel=1e-4, abs=0), k
    assert 0.67 <= p["temp_bytes"] / r["temp_bytes"] <= 1.5
    assert 0.67 <= p["total_bytes"] / r["total_bytes"] <= 1.5


@pytest.mark.parametrize("arch,shape", FITS_CELLS)
def test_fits_hbm_as_reference(arch, shape):
    """The verdict the port once had wrong: the two train_4k cells held
    each layer's rematerialised input whole over ``model`` (1/16 of it
    in the reference, 32 x 335.5 MB on stablelm-3b), Whisper's
    prefill_32k projected every frame on every rank, Zamba2's made its
    convolutions' zeros at the global shape. Arguments and aliases
    agree; the totals of the train cells within x1.5 (the port keeps no
    intermediate that XLA's fusion does not hold)."""
    c = _memory()[f"{arch} {shape}"]
    r, p = c["reference"]["mem"], c["port"]["mem"]
    assert (p["total_bytes"] < 16e9) == (r["total_bytes"] < 16e9)
    for k in ("argument_bytes", "alias_bytes"):
        assert p[k] == pytest.approx(r[k], rel=1e-4, abs=0), k
    if shape == "train_4k":
        assert 0.67 <= p["total_bytes"] / r["total_bytes"] <= 1.5


def test_decode_verdict_differs_by_the_whole_cache_casts():
    """stablelm-3b decode_32k: the reference holds its whole stacked K/V
    cache cast to f32 (two converts of 5.37e9 bytes, the cache of every
    layer), where a step reads one layer's slice; less those, its total
    fits, as the port's does. Arguments, outputs and aliases agree."""
    c = _memory()["stablelm-3b decode_32k"]
    r, p = c["reference"]["mem"], c["port"]["mem"]
    casts = c["reference"]["big_casts"]
    # each the f32 copy of the bf16 k (or v) of every layer: as many
    # bytes as k and v in bf16, the donated cache
    assert len(casts) == 2 and all(n == r["alias_bytes"] for n, _ in casts)
    assert r["total_bytes"] >= 16e9 > r["total_bytes"] - sum(
        n for n, _ in casts)
    assert p["total_bytes"] < 16e9
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert p[k] == pytest.approx(r[k], rel=1e-4, abs=0), k


# ---------------------------------------------------------------------- #
#  split_spec: the reference's maybe_shard, a split that pads
# ---------------------------------------------------------------------- #
MESH = {"data": 16, "model": 16}
POD = {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("spec,shape,mesh,want", [
    # Whisper's 1500 frames: 94 rows a rank, the last 90
    (P(("pod", "data"), "model", None), (128, 1500, 1280), MESH,
     P("data", "model", None)),
    # Whisper's vocab: 3242 columns a rank
    (P(("pod", "data"), None, "model"), (32, 1, 51866), MESH,
     P("data", None, "model")),
    # a batch of one stays whole (a padded split holds the same row)
    (P(("pod", "data"), None, None), (1, 8, 64), POD, P(None, None, None)),
    # 17 rows on 16 would leave 7 ranks empty (chunks of 2)
    (P(None, "model"), (1, 17), MESH, P(None, None)),
    # the divisible axes, then one that does not divide
    (P(("pod", "data"), None), (62, 3), POD, P(("pod", "data"), None)),
    (P(("pod", "data"), None), (34, 3), POD, P("pod", None)),
    # axes the mesh lacks are dropped
    (P("expert", "model"), (8, 32), MESH, P(None, "model")),
])
def test_split_spec_keeps_axes_that_do_not_divide(spec, shape, mesh, want):
    assert split_spec(spec, shape, mesh) == want
