"""The frozen counts on hand-worked cases."""
from __future__ import annotations

import json
import pathlib

import pytest

from perfbench import counts
from perfbench.counts import dense

HERE = pathlib.Path(__file__).resolve().parent
NEMO = json.loads((HERE / "configs" / "mistral-nemo-12b.json").read_text())


def _pairs_by_loop(sq, sk, causal, window):
    live = 0
    for i in range(sq):
        pos = i + sk - sq
        hi = min(sk, pos + 1) if causal else sk
        lo = max(0, pos - window + 1) if window else 0
        live += max(0, hi - lo)
    return live


@pytest.mark.parametrize("sq,sk,causal,window", [
    (1, 1, True, None), (4, 4, True, None), (1, 768, True, None),
    (7, 19, True, None), (8192, 8192, True, None), (5, 9, False, None),
    (16, 16, True, 4), (3, 40, True, 8)])
def test_live_pairs_as_a_loop_counts_them(sq, sk, causal, window):
    assert counts.live_pairs(sq, sk, causal, window) == \
        _pairs_by_loop(sq, sk, causal, window)


def test_attention_counts_head_dim_112_as_given():
    # one causal call of 4 x 8: 36 pairs a head; two products of 2 hd
    # operations a pair; q, k, v, out read or written once
    ops, nbytes = counts.attention(1, 8, 8, 32, 32, 112, 2)
    assert ops == 4 * 112 * 32 * 36
    assert nbytes == 2 * (2 * 8 * 32 * 112 + 2 * 8 * 32 * 112)
    assert ops != counts.attention(1, 8, 8, 32, 32, 128, 2)[0]


TOY = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
       "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
       "vocab_size": 32}


def test_dense_prefill_by_hand():
    # a layer's products: q 8x8, k and v 8x4 each, o 8x8, the MLP 3x8x16
    mm = 64 + 32 + 32 + 64 + 384
    assert dense.layer_matmul_params(TOY) == mm
    ops, nbytes = dense.prefill(TOY, 1, 3)
    # 3 tokens through 2 layers; 6 live pairs, 4 x 4 x 2 heads a pair;
    # the last position's logits 2 x 8 x 32
    assert ops == 2 * 3 * 2 * mm + 2 * (4 * 4 * 2 * 6) + 2 * 8 * 32
    weights = 2 * (2 * (mm + 16) + 8 + 8 * 32)
    kv = 3 * 2 * 2 * 2 * 1 * 4          # positions x bf16 x layers x k,v
    assert nbytes == weights + 2 * 3 * 8 + 4 * 3 + kv + 4 * 32


def test_dense_decode_step_by_hand():
    mm = dense.layer_matmul_params(TOY)
    ops, nbytes = dense.decode_step(TOY, 2, 5)   # writes position 5
    assert ops == 2 * 2 * (2 * mm + 8 * 32) + 2 * (4 * 4 * 2 * 2 * 6)
    per_pos = 2 * 2 * 2 * 1 * 4
    assert nbytes == (dense.weight_bytes(TOY) + 2 * 2 * 8 + 4 * 2
                      + 2 * 5 * per_pos + 2 * per_pos + 4 * 2 * 32)


def test_dense_weights_are_the_ports_parameter_count():
    from repro_torch.configs import get_config
    n = get_config("mistral-nemo-12b").param_count()
    V, D = NEMO["vocab_size"], NEMO["hidden_size"]
    assert dense.weight_bytes(NEMO) // 2 + V * D == n
    assert 12.2e9 < n < 12.3e9


def test_least_seconds_takes_the_larger_bound():
    peak = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert counts.least_seconds(2e12, 1e9, peak) == 2.0
    assert counts.least_seconds(1e12, 3e9, peak) == 3.0
