"""The frozen counts reproduce the bound column of PERF.md's kernel table
(max(bytes / 3.35 TB/s, operations / 989 TFLOP/s), printed to 0.01 µs)
at its shapes, and the model step's bytes and operations add up."""
import json
from pathlib import Path

import pytest

from portbench.counts import b1_decode, b3_decode, b3_tile, model_step

HERE = Path(__file__).resolve().parent


def us(bound):
    return round(bound[0] * 1e6, 2)


@pytest.mark.parametrize("M,K,N,want,by", [
    (8, 5120, 13824, 11.38, "bytes"),        # B3 decode
    (2, 5120, 6912, 5.63, "bytes"),          # B3 rank shard
    (8, 4096, 14336, 9.47, "bytes"),         # B3 expert
    (10, 27392, 5120, 22.47, "bytes"),       # B3 verify
])
def test_b3_decode(M, K, N, want, by):
    b = b3_decode.bound(M, K, N)
    assert us(b) == want and b[1] == by


def test_b3_tile():
    b = b3_tile.bound(512, 5120, 13824)
    assert us(b) == 73.28 and b[1] == "operations"


def test_b1_decode():
    # phase 2's lengths: rng(0).integers(64, 2049, 8), the first slot
    # inactive at T = 1 (one line of the sink)
    lens = [1, 1328, 1078, 599, 675, 145, 213, 96]
    b = b1_decode.bound(lens, batch=8, heads=40, kv_heads=8, head_dim=128)
    assert us(b) == 5.10 and b[1] == "bytes"


def conf(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_model_step_weights():
    c = conf("qwen1.5-32b-q4")
    m, w = c["model"], c["weights"]
    assert model_step.proj_params(m) * m["n_layers"] == 30_953_963_520
    q4 = model_step.weight_bytes(m, w)
    # q4 projections 0.53125 B a parameter, head and embedding row in bf16
    assert 16.4e9 < q4 - 2 * 5120 * 152064 < 16.6e9
    c14 = conf("qwen2.5-14b-bf16")
    bf = model_step.weight_bytes(c14["model"], c14["weights"])
    assert 27.9e9 < bf < 28.0e9
    # one token's K and V over 48 layers, bf16: 196,608 B
    assert model_step.kv_line_bytes(c14["model"]) == 196_608


def test_model_step_ops():
    c = conf("qwen2.5-14b-bf16")
    m, w = c["model"], c["weights"]
    ops1, nb1 = model_step.decode(m, w, [100])
    ops2, nb2 = model_step.decode(m, w, [100, 100])
    assert ops2 == 2 * ops1 and nb2 > nb1
    # a prefill's rows cost what as many decode rows over their keys do,
    # less the head of every row but the last
    S = 8
    ops, _ = model_step.prefill(m, w, S, 0, head_rows=1)
    rows = sum(model_step.decode(m, w, [i + 1])[0] for i in range(S))
    assert ops == rows - 2 * (S - 1) * m["d_model"] * m["vocab"]
    full, _ = model_step.prefill(m, w, S, 0, head_rows=S)
    assert full == rows
    t, by = model_step.least_s(*model_step.decode(m, w, [1000] * 32))
    nbytes = model_step.weight_bytes(m, w) + 196_608 * (32_000 + 32)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
