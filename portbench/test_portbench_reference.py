"""The plain reference against the port's plain path at a tiny config, on
the same weights held in float32 (the q4 projections packed): the
reference unpacks and scales the B3 layout itself. The test imports both;
the reference imports nothing of the port."""
import numpy as np
import pytest
import torch

from portbench import program, weights
from portbench.reference import dense
from portbench.testing import CONFIGS

from repro_torch.models import model as M
from repro_torch.runtime.paramstore import ResidentSource


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(w):
    return {k: v if isinstance(v, dict) else v.float() for k, v in w.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_matches_the_port(name):
    conf = CONFIGS[name]
    m = conf["model"]
    w = f32(weights.make(m, conf["weights"], 11, torch.device("cpu")))
    cfg = program.model_config(m)
    toks = torch.as_tensor(np.random.default_rng(1).integers(3, 256, 40))
    if name == "tiny-q4":
        src = ResidentSource({"embed": w["embed"], "unembed": w["unembed"],
                              "final_norm": w["final_norm"],
                              "blocks": program._blocks_tree(w, m)})
        port = M.forward_layerwise(src, cfg, toks[None])[0]
    else:
        port = M.forward(program.dense_model(w, m), cfg, toks[None])[0]
    ref = dense.logits(w, m, [toks], [(0, 40)])[0]
    scale = float(ref.abs().max())
    assert float((port.float() - ref).abs().max()) < 2e-5 * scale
    low = dense.logits(w, m, [toks], [(0, 40)], precision="fp8")[0]
    assert float((low - ref).abs().max()) > 1e-2 * scale


def test_unpack_q4_layout():
    # rows 0, 1 in the low and high nibble of byte 0: 7 and -8; rows 2, 3
    # in byte 1: -1 and 1
    packed = torch.tensor([[0x87], [0x1F]], dtype=torch.uint8).view(
        torch.int8)
    scale = torch.tensor([[0.5]], dtype=torch.bfloat16)
    w = dense.unpack_q4(packed, scale, 4)
    assert w[:, 0].tolist() == [3.5, -4.0, -0.5, 0.5]


def test_fp8_round():
    x = torch.tensor([[448.0, 1.0, 0.3], [2.0, -2.0, 0.0]])
    y = dense.fp8_round(x, -1)
    assert y[0, 0] == 448.0 and y[1, 1] == -2.0 and y[1, 2] == 0.0
    assert float((y - x).abs().max()) > 0


def test_q4_values_are_a_symmetric_quantizer_s():
    conf = CONFIGS["tiny-q4"]
    w = weights.make(conf["model"], conf["weights"], 5, torch.device("cpu"))
    v = w["w_gate"]
    q = dense.unpack_q4(v["packed"][0], torch.ones_like(v["scale"][0]),
                        int(v["group"]))
    assert int(q.min()) == -7 and int(q.max()) == 7
    assert abs(float(q.mean())) < 0.1
