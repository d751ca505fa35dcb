"""The GSPMD layer's cases of ``tests/test_torch_gspmd.py`` for the MLA
(minicpm3-4b: the latent split by sequence), hybrid (recurrentgemma-9b:
the RG-LRU split by channel, its local attention's single kv head by
sequence) and audio (whisper-tiny: the decoder's heads, its frames
encoded in the prefill) families at B = 1, 2 and 8 on the (4, 2) mesh;
the dense family on the (2, 2, 2) mesh with pods (B = 2: the batch over
"pod" alone) and at B = 8; and the negative control, members merging
their sequence shards without their offsets, which must fail."""
import pytest
import torch

from test_torch_gspmd import (check_cache_and_bytes, check_logits,
                              run_gspmd)
from repro_torch.launch.mesh import RankWorld

CASES = [(a, B) for a in ("minicpm3-4b", "recurrentgemma-9b",
                          "whisper-tiny") for B in (1, 2, 8)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread (the suite's parallel
    workers would otherwise spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = RankWorld(8, device="cpu", threads=1, timeout_s=180)
    yield w
    w.close()


@pytest.mark.parametrize("arch,B", CASES,
                         ids=[f"{a}-B{b}" for a, b in CASES])
def test_gspmd_prefill_and_decode_match_jax(world, arch, B):
    ref, res, tree = run_gspmd(world, arch, B)
    check_logits(ref, res)
    check_cache_and_bytes(ref, res, tree)


@pytest.mark.parametrize("B", [2, 8])
def test_gspmd_on_the_pod_mesh_matches_jax(world, B):
    ref, res, tree = run_gspmd(world, "qwen2.5-14b", B, shape=(2, 2, 2))
    check_logits(ref, res)
    check_cache_and_bytes(ref, res, tree)
    # B = 2: one row a pod, replicated over "data"; B = 8: two rows a
    # (pod, data) rank
    n = {2: 1, 8: 2}[B]
    assert {r["rows"] for r in res} == {(i * n, (i + 1) * n)
                                       for i in range(B // n)}


def test_merging_without_offsets_fails(world):
    """The negative control: each member masks its sequence shard as if
    it began at line 0, so the merged attention reads the wrong lines."""
    ref, res, _ = run_gspmd(world, "qwen2.5-14b", 8, offsets=False)
    with pytest.raises(AssertionError):
        check_logits(ref, res)
