"""A run of each tiny cell on the CPU, through the whole harness with the
chip's look skipped: sound, ``correct`` holds; with the timed path broken
underneath -- a decode step that leaves the cache as it was, or a token
altered where it is produced -- it does not. And the fp8 control, put in
the program's place, reads above the limit that sound runs keep under."""
import pytest
import torch

from portbench import testing


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("tiny")
    testing.write_tree(r)
    return r


def kv_tensors(cache):
    if "pages" in cache:
        return list(cache["pages"].values())
    return list(cache["layers"].values())


def state_unchanged(eng):
    """Every decode step leaves the cache's keys and values as they were
    (its length still advances)."""
    decode = eng.decode

    def broken(cache, tokens):
        keep = [t.clone() for t in kv_tensors(cache)]
        out = decode(cache, tokens)
        for t, k in zip(kv_tensors(cache), keep):
            t.copy_(k)
        return out
    eng.decode = broken


def token_altered(eng):
    """Every seventh decode step puts another token first in every row."""
    decode, n = eng.decode, [0]

    def broken(cache, tokens):
        logits, cache = decode(cache, tokens)
        n[0] += 1
        if n[0] % 7 == 0:
            logits = logits.clone()
            top = logits[:, 0].argmax(-1)
            alt = (top + 1) % logits.shape[-1]
            logits[torch.arange(logits.shape[0]), 0, alt] = \
                logits[:, 0].max(-1).values + 1.0
        return logits, cache
    eng.decode = broken


@pytest.mark.parametrize("cell", sorted(testing.CELLS))
@pytest.mark.parametrize("fault", [None, state_unchanged, token_altered],
                         ids=["sound", "state_unchanged", "token_altered"])
def test_fault_turns_correct_false(root, cell, fault):
    r = testing.run(root, cell, hooks=fault)
    assert r["checks"]["failed_requests"]["value"] == 0
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(testing.CELLS))
def test_control_fails_the_limit(root, cell):
    from portbench import harness
    import time

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed in (1, 2, 3):
            r = harness.run_cell(root, cell, seed, 1.0, False,
                                 t_proc=time.perf_counter(), device="cpu",
                                 bench=root / "portbench", control=True)
            assert r["checks"]["logit_gap"]["value"] <= testing.LIMIT
            assert r["control"]["logit_gap"] > testing.LIMIT
            assert r["control"]["correct"] is False
            assert list(r)[-1] == "checks"
    finally:
        torch.set_num_threads(n)
