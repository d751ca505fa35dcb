"""The CI's ``--chaos`` serve lines through both drivers, on the same
weights (``test_torch_cli.py`` has the harness).

``--chaos transient``: the decode section's tokens, and the layer-wise
tokens from the store at window 2 (the JAX driver's clean run), equal
the JAX driver's; the port's faulted run equals its clean run.
``--chaos failover``: the tokens of the run in which ring stage 1 dies
equal the JAX driver's (both lose no token; each kills the stage at the
third token, counted its own way).
"""
import numpy as np
import pytest
import torch

from test_torch_cli import check_decode, lines_with, run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread: under the test runner's
    parallel workers, torch's default of a thread a core has every
    worker's threads spin against the others', and these shapes gain
    nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", lines_with("--chaos"))
def test_chaos_lines_match_the_jax_driver(argv, tmp_path, monkeypatch):
    rec, error, res, _, _ = run_both(argv, tmp_path, monkeypatch)
    assert error is None
    assert check_decode(rec, error, res)
    jc = rec.at("chaos")
    if "transient" in argv:
        n = int(argv[argv.index("--new-tokens") + 1])
        want = np.stack([jc["first"]] + jc["layerwise"][:n], 1)
        np.testing.assert_array_equal(res["chaos"]["tokens"], want)
        assert len(res["chaos"]["fired"]) == 3
    else:
        ev = res["chaos"]["event"]
        assert ev.failed_stage == 1 and ev.tokens_lost == 0
        np.testing.assert_array_equal(res["chaos"]["tokens"],
                                      jc["failover"])
