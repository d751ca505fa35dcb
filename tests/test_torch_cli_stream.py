"""The CI's ``--stream-window`` serve lines through both drivers, on the
same weights (``test_torch_cli.py`` has the harness and says what the
reference cannot run here).

The decode section's tokens and the layer-wise streamed decode's (the
first token of its resident prefill, then every step pulled from the
store, f32 or q4) must equal the JAX driver's. The JAX streamed SPMD ring
that follows raises XLA's aliased-buffer error on this box (jax 0.9.0),
so the port's streamed ring is held against its own resident ring over
the stored weights, which the driver checks token for token.
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


@pytest.mark.parametrize("argv", lines_with("--stream-window"))
def test_stream_lines_match_the_jax_driver(argv, tmp_path, monkeypatch):
    rec, error, res, tpaths, _ = run_both(argv, tmp_path, monkeypatch)
    assert check_decode(rec, error, res)
    js = rec.at("stream")
    want = np.stack([js["first"]] + js["layerwise"], 1)
    np.testing.assert_array_equal(res["stream"]["tokens"], want)
    # the reference stops in its streamed ring (named above)
    assert error is not None and error[0] == "stream"
    assert "aliased" in str(error[1]).lower()
    ring = res["ring"]
    assert np.array_equal(ring["streamed_tokens"], ring["stored_tokens"])
    if "--store-quant" in argv:
        assert res["stream"]["decode_stats"].peak_resident_bytes \
            <= 2 * res["stream"]["store_layer_nbytes"]
    if "--trace" in argv:
        from repro.runtime.telemetry import validate_chrome_trace as j_valid
        from repro_torch.runtime.telemetry import validate_chrome_trace
        for validate in (validate_chrome_trace, j_valid):
            validate(tpaths["--trace"], ("prefetcher", "decode"))
