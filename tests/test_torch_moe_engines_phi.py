"""The moe engine cases of ``tests/test_torch_moe_engines.py`` for
phi3.5-moe: the same tests, collected here beside a phi3.5-moe
``world``."""
import pytest
import torch

from test_torch_moe_engines import _world
from test_torch_moe_engines import (  # noqa: F401  (collected here)
    q4_store,
    test_card_route_of_the_expert_matmuls,
    test_dense_engine_drops_where_jax_does,
    test_dense_engine_matches_jax_and_paged,
    test_paged_engine_streams_match_jax,
    test_paged_spec_engine_matches_jax,
    test_prefix_share_and_cow_match_jax,
    test_streamed_q4_engine_matches_jax)


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


@pytest.fixture(scope="module", params=["phi3.5-moe-42b-a6.6b"])
def world(request):
    return _world(request.param)
