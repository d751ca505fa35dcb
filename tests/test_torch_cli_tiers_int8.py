"""The serve driver's tier flags on the CPU over int8 pages
(``--kv-quant-kernel``): ``tests/test_torch_cli_tiers.py``'s case, in a
file of its own."""
import pytest

from test_torch_cli_tiers import budgets_and_parking
from test_torch_train import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("quant", [True])
def test_serve_cli_budgets_and_parking(quant, capsys):
    budgets_and_parking(quant, capsys)
