"""The serve driver's tier flags on the CPU, f32 pages: the 16 requests,
then their prompts again, through ``TierManager`` budgets (evictions to
host, spills to page files, recalls from both tiers) and a parked session
split in two turns, each run byte-identical to an unbudgeted one. The
int8-page case is ``tests/test_torch_cli_tiers_int8.py``: each case is a
few minutes of CPU, so each has a file of its own, which the test
runner's workers take one a file (named to be handed out early)."""
import pytest

from repro_torch.launch import serve
from test_torch_train import one_torch_thread  # noqa: F401  (autouse)


def budgets_and_parking(quant, capsys):
    flags = ["--page-tokens", "16", "--prefill-chunk", "16", "--device-budget",
             "0.04" if quant else "0.1", "--host-budget",
             "0.017" if quant else "0.07", "--park-idle-s", "0",
             "--io-deadline-s", "10"]
    res = serve.main(["--smoke", "--device", "cpu", "--dtype", "f32"]
                     + flags + (["--kv-quant-kernel"] if quant else []))
    out = capsys.readouterr().out
    # the 16 requests, then their prompts again: recalled from both tiers
    assert "tiered paged decode: 32 reqs byte-identical" in out
    assert "session parking: split run byte-identical" in out
    tiered = res["paged"]["tiered"]
    tiers, kv = tiered["tiers"], tiered["kv"]
    assert tiers["device"].peak <= tiers["device"].capacity
    assert tiers["host"].peak <= tiers["host"].capacity
    assert kv.evictions > 0 and kv.spilled_pages > 0
    assert 0 < kv.fetched_disk_pages < len(kv.fetch_events)
    assert tiered["session"].disk_bytes_written > 0


@pytest.mark.parametrize("quant", [False])
def test_serve_cli_budgets_and_parking(quant, capsys):
    budgets_and_parking(quant, capsys)
