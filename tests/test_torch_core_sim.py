"""The rest of the port's ``core/``: the copied ring simulator and
baselines against the JAX package's on the same profiles (results equal
exactly: both are the same float arithmetic over the same inputs), and
the profiler's probes and ``DeviceProfile`` on the CPU (the card's terms
are measured by ``chip_smoke.py``)."""
import dataclasses
import math

import pytest
import torch

from repro.configs import get_config
from repro.core import baselines as JB
from repro.core import profiles as JP
from repro.core import simulator as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import baselines as TB
from repro_torch.core import halda as TH
from repro_torch.core import profiler as TPR
from repro_torch.core import profiles as TP
from repro_torch.core import simulator as TS

ARCHS = ["llama3-70b", "mixtral-8x7b", "qwen2.5-14b"]


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


def _both(arch):
    jc = JP.paper_table2_cluster()
    tc = TP.paper_table2_cluster()
    jm = JP.profile_from_config(get_config(arch))
    tm = TP.profile_from_config(t_get_config(arch))
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    return jc, tc, jm, tm


def _eq(a, b):
    """Two results of the two packages: the same fields, the same values
    (enums compared by value)."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        x, y = da[k], db[k]
        if isinstance(x, list) and x and hasattr(x[0], "value"):
            x, y = [c.value for c in x], [c.value for c in y]
        assert x == y or (isinstance(x, float) and math.isnan(x)
                          and math.isnan(y)), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", ["llama_cpp", "exo", "dllama",
                                      "prima_no_halda"])
def test_baselines_equal_jax(arch, strategy):
    jc, tc, jm, tm = _both(arch)
    _eq(getattr(TB, strategy)(tc, tm), getattr(JB, strategy)(jc, jm))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("k", [1, 2])
def test_simulate_ring_equals_jax(arch, k):
    """The ring timeline over Halda's windows (and a uniform split at
    k rounds), prefetch on and off, weights streamed and resident."""
    jc, tc, jm, tm = _both(arch)
    sol = TH.solve(tc, tm)
    M, L = len(tc), tm.n_layers
    plans = [(sol.w, sol.n)]
    if L % (M * k) == 0:
        plans.append(([L // (M * k)] * M, [0] * M))
    for w, n in plans:
        for kw in ({}, {"prefetch": False}, {"resident_weights": True},
                   {"decode_seq": 4}):
            _eq(TS.simulate_ring(tc, tm, w, n, **kw),
                JS.simulate_ring(jc, jm, w, n, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_simulate_speculative_and_tp_equal_jax(arch):
    jc, tc, jm, tm = _both(arch)
    sol = TH.solve(tc, tm)
    kw = dict(gamma=4, acceptance=0.75, draft_token_latency=0.01)
    _eq(TS.simulate_speculative(tc, tm, sol.w, sol.n, **kw),
        JS.simulate_speculative(jc, jm, sol.w, sol.n, **kw))
    _eq(TS.simulate_tp(tc, tm), JS.simulate_tp(jc, jm))


def test_probes_on_the_cpu(tmp_path):
    """Every probe measures something positive and finite on CPU
    tensors; the disk probes write and remove their files under
    ``path``."""
    cpu = "cpu"
    for v in (TPR.measure_flops(128, device=cpu),
              TPR.measure_membw(1 << 20, device=cpu),
              TPR.measure_kv_copy(device=cpu),
              TPR.measure_disk(1 << 20, path=str(tmp_path)),
              TPR.measure_disk_random(1 << 20, block=1 << 16,
                                      path=str(tmp_path)),
              TPR.measure_stream_read(1 << 18, n_layers=2,
                                      path=str(tmp_path)),
              TPR.host_ram_available()):
        assert 0 < v < math.inf
    assert list(tmp_path.iterdir()) == []


def test_profile_of_the_host_plans_with_halda(tmp_path):
    """``profile_local_device(device="cpu")``: the host alone (no CUDA
    terms), as the JAX package profiles a machine without an accelerator;
    Halda plans a model over it and two copies of it."""
    prof = TPR.profile_local_device("host", device="cpu",
                                    path=str(tmp_path))
    assert isinstance(prof, TP.DeviceProfile)
    assert not prof.has_cuda and prof.vram_avail == 0.0
    assert prof.gpu_flops == {} and prof.gpu_membw == 0.0
    assert set(prof.cpu_flops) == set(TP.QUANTS)
    assert min(prof.cpu_flops.values()) > 0 and prof.cpu_membw > 0
    assert prof.disk_seq_bps > 0 and prof.disk_rand_bps > 0
    model = TP.profile_from_config(t_get_config("mixtral-8x7b"))
    for devs in ([prof], [prof, dataclasses.replace(prof, name="host2")]):
        sol = TH.solve(devs, model)
        assert sum(sol.w) * sol.k == model.n_layers
        assert math.isfinite(sol.latency) and sol.latency > 0
