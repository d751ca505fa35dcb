"""The port's copies of the JAX package's scheduler modules give its
results: device and model profiles (``core.profiles``), the latency model
(``core.latency``), Halda (``core.halda``: both solver back-ends and the
speculative post-pass), device-subset selection (``core.cluster``), the
ring schedule (``core.ring``) and the elastic re-plan
(``runtime.elastic``), on the paper's cluster and on seeded random
clusters — the same inputs built through each package, the same
decisions and objective to the bit.
"""
import numpy as np
import pytest
import torch

import repro.core.cluster as j_cluster
import repro.core.halda as j_halda
import repro.core.latency as j_latency
import repro.core.profiles as j_profiles
import repro.core.ring as j_ring
from repro.configs import get_config
from repro.runtime import elastic as j_elastic
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import cluster as t_cluster
from repro_torch.core import halda as t_halda
from repro_torch.core import latency as t_latency
from repro_torch.core import profiles as t_profiles
from repro_torch.core import ring as t_ring
from repro_torch.runtime import elastic as t_elastic

GiB = 1 << 30


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


def model_70b(P=j_profiles):
    return P.ModelProfile(
        name="llama70b", n_layers=80, layer_bytes=0.48 * GiB,
        input_bytes=0.27 * GiB, output_bytes=0.27 * GiB, embed_dim=8192,
        vocab=128256, kv_heads=8, head_dim=128, n_kv=1024,
        flops_layer={"q4k": 2 * 0.85e9},
        flops_output={"q4k": 2 * 8192 * 128256})


def t_model_70b():
    return model_70b(t_profiles)


def small_model(P, n_layers=12, layer_gib=0.4, n_kv=256):
    return P.ModelProfile(
        name="m", n_layers=n_layers, layer_bytes=layer_gib * GiB,
        input_bytes=0.2 * GiB, output_bytes=0.2 * GiB, embed_dim=4096,
        vocab=32000, kv_heads=8, head_dim=128, n_kv=n_kv,
        flops_layer={"q4k": 2 * layer_gib * GiB / 0.5625},
        flops_output={"q4k": 2 * 4096 * 32000})


def random_cluster(P, seed):
    """(devices, model) drawn from ``seed`` as ``tests/test_halda.py``'s
    random clusters are."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 5))
    devs = []
    for i in range(m):
        vram = float(rng.choice([0, 0, 4, 8]))
        flops = float(rng.uniform(50e9, 400e9))
        devs.append(P.DeviceProfile(
            name=f"d{i}", os=P.OS.LINUX,
            ram_avail=float(rng.uniform(2, 16)) * GiB,
            vram_avail=vram * GiB, has_cuda=vram > 0,
            cpu_flops={q: flops for q in P.QUANTS},
            gpu_flops={q: flops * 8 for q in P.QUANTS} if vram else {},
            cpu_membw=30e9, gpu_membw=300e9 if vram else 0.0,
            disk_seq_bps=(disk := float(rng.uniform(0.5, 4.0))) * 1e9,
            disk_rand_bps=disk * 0.6e9, t_comm=1e-3))
    L = int(rng.choice([8, 12, 16, 24]))
    return devs, small_model(P, n_layers=L,
                             layer_gib=float(rng.uniform(0.1, 0.6)))


def same_solution(a, b):
    assert (list(a.w), list(a.n), a.k) == (list(b.w), list(b.n), b.k)
    assert [c.value for c in a.cases] == [c.value for c in b.cases]
    assert a.latency == b.latency
    assert a.relaxed == b.relaxed and a.iterations == b.iterations


def paper_cases():
    return [("paper", j_profiles.paper_table2_cluster(), model_70b(),
             t_profiles.paper_table2_cluster(), t_model_70b()),
            ("paper+extra",
             j_profiles.paper_table2_cluster()
             + j_profiles.paper_table2_extra(), model_70b(),
             t_profiles.paper_table2_cluster()
             + t_profiles.paper_table2_extra(), t_model_70b())]


@pytest.mark.parametrize("case", range(2))
def test_halda_on_the_paper_cluster(case):
    _, jd, jm, td, tm = paper_cases()[case]
    same_solution(t_halda.solve(td, tm), j_halda.solve(jd, jm))


@pytest.mark.parametrize("seed", range(3))
def test_halda_branch_and_bound_back_end(seed):
    """The pure-Python branch and bound (scipy's milp bypassed) on small
    random clusters, as ``tests/test_halda.py`` runs it."""
    jd, jm = random_cluster(j_profiles, seed)
    td, tm = random_cluster(t_profiles, seed)
    jd, td = jd[:2], td[:2]
    same_solution(t_halda.solve(td, tm, force_fallback=True),
                  j_halda.solve(jd, jm, force_fallback=True))


@pytest.mark.parametrize("seed", range(8))
def test_halda_on_random_clusters(seed):
    jd, jm = random_cluster(j_profiles, seed)
    td, tm = random_cluster(t_profiles, seed)
    js, ts = j_halda.solve(jd, jm), t_halda.solve(td, tm)
    same_solution(ts, js)
    assert t_latency.token_latency(td, tm, ts.w, ts.n, ts.cases) \
        == j_latency.token_latency(jd, jm, js.w, js.n, js.cases)
    for i, (a, b) in enumerate(zip(td, jd)):
        assert t_latency.classify_device(a, i, tm, ts.w[i], ts.n[i], ts.k) \
            .value == j_latency.classify_device(b, i, jm, js.w[i], js.n[i],
                                                js.k).value
    to = t_latency.build_objective(td, tm, ts.cases)
    jo = j_latency.build_objective(jd, jm, js.cases)
    for f in ("a", "b", "c"):
        assert np.array_equal(np.asarray(getattr(to, f)),
                              np.asarray(getattr(jo, f))), f
    assert to.kappa == jo.kappa


def test_speculative_post_pass_and_ttft():
    jd, jm = random_cluster(j_profiles, 3)
    td, tm = random_cluster(t_profiles, 3)
    kw = dict(gamma=4, acceptance=0.8, draft_token_latency=1e-3)
    js = j_halda.solve(jd, jm, spec=j_halda.SpecPostPass(**kw))
    ts = t_halda.solve(td, tm, spec=t_halda.SpecPostPass(**kw))
    same_solution(ts, js)
    assert ts.spec_report == js.spec_report
    for chunk in (0, 8, 16):
        assert t_latency.chunked_prefill_ttft(
            td, tm, ts.w, ts.n, 64, chunk=chunk, decode_step_s=1e-3) \
            == j_latency.chunked_prefill_ttft(
                jd, jm, js.w, js.n, 64, chunk=chunk, decode_step_s=1e-3)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen1.5-32b",
                                  "mamba2-780m"])
def test_profile_from_config(arch):
    a = t_profiles.profile_from_config(t_get_config(arch))
    b = j_profiles.profile_from_config(get_config(arch))
    assert a.__dict__ == b.__dict__


def test_select_cluster_and_fail_and_resolve():
    _, jd, jm, td, tm = paper_cases()[1]
    jc, tc = j_cluster.select_cluster(jd, jm), t_cluster.select_cluster(
        td, tm)
    assert tc.devices == jc.devices and tc.history == jc.history
    same_solution(tc.solution, jc.solution)
    for failed in ([1], [2, 3]):
        same_solution(t_cluster.fail_and_resolve(td[:4], tm, failed),
                      j_cluster.fail_and_resolve(jd[:4], jm, failed))
    with pytest.raises(RuntimeError):
        t_cluster.fail_and_resolve(td[:2], tm, [0, 1])


@pytest.mark.parametrize("arch,n_stages,k,failed", [
    ("qwen2.5-14b", 4, 1, [2]), ("qwen2.5-14b", 4, 2, [0, 3]),
    ("qwen1.5-32b", 8, 2, [5]), ("mamba2-780m", 3, 4, [1])])
def test_elastic_fail_stages(arch, n_stages, k, failed):
    jc, tc = get_config(arch), t_get_config(arch)
    js = j_elastic.fail_stages(j_elastic.initial_state(jc, n_stages, k=k),
                               jc, failed)
    ts = t_elastic.fail_stages(t_elastic.initial_state(tc, n_stages, k=k),
                               tc, failed)
    assert ts.stages == js.stages and ts.generation == js.generation
    assert (ts.plan.n_stages, ts.plan.k, ts.plan.w, ts.plan.L_pad) == (
        js.plan.n_stages, js.plan.k, js.plan.w, js.plan.L_pad)
    with pytest.raises(RuntimeError, match="all stages failed"):
        t_elastic.fail_stages(ts, tc, ts.stages)


def test_resolve_heterogeneous_and_remap():
    _, jd, jm, td, tm = paper_cases()[0]
    js = j_elastic.resolve_heterogeneous(jd[:3], jm)
    ts = t_elastic.resolve_heterogeneous(td[:3], tm)
    same_solution(ts, js)
    a, b = t_elastic.remap_schedule(ts, 80), j_elastic.remap_schedule(js, 80)
    assert [w.__dict__ for w in a.windows] == [w.__dict__ for w in b.windows]
    t_ring.validate_schedule(a)


@pytest.mark.parametrize("w,n,L", [([2, 3, 1], [1, 3, 0], 12),
                                   ([4, 0, 4], [2, 0, 4], 16),
                                   ([5], [5], 10)])
def test_ring_schedule(w, n, L):
    a, b = t_ring.build_schedule(w, n, L), j_ring.build_schedule(w, n, L)
    assert [x.__dict__ for x in a.windows] == [x.__dict__ for x in b.windows]
    assert a.k == b.k and [x.__dict__ for x in a.device_windows(0)] == [
        x.__dict__ for x in b.device_windows(0)]
    t_ring.validate_schedule(a)
    with pytest.raises(ValueError):
        t_ring.build_schedule(w, n, L + 1)
