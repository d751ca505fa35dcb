"""The CI's serve command lines through both drivers, on the same weights.

Every ``python -m repro.launch.serve`` line of ``.github/workflows/ci.yml``
runs twice: through the JAX driver as written, and through the port's
driver with ``repro_torch`` in its place (``--device cpu``), fed the JAX
driver's weights (``init_params(cfg, PRNGKey(0))``, carried across by
``bridge``). The port must exit 0 on every line, and the greedy tokens of
each section must equal the JAX driver's wherever the reference runs:

- decode: the batch's first token and every ring step's;
- stream: the first token and every layer-wise step from the store;
- paged: every request's stream from the dense-cache engine (and the
  paged engine's);
- chaos: the clean layer-wise tokens (transient), the failover run's
  tokens (failover).

The JAX driver's tokens are recorded by wrapping the functions it calls
(nothing of it is edited). What the reference cannot run on this box
(jax 0.9.0; CI pins 0.4.37), each case names:

- the GSPMD decode where the batch does not split over the stages (the
  ``--batch 2`` tier line, and the ``--batch 1`` case of the CI's first
  smoke line here): it raises a sharding error, so the port's GSPMD
  decode across the ranks (``res["decode"]["gspmd"]``) is held to the
  JAX ``decode_step``'s greedy tokens from the JAX driver's own prefilled
  cache, and the JAX paged section of that line is run through the
  driver's own ``_paged_smoke``;
- the streamed SPMD ring of the ``--stream-window`` lines: it raises
  XLA's aliased-buffer error after the layer-wise decode (ROADMAP,
  reference caveats); the port's streamed ring is held against its
  resident ring instead;
- the dense check of int8 pages with chunked admission: the JAX driver
  exits with "paged-kv parity FAILED" (the two never match, in either
  package); the paged streams are compared, the dense ones are not.

This file holds the ``--paged-kv`` lines; ``test_torch_cli_stream.py`` and
``test_torch_cli_chaos.py`` the others.
"""
import contextlib
import dataclasses
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as JD
import repro.models as JMODELS
import repro.runtime.engine as JENG
import repro.runtime.failover as JFO
import repro.runtime.kvcache as JKV
import repro.runtime.serve as JRS
from repro.configs import get_config
from repro.models import init_params as j_init_params
from repro_torch import bridge
from repro_torch.launch import serve as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI = os.path.join(ROOT, ".github", "workflows", "ci.yml")


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


def ci_serve_lines():
    """Each ``repro.launch.serve`` command of the CI file: (its first line
    number, its arguments), continuation lines joined."""
    with open(CI) as f:
        lines = f.read().splitlines()
    out, i = [], 0
    while i < len(lines):
        if "python -m repro.launch.serve" in lines[i]:
            start, cmd = i + 1, lines[i].strip()
            while cmd.endswith("\\"):
                i += 1
                cmd = cmd[:-1] + " " + lines[i].strip()
            argv = shlex.split(cmd)
            out.append((start, argv[argv.index("repro.launch.serve") + 1:]))
        i += 1
    return out


def lines_with(flag):
    return [pytest.param(argv, id=f"ci.yml:{n}")
            for n, argv in ci_serve_lines() if flag in argv]


def _outputs(argv, tmp_path, tag):
    """``argv`` with its output files moved under ``tmp_path`` (one set a
    driver), and the moved paths by flag."""
    argv, paths = list(argv), {}
    for flag in ("--metrics-out", "--trace"):
        if flag in argv:
            i = argv.index(flag) + 1
            argv[i] = paths[flag] = str(tmp_path / f"{tag}_{argv[i]}")
    return argv, paths


def _tok(x):
    return np.asarray(x).reshape(-1).astype(np.int64)


class _Recorder:
    """Wraps what the JAX driver calls and keeps each section's tokens."""

    def __init__(self, monkeypatch, vocab):
        self.section = "decode"
        self.rec = {}
        self.vocab = vocab
        mp = monkeypatch
        mp.setattr(JD, "prefill", self._prefill(JD.prefill))
        mp.setattr(JRS, "build_ring_serve_step",
                   self._ring(JRS.build_ring_serve_step))
        mp.setattr(JRS, "gspmd_decode_step",
                   self._gspmd(JRS.gspmd_decode_step))
        mp.setattr(JMODELS, "decode_step_layerwise",
                   self._layerwise(JMODELS.decode_step_layerwise))
        mp.setattr(JENG, "make_dense_engine",
                   self._engine(JENG.make_dense_engine, "dense"))
        mp.setattr(JKV, "make_paged_engine",
                   self._engine(JKV.make_paged_engine, "paged"))
        gen = JFO.ElasticRingServer.generate

        def generate(srv, prompts, max_new):
            toks = gen(srv, prompts, max_new)
            self.at()["failover"] = np.asarray(toks)
            return toks
        mp.setattr(JFO.ElasticRingServer, "generate", generate)
        for name in ("_stream_smoke", "_paged_smoke", "_chaos_smoke"):
            mp.setattr(JD, name, self._marked(getattr(JD, name), name))

    def at(self, section=None):
        return self.rec.setdefault(section or self.section, {})

    def _marked(self, fn, name):
        section = name.strip("_").split("_")[0]

        def wrapped(*a, **k):
            self.section = section
            self.at()["started"] = True
            return fn(*a, **k)
        return wrapped

    def _prefill(self, fn):
        def wrapped(*a, **k):
            logits, cache = fn(*a, **k)
            rec = self.at()
            rec.setdefault("first", _tok(jnp.argmax(logits[:, -1], -1)))
            return logits, cache
        return wrapped

    def _ring(self, fn):
        def build(cfg, mesh, plan, n_tokens=1, **kw):
            builder = fn(cfg, mesh, plan, n_tokens=n_tokens, **kw)

            def make(*a):
                step = builder(*a)

                def run(tok, ln, pr, cache):
                    logits, cache = step(tok, ln, pr, cache)
                    if n_tokens == 1 and self.section == "decode":
                        self.at().setdefault("steps", []).append(
                            _tok(jnp.argmax(logits[:, 0, :self.vocab], -1)))
                    return logits, cache
                return run
            return make
        return build

    def _gspmd(self, fn):
        def build(cfg, mesh, params, cache, **kw):
            # the prefilled cache, kept before the step may consume it
            self.at()["gspmd_from"] = (cfg, params,
                                       jax.tree.map(jnp.copy, cache))
            return fn(cfg, mesh, params, cache, **kw)
        return build

    def _layerwise(self, fn):
        def wrapped(*a, **k):
            logits, cache = fn(*a, **k)
            self.at().setdefault("layerwise", []).append(
                _tok(jnp.argmax(logits[:, 0], -1)))
            return logits, cache
        return wrapped

    def _engine(self, fn, kind):
        def make(*a, **k):
            out = fn(*a, **k)
            eng = out[0] if isinstance(out, tuple) else out
            run = eng.run

            def recorded(*ra, **rk):
                fin, steps = run(*ra, **rk)
                self.at().setdefault(kind, []).append(
                    {f.uid: list(f.tokens) for f in fin})
                return fin, steps
            eng.run = recorded
            return out
        return make


def run_both(argv, tmp_path, monkeypatch):
    """One CI line through both drivers. Returns (the JAX driver's
    recorder, the error it raised or None, the port's result, the port's
    output paths, the JAX driver's output paths)."""
    arch = argv[argv.index("--arch") + 1]
    cfg = get_config(arch).reduced()
    jparams = j_init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device=torch.device("cpu"))
    rec = _Recorder(monkeypatch, cfg.vocab)
    jargv, jpaths = _outputs(argv, tmp_path, "jax")
    error = None
    try:
        JD.main(jargv)
    except (Exception, SystemExit) as e:      # the reference's own failures
        error = (rec.section, e)
    targv, tpaths = _outputs(argv, tmp_path, "port")
    res = TD.run(TD.parse_args(targv + ["--device", "cpu"]), params=tparams)
    if "--paged-kv" in argv and "started" not in rec.at("paged"):
        # the decode section stopped the JAX driver first (the GSPMD
        # decode at a batch the stages do not split): its paged section,
        # run through the driver's own function on the same weights
        ns = TD.parse_args(targv + ["--device", "cpu"])
        pcfg = cfg
        if ns.kv_quant_kernel:
            pcfg = dataclasses.replace(cfg, kv_dtype="int8")
        rec.section = "paged"
        with contextlib.suppress(SystemExit):
            JD._paged_smoke(pcfg, jparams, ns)
    return rec, error, res, tpaths, jpaths


def jax_plain_decode(jdec, n_new):
    """The JAX ``decode_step``'s greedy tokens (B, n_new) from the cache
    the JAX driver prefilled and handed its GSPMD decode."""
    cfg, params, cache = jdec["gspmd_from"]
    tok = jnp.asarray(jdec["first"], jnp.int32)[:, None]
    steps = []
    for _ in range(n_new):
        logits, cache = JMODELS.decode_step(params, cfg, cache, tok)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        steps.append(_tok(tok))
    return np.stack(steps, 1)


def check_decode(rec, error, res):
    """The decode section's tokens. Where the ring does not apply the
    reference's GSPMD decode fails under jax 0.9.0: the port's GSPMD decode
    across the ranks is held to the JAX ``decode_step`` from the same
    prefilled cache instead. Returns whether the ring ran."""
    port = res["decode"]["tokens"]
    jdec = rec.at("decode")
    if "steps" not in jdec:
        assert error is not None and error[0] == "decode"
        assert "sharding" in repr(error[1]).lower() \
            or "Sharding" in type(error[1]).__name__
        assert res["ring"] is None
        gspmd = res["decode"]["gspmd"]
        assert gspmd["ranks"] == 8                    # the (4, 2) world
        want = jax_plain_decode(jdec, port.shape[1] - 1)
        np.testing.assert_array_equal(gspmd["tokens"][:, :, 0], want)
        np.testing.assert_array_equal(port[:, 0], jdec["first"])
        np.testing.assert_array_equal(port[:, 1:], want)
        return False
    assert res["decode"]["gspmd"] is None
    want = np.stack([jdec["first"]] + jdec["steps"], 1)
    np.testing.assert_array_equal(port, want)
    return True


def check_paged(rec, res, dense=True):
    jp = rec.at("paged")
    got = {f.uid: list(f.tokens) for f in res["paged"]["finished"]}
    assert jp["paged"][0] == got
    if dense:
        assert jp["dense"][0] == got


PAGED = lines_with("--paged-kv")


def test_every_ci_serve_line_is_held_here():
    """The three files cover every serve line of the CI file."""
    names = ("--paged-kv", "--stream-window", "--chaos")
    lines = ci_serve_lines()
    assert len(lines) == 10
    assert all(sum(n in argv for n in names) == 1 for _, argv in lines)


@pytest.mark.parametrize("argv", PAGED)
def test_paged_lines_match_the_jax_driver(argv, tmp_path, monkeypatch):
    rec, error, res, tpaths, jpaths = run_both(argv, tmp_path, monkeypatch)
    int8_chunked = "--kv-quant-kernel" in argv and "--prefill-chunk" in argv
    check_decode(rec, error, res)
    check_paged(rec, res, dense=not int8_chunked)
    if int8_chunked:
        # the JAX driver's dense check fails here: its paged section
        # stops with "paged-kv parity FAILED"; the port skips that check
        assert error is not None and error[0] == "paged"
        assert "parity FAILED" in str(error[1])
        assert rec.at("paged")["dense"][0] != rec.at("paged")["paged"][0]
    elif "--batch" in argv and argv[argv.index("--batch") + 1] == "2":
        assert error is not None and error[0] == "decode"
    else:
        assert error is None
    if "--device-budget" in argv:
        tiered = res["paged"]["tiered"]
        assert tiered["tiers"]["device"].peak <= \
            tiered["tiers"]["device"].capacity
        assert tiered["session"].restored_sessions >= 1
    if "--metrics-out" in argv:
        from repro.runtime.metrics import \
            validate_metrics_snapshot as j_validate
        from repro_torch.runtime.metrics import validate_metrics_snapshot
        require = (["request/prefill_chunks", "decode/step_s"]
                   if "--prefill-chunk" in argv else
                   ["request/ttft_s", "request/tpot_s", "decode/step_s",
                    "requests/finished", "kv/pages_active", "slots/active"])
        for validate in (validate_metrics_snapshot, j_validate):
            validate(tpaths["--metrics-out"], require=require)


def test_batch_1_decodes_across_the_ranks(tmp_path, monkeypatch):
    """The CI's first qwen2.5-14b ``--smoke`` line at ``--batch 1``: one
    sequence does not split over 4 stages, so both drivers take the GSPMD
    decode (the JAX driver's raises here, see the module docstring); the
    port's runs across the 8 ranks."""
    argv = next(a for _, a in ci_serve_lines() if "--paged-kv" in a)
    argv = list(argv)
    argv[argv.index("--batch") + 1] = "1"
    rec, error, res, _, _ = run_both(argv, tmp_path, monkeypatch)
    assert not check_decode(rec, error, res)
    assert res["decode"]["tokens"].shape == (1, 5)
    check_paged(rec, res)
