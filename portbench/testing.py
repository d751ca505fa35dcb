"""Tiny cells for the CPU tests: the real configurations' shapes of model,
engine and traffic at widths a test run can hold (d 64, 2 layers,
vocab 256), written as a benchmark tree of their own, and run through
the same harness on the CPU (the port's plain kernel versions)."""
from __future__ import annotations

import json
import time
from pathlib import Path

MODEL = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64,
         "n_heads": 4, "kv_heads": 2, "head_dim": 16, "d_ff": 128,
         "vocab": 256, "qkv_bias": True, "tie_embeddings": False,
         "norm_eps": 1e-06, "rope_theta": 1000000.0,
         "kv_dtype": "bfloat16"}
CONFIGS = {
    "tiny-q4": {"model": MODEL,
                "weights": {"projections": "q4", "group": 32,
                            "dtype": "bfloat16"},
                "engine": {"kind": "streaming_resident", "ctx": 128,
                           "cache_dtype": "bfloat16"}},
    "tiny-bf16": {"model": MODEL,
                  "weights": {"projections": "bfloat16",
                              "dtype": "bfloat16"},
                  "engine": {"kind": "paged", "ctx": 128,
                             "cache_dtype": "bfloat16", "page_tokens": 8,
                             "prefill_chunk": 16, "offload": False}}}
TRAFFIC = {
    "chat1": {"loop": "closed", "slots": 1, "prompt_len": [8, 32],
              "answer_len": [4, 12], "requests_per_s": 4.0,
              "schedule_seed": 1, "check_tokens": 120,
              "check_ref_tokens": 2000},
    "chat-poisson": {"loop": "open", "slots": 4, "rate_per_s": 6.0,
                     "prompt_len": [8, 48], "answer_len": [4, 16],
                     "schedule_seed": 1, "check_tokens": 150,
                     "check_ref_tokens": 2000}}
CELLS = {"tiny-q4.chat1": ("tiny-q4", "chat1"),
         "tiny-bf16.chat-poisson": ("tiny-bf16", "chat-poisson")}
#: the tiny cells' limit, from 6 seeds a cell on the CPU: the program's
#: widest gap read 0-0.050, the fp8 control's 0.187-0.613
LIMIT = 0.1


def write_tree(root: Path, limit: float = LIMIT) -> Path:
    """A BENCHMARK.json and its configs/, traffic/ and limits/ under
    ``root`` (the metrics are the benchmark's own); returns the bench
    directory."""
    real = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCHMARK.json").read_text())
    bench = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    for name, conf in CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(conf))
    for name, mix in TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec = {**real, "configs": [], "workloads": []}
    for name in CONFIGS:
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "test"})
    for cell, (conf, mix) in CELLS.items():
        spec["workloads"].append({"name": cell, "config": conf,
                                  "traffic": mix, "chips": 1, "why": "test"})
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps({"logit_gap": limit}))
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def run(root: Path, cell: str, *, seed: int = 7, seconds: float = 1.0,
        hooks=None) -> dict:
    """One untraced run of a tiny cell on the CPU."""
    import torch

    from . import harness

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(root, cell, seed, seconds, False,
                                t_proc=time.perf_counter(), device="cpu",
                                hooks=hooks, bench=root / "portbench")
    finally:
        torch.set_num_threads(n)
