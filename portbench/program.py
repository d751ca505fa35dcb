"""The system under test: the port ``repro_torch``, built from a
configuration file and the benchmark's weights through its public entry
points (``runtime.kvcache.make_paged_engine``, and
``runtime.streaming.make_streaming_engine`` over a
``runtime.paramstore.ResidentSource``). This is the one module of the
benchmark besides ``run.py`` that imports the port."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.quant.grouped import QuantizedTensor
from repro_torch.runtime.kvcache import make_paged_engine
from repro_torch.runtime.paramstore import ResidentSource
from repro_torch.runtime.streaming import make_streaming_engine

from .weights import PROJ

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(m: dict) -> ModelConfig:
    return ModelConfig(**m)


def _leaf(w: dict, name: str, m: dict):
    v = w[name]
    if not isinstance(v, dict):
        return v
    L, Kh, N = v["packed"].shape
    return QuantizedTensor(v["packed"], v["scale"], 4, int(v["group"]),
                           (L, 2 * Kh, N))


def _blocks_tree(w: dict, m: dict) -> dict:
    p = {k: _leaf(w, k, m) for k in PROJ}
    return {"attn_norm": w["attn_norm"], "ffn_norm": w["ffn_norm"],
            "attn": {"wq": p["wq"], "wk": p["wk"], "wv": p["wv"],
                     "wo": p["wo"], "bq": w["bq"], "bk": w["bk"],
                     "bv": w["bv"]},
            "ffn": {"w_gate": p["w_gate"], "w_up": p["w_up"],
                    "w_down": p["w_down"]}}


def dense_model(w: dict, m: dict) -> M.DenseModel:
    """The weights as the port's ``DenseModel`` (every leaf a view of the
    benchmark's stacked tensors)."""
    blocks = []
    for i in range(m["n_layers"]):
        attn = M.Attention(w["wq"][i], w["wk"][i], w["wv"][i], w["wo"][i],
                           w["bq"][i], w["bk"][i], w["bv"][i])
        ffn = M.GLU(w["w_gate"][i], w["w_up"][i], w["w_down"][i])
        blocks.append(M.DenseBlock(w["attn_norm"][i], attn,
                                   w["ffn_norm"][i], ffn))
    return M.DenseModel(w["embed"], w["final_norm"], blocks, w["unembed"])


def build(conf: dict, mix: dict, w: dict, device
          ) -> Tuple[object, dict, Callable, Optional[object]]:
    """(engine, cache, close, paged KV manager or None) for a
    configuration file and a mix."""
    m, e = conf["model"], conf["engine"]
    cfg = model_config(m)
    dtype = _DTYPES[e["cache_dtype"]]
    slots = int(mix["slots"])
    if e["kind"] == "streaming_resident":
        src = ResidentSource({"embed": w["embed"], "unembed": w["unembed"],
                              "final_norm": w["final_norm"],
                              "blocks": _blocks_tree(w, m)})
        eng = make_streaming_engine(src, cfg, slots, int(e["ctx"]),
                                    cache_dtype=dtype, device=device)
        cache = M.init_cache(cfg, slots, int(e["ctx"]), dtype=dtype,
                             device=device)
        return eng, cache, (lambda: None), None
    if e["kind"] == "paged":
        pt = int(e["page_tokens"])
        n_pages = slots * (-(-int(e["ctx"]) // pt)) + 1     # + the sink
        eng, kv = make_paged_engine(
            dense_model(w, m), cfg, slots, int(e["ctx"]), n_pages=n_pages,
            page_tokens=pt, cache_dtype=dtype, offload=bool(e["offload"]),
            prefill_chunk=e.get("prefill_chunk"), device=device)
        return eng, kv.init_cache(), kv.close, kv
    raise ValueError(f"unknown engine kind {e['kind']!r}")
