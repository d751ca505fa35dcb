"""The GSPMD layer across ranks: the JAX package's ``gspmd_decode_step``
and ``gspmd_prefill`` (``repro.runtime.serve``) and the forward of its
``jitted_train_step`` (``repro.runtime.train``), with the partitioner's
work done by hand over the rank world of ``launch.mesh``.

The JAX package jits ``decode_step``/``prefill``/``make_train_step``
under ``sharding.param_shardings`` (FSDP: weights over "data" and
"model") and ``cache_shardings`` and lets GSPMD place the collectives.
Here each rank of a ``pods x n_stages x tp`` world (``RankLayout``: its
"data" axis is the ring of its member, its "model" axis its stage's
group, its "pod" axis the ranks of its stage and member across pods)
holds its ``sharding.local_shard`` of every parameter leaf and cache leaf
under the same sanitized specs, and one layer runs as:

  * the layer's leaves gathered over "data" (``collectives.fsdp_gather``:
    under autograd the gradient is reduce-scattered back to the shard),
    freed when the layer is done;
  * the layer tensor-parallel over "model", by each leaf's sanitized spec
    (a reduced config drops axes a full width keeps, so nothing assumes
    the unsanitized rule): a column-parallel weight (``wq``/``wk``/``wv``,
    ``w_gate``/``w_up``, ``in_proj``, ``w_x``/``w_y``) multiplies the
    member's columns, a row-parallel one (``wo``, ``w_down``,
    ``out_proj``, ``w_out``) its rows, summed over "model"; experts split
    over "model" where ``sharding.moe_ep`` holds, else each expert's d_ff;
  * attention by the cache's layout (``sharding.cache_spec``): kv heads
    over "model" -- each member attends with its heads (B5,
    ``layers._dense_attention``); the sequence over "model" -- q, k and v
    gathered whole, each member attends over its lines (B5 with its
    stats), the members merge (``serve.seq_attention``, the ring's merge;
    MLA's latent: ``serve.mla_seq_attention``) and the new line is written
    by the member whose lines hold it; neither -- replicated;
  * the hybrid family's RG-LRU channel-parallel: ``w_x``/``w_y`` by
    column, ``w_out`` by row, the member slicing its channels of
    ``conv_w``, ``gate_i``, ``gate_r`` and ``lambda`` (spec ``()``) and of
    the ``h``/``conv`` state (split on ``w``);
  * the ssm family's mixer between its two projections repeated on every
    member over its state gathered whole, the member keeping its part
    (B6 in a prefill from the zero state);
  * whisper's decoder heads over "model" (``cross_k``/``cross_v`` are
    replicated over "model": a member reads its heads), its encoder run
    in the prefill on the rank's frames.

The embedding is vocab-sharded over "model" (``embed`` ("model",
"data")): a member looks up the tokens in its shard and the members sum;
the logits are the member's vocab shard (``unembed`` ("data", "model"),
or the tied embedding), the greedy token taken over the shards
(``serve.rank_greedy``). The batch goes over ``sharding.batch_axes``
where it divides (sanitized as the JAX tokens' spec is); where it does
not, it is replicated over "data" (B = 1 and 2 over 4 stages): every data
rank then computes the whole batch, to equal results.

A replicated tensor that a member reads only part of enters through
``collectives.tp_enter`` and a product gathered whole for repeated
computation through ``tp_gather``, so the same forward differentiates to
the gradient of the one loss (``runtime.train.RankTrainStep``). Serving
runs under ``no_grad``, where both are identities and gathers.

On the card the path launches B5 (``flash_verify``, heads split), B5
stats (``flash_verify_stats``, sequence split) and B6 (``ssd_scan``);
the plain versions serve CPU tensors. ``GspmdModel`` is a rank's model;
``GspmdDecodeStep``/``GspmdPrefill`` its serve steps; ``rank_gspmd_job``
a ``RankWorld`` job that prefills (or takes a one-device cache) and
decodes. The dry run (``launch.dryrun``) runs the same objects on
``meta`` tensors over ``launch.mesh.dry_rank_layout``.
"""
from __future__ import annotations

import dataclasses
import re
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import layers as ll
from ..models import model as M
from ..models.model import MLA_KEYS
from . import sharding as S
from .collectives import (Axis, fsdp_gather, gather_cat, psum, tp_enter,
                          tp_gather, tp_sum)
from .serve import (_Shard, gather_logits, mla_seq_attention, rank_greedy,
                    seq_attention)
from .telemetry import clock, resolve_tracer

Spec = Tuple[Any, ...]


# --------------------------------------------------------------------------- #
#  a rank's part of the parameters and of the cache
# --------------------------------------------------------------------------- #

def _check_plain(tree) -> None:
    for path, leaf in S.flatten_with_path(tree):
        if path.endswith(".packed") or path.endswith(".scale"):
            raise ValueError(f"{path}: the GSPMD layer takes plain weights "
                             f"(a q4 store serves through the ring)")


def param_specs(cfg: ModelConfig, mesh, tree, style: str = "fsdp"
                ) -> Dict[str, Spec]:
    """{path: sanitized spec} of every leaf of the one-device parameter
    tree (``bridge.tree_from_params``' layout) under ``style``."""
    return {p: sh.spec for p, sh in
            S.param_shardings(cfg, mesh, tree, style=style).items()}


def cache_specs(cfg: ModelConfig, mesh, cache) -> Dict[str, Spec]:
    return {p: sh.spec for p, sh in
            S.cache_shardings(cfg, mesh, cache).items()}


def _cut(t: torch.Tensor, spec: Spec, layout, device, dtype=None
         ) -> torch.Tensor:
    """A copy of the rank's part of ``t`` on ``device`` (the whole tree
    can be freed), float parts in ``dtype`` if given."""
    part = S.local_shard(t, spec, layout.mesh, layout.coords)
    if dtype is None or not part.is_floating_point():
        dtype = part.dtype
    out = torch.empty(part.shape, dtype=dtype, device=device)
    out.copy_(part)
    return out


def gspmd_params(tree, cfg: ModelConfig, layout, *, style: str = "fsdp",
                 device=None, dtype=None) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, Spec]]:
    """Rank ``layout``'s part of the one-device parameter tree ``tree``
    (nested dicts of tensors, the JAX layout): ({path: its
    ``local_shard`` under ``param_shardings(style)``, on ``device``, in
    ``dtype`` if given}, {path: the sanitized spec})."""
    _check_plain(tree)
    device = torch.device(device or layout.device)
    specs = param_specs(cfg, layout.mesh, tree, style)
    return ({path: _cut(leaf, specs[path], layout, device, dtype)
             for path, leaf in S.flatten_with_path(tree)}, specs)


def unflatten(flat: Dict[str, Any]) -> Dict:
    """{path: leaf} (``sharding.flatten_with_path``'s) back to the nested
    tree."""
    tree: Dict = {}
    for path, t in flat.items():
        keys = re.findall(r"\['([^']+)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree


def gspmd_cache(cache: Dict, cfg: ModelConfig, layout, *, device=None
                ) -> Dict:
    """Rank ``layout``'s part of a one-device cache (``init_cache``'s
    tree, e.g. a prefill's): every leaf's ``local_shard`` under
    ``cache_shardings``, on ``device``, in the cache's layout (``len``,
    spec ``()``, whole)."""
    device = torch.device(device or layout.device)
    specs = cache_specs(cfg, layout.mesh, cache)
    return unflatten({p: _cut(t, specs[p], layout, device)
                       for p, t in S.flatten_with_path(cache)})


def gspmd_init_cache(cfg: ModelConfig, layout, batch: int, max_len: int, *,
                     dtype=torch.float32, device=None) -> Dict:
    """Rank ``layout``'s part of ``init_cache``'s zeros, made at the
    part's shapes without the whole cache."""
    device = torch.device(device or layout.device)
    like = M.init_cache(cfg, batch, max_len, dtype=dtype, device="meta")
    specs = cache_specs(cfg, layout.mesh, like)
    flat = {}
    for p, t in S.flatten_with_path(like):
        part = S.local_shard(t, specs[p], layout.mesh, layout.coords)
        flat[p] = torch.zeros(part.shape, dtype=t.dtype, device=device)
    return unflatten(flat)


def batch_entry(mesh, B: int):
    """The sanitized spec entry of the batch dimension: the batch axes
    that divide ``B`` (None: replicated)."""
    return S.sanitize((S.batch_axes(mesh),), (B,), mesh)[0]


def batch_rows(layout, B: int) -> slice:
    """The rows of a global batch of ``B`` that rank ``layout`` holds."""
    e = batch_entry(layout.mesh, B)
    n = S.axis_size(layout.mesh, e)
    i = S.shard_index(e, layout.mesh, layout.coords)
    return slice(i * (B // n), (i + 1) * (B // n))


def tree_nbytes(flat: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in flat.values())


# --------------------------------------------------------------------------- #
#  one layer on a rank
# --------------------------------------------------------------------------- #

def _mine(t: torch.Tensor, ax: Axis, dim: int = -1) -> torch.Tensor:
    """The member's chunk of a replicated tensor along ``dim``."""
    n = t.shape[dim] // ax.size
    return tp_enter(t, ax).narrow(dim, ax.index * n, n)


def _heads_split(cfg: ModelConfig, ax: Axis) -> bool:
    """Attention heads over "model": where the kv heads divide (the
    cache's kv-head split, ``sharding.cache_spec``)."""
    return ax.size > 1 and cfg.kv_heads > 0 and cfg.kv_heads % ax.size == 0


def _local_cfg(cfg: ModelConfig, ax: Axis) -> ModelConfig:
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // ax.size,
                               kv_heads=cfg.kv_heads // ax.size)


#: the projections a stationary layer multiplies where they lie
#: (``GspmdModel._mm``); every other leaf is gathered over "data"
_STATIONARY = {(sub, k) for sub in ("attn", "cross")
               for k in ("wq", "wk", "wv", "wo")} | {
    ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down"),
    ("ssd", "in_proj"), ("ssd", "out_proj")}


@dataclasses.dataclass
class _Layer:
    """One layer's leaves on a rank (``p``, the block's tree as
    attributes): gathered over "data", but for a stationary layer's
    projections, which keep their "data" split (``dsplit[(key, ...)]``:
    the dimension, None where the leaf is whole over "data"); ``split``:
    each leaf's model-split dimension (None where it is whole)."""
    p: Any
    split: Dict[Tuple[str, ...], Optional[int]]
    dsplit: Dict[Tuple[str, ...], Optional[int]]

    def s(self, *keys) -> bool:
        return self.split.get(tuple(keys)) is not None


def _ns(tree):
    if isinstance(tree, dict):
        return types.SimpleNamespace(**{k: _ns(v) for k, v in tree.items()})
    return tree


def _prompt_lines(c: Dict, names, new: Dict[str, torch.Tensor],
                  sh: _Shard, window: Optional[int]) -> None:
    """A prefill's cache lines ``new[name]`` (B, S, ...) written where
    they fall in this member's lines (``attn_block``'s rolling-buffer
    rule: the last Smax tokens at slot t % Smax)."""
    Smax = sh.s_len * sh.model.size
    for name in names:
        t = new[name]
        S_ = t.shape[1]
        if window is not None and Smax <= S_:
            t = torch.roll(t[:, -Smax:], S_ % Smax, dims=1)
        else:
            t = t[:, :Smax]
        lo, hi = sh.s_start, min(sh.s_start + sh.s_len, t.shape[1])
        if hi > lo:
            c[name][:, :hi - lo] = t[:, lo:hi].to(c[name].dtype)


class GspmdModel:
    """Rank ``layout``'s model under the GSPMD layout: ``params`` and
    ``specs`` are ``gspmd_params``' (the parameters under ``style``
    "fsdp" or "zero1": a zero1 rank holds its tensor-parallel part whole
    over "data", so nothing is gathered). ``forward`` runs prefill,
    decode or the training forward on the rank's batch rows."""

    def __init__(self, cfg: ModelConfig, layout, params: Dict[str, Any],
                 specs: Dict[str, Spec], *, cache_specs: Optional[Dict] = None,
                 offsets: bool = True, probe=None):
        self.cfg, self.lay = cfg, layout
        self.params, self.specs = params, specs
        self.cspecs = cache_specs or {}
        self.offsets, self.probe = offsets, probe
        self.ax = layout.model
        #: set by ``forward``: the batch is whole on every data rank, so
        #: the projections stay where they lie (see ``stationary``)
        self.stationary = False

    # ---- products -------------------------------------------------------
    def _mm(self, x: torch.Tensor, w, L: "_Layer", keys) -> torch.Tensor:
        """``x @ w`` for a leaf that may keep its "data" split (a
        stationary layer): split on the contraction, this data rank
        multiplies its rows by its slice of ``x`` and the data ranks sum;
        split on the output, the data ranks' columns are joined."""
        d = L.dsplit.get(tuple(keys))
        if d is None:
            return ll.qmm(x, w)
        dax = self.lay.ring
        if d == 0:
            n = w.shape[0]
            return psum(ll.qmm(x.narrow(-1, dax.index * n, n), w), dax)
        return gather_cat(ll.qmm(x, w), dax, -1)

    def _col(self, x, w, L, keys) -> torch.Tensor:
        """``x @ w``, the whole output on every member: a column-parallel
        weight multiplies the member's columns and the parts are
        gathered."""
        if not L.s(*keys):
            return self._mm(x, w, L, keys)
        ax = self.ax
        return tp_gather(self._mm(tp_enter(x, ax), w, L, keys), ax, -1)

    def _row(self, y, w, L, keys) -> torch.Tensor:
        """``y @ w`` for a whole ``y``: a row-parallel weight multiplies
        the member's columns of ``y`` and the members sum."""
        if not L.s(*keys):
            return self._mm(y, w, L, keys)
        ax = self.ax
        return tp_sum(self._mm(_mine(y, ax), w, L, keys), ax)

    def _glu(self, L, sub: str, x) -> torch.Tensor:
        """The GLU FFN (``layers.glu_ffn``), d_ff split over "model" where
        its spec splits it."""
        p = getattr(L.p, sub)
        tp = self.ax if L.s(sub, "w_gate") else None
        xe = x if tp is None else tp_enter(x, tp)
        h = ll.swish(self._mm(xe, p.w_gate, L, (sub, "w_gate"))) \
            * self._mm(xe, p.w_up, L, (sub, "w_up"))
        y = self._mm(h, p.w_down, L, (sub, "w_down"))
        return y if tp is None else tp_sum(y, tp)

    # ---- leaves ---------------------------------------------------------
    def _gathered(self, path: str, t: torch.Tensor, spec: Spec
                  ) -> torch.Tensor:
        for dim, e in enumerate(spec):
            if e is not None and "data" in S._axes(e):
                t = fsdp_gather(t, self.lay.ring, dim)
        return t

    def head(self, name: str) -> Optional[torch.Tensor]:
        path = f"['{name}']"
        if path not in self.params:
            return None
        return self._gathered(path, self.params[path], self.specs[path])

    def _head_split(self, name: str) -> Optional[int]:
        spec = self.specs.get(f"['{name}']", ())
        for dim, e in enumerate(spec):
            if e is not None and "model" in S._axes(e):
                return dim
        return None

    def layer(self, prefix: str, i: int) -> _Layer:
        """Row ``i`` of every leaf under ``prefix`` (a stacked block tree,
        e.g. ``['blocks']``), gathered over "data"."""
        tree: Dict = {}
        split: Dict[Tuple[str, ...], Optional[int]] = {}
        dsplit: Dict[Tuple[str, ...], Optional[int]] = {}
        for path, t in self.params.items():
            if not path.startswith(prefix + "["):
                continue
            spec = tuple(self.specs[path])[1:]
            keys = tuple(re.findall(r"\['([^']+)'\]", path[len(prefix):]))
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            if self.stationary and keys[-2:] in _STATIONARY:
                node[keys[-1]] = t[i]
                dsplit[keys] = next((d for d, e in enumerate(spec)
                                     if e is not None
                                     and "data" in S._axes(e)), None)
            else:
                node[keys[-1]] = self._gathered(path, t[i], spec)
            split[keys] = next((d for d, e in enumerate(spec)
                                if e is not None
                                and "model" in S._axes(e)), None)
        return _Layer(_ns(tree), split, dsplit)

    def _cache_shard(self, prefix: str, name: str, c: Dict) -> _Shard:
        """The member's place in the sequence lines of cache leaf
        ``prefix + [name]`` (a size-1 axis where the lines are whole)."""
        spec = tuple(self.cspecs.get(f"{prefix}['{name}']", ()))
        s_len = c[name].shape[1]
        if len(spec) > 2 and spec[2] is not None:
            ax = self.ax
            return _Shard(ax, ax.index * s_len, s_len, self.offsets,
                          self.probe)
        one = Axis("model", None, (self.lay.rank,), 0, dry=self.ax.dry)
        return _Shard(one, 0, s_len, True, self.probe)

    # ---- mixers ---------------------------------------------------------
    def _gqa(self, L: _Layer, sub: str, h, pos, c, cprefix, *,
             decode: bool, causal: bool = True):
        cfg, ax = self.cfg, self.ax
        p = getattr(L.p, sub)
        B, T, _ = h.shape
        hd = cfg.head_dim
        if _heads_split(cfg, ax):
            # the member's heads: its columns of wq/wk/wv, its rows of wo
            lcfg = _local_cfg(cfg, ax)
            xe = tp_enter(h, ax)
            q, k, v = (self._mm(xe, getattr(p, n), L, (sub, n))
                       for n in ("wq", "wk", "wv"))
            if cfg.qkv_bias:
                q, k, v = (q + _mine(p.bq, ax), k + _mine(p.bk, ax),
                           v + _mine(p.bv, ax))
            q = q.reshape(B, T, lcfg.n_heads, hd)
            k = k.reshape(B, T, lcfg.kv_heads, hd)
            v = v.reshape(B, T, lcfg.kv_heads, hd)
            if cfg.use_rope:
                q, k = ll.rotate(q, pos, cfg), ll.rotate(k, pos, cfg)
            out, _ = ll.attend(lcfg, q, k, v, cache=c, decode=decode,
                               causal=causal)
            return tp_sum(self._mm(out.reshape(B, T, -1), p.wo, L,
                                   (sub, "wo")), ax)
        H, hk = cfg.n_heads, cfg.kv_heads
        q = self._col(h, p.wq, L, (sub, "wq"))
        k = self._col(h, p.wk, L, (sub, "wk"))
        v = self._col(h, p.wv, L, (sub, "wv"))
        if cfg.qkv_bias:
            q, k, v = q + p.bq, k + p.bk, v + p.bv
        q, k, v = (q.reshape(B, T, H, hd), k.reshape(B, T, hk, hd),
                   v.reshape(B, T, hk, hd))
        if cfg.use_rope:
            q, k = ll.rotate(q, pos, cfg), ll.rotate(k, pos, cfg)
        if decode:
            out = seq_attention(cfg, q, k, v, c, c["len"],
                                self._cache_shard(cprefix, "k", c))
        else:
            out = ll.chunked_causal_attention(
                q, k, v, window=cfg.attn_window) if causal \
                else ll._full_attention(q, k, v)
            if c is not None:
                self._write_kv(c, cprefix, k, v)
        return self._row(out.reshape(B, T, -1).to(h.dtype), p.wo, L,
                         (sub, "wo"))

    def _write_kv(self, c, cprefix, k, v) -> None:
        sh = self._cache_shard(cprefix, "k", c)
        if "k_scale" in c:
            kq, ksc = ll.quantize_kv(k)
            vq, vsc = ll.quantize_kv(v)
            new = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
        else:
            new = {"k": k, "v": v}
        _prompt_lines(c, list(new), new, sh, self.cfg.attn_window)

    def _mla(self, L: _Layer, h, pos, c, cprefix, *, decode: bool):
        cfg, ax = self.cfg, self.ax
        p = L.p.attn
        # the absorbed form folds W_UK and W_UV a head at a time: the
        # projections are gathered whole and the attention repeated
        full = types.SimpleNamespace(**{
            k: tp_gather(getattr(p, k), ax, -1) if L.s("attn", k)
            else getattr(p, k) for k in MLA_KEYS if k != "wo"})
        B, T, _ = h.shape
        H, r_kv = cfg.n_heads, cfg.kv_lora_rank
        q_nope, q_rope, latent, lat_cat = ll.mla_project(full, cfg, h, pos)
        if decode:
            sh = self._cache_shard(cprefix, "latent", c)
            o_lat = mla_seq_attention(cfg, full, q_nope, q_rope, lat_cat, c,
                                      c["len"], sh, h.dtype)
            wv = full.wv_b.reshape(r_kv, H, cfg.v_head_dim)
            out = ll._einsum("bthr,rhv->bthv", o_lat.to(h.dtype),
                             wv).reshape(B, T, -1)
        else:
            out = ll.mla_prefill_attention(full, cfg, q_nope, q_rope, latent,
                                           lat_cat)
            if c is not None:
                _prompt_lines(c, ["latent"], {"latent": lat_cat},
                              self._cache_shard(cprefix, "latent", c), None)
        return self._row(out, p.wo, L, ("attn", "wo"))

    def _ffn(self, L: _Layer, x, *, decode: bool):
        cfg, ax = self.cfg, self.ax
        if cfg.n_experts:
            d = L.split.get(("moe", "w_gate"))
            return ll.moe_ffn(L.p.moe, cfg, x, lossless=decode,
                              tp=ax if d is not None else None, ep=d == 0)
        return self._glu(L, "ffn", x)

    def _whole_state(self, c: Dict, cprefix: str, names) -> Dict:
        """Cache leaves split over "model" gathered whole (the mixers
        every member repeats), the others as they are."""
        out = {}
        for n in names:
            spec = tuple(self.cspecs.get(f"{cprefix}['{n}']", ()))[1:]
            d = next((i for i, e in enumerate(spec)
                      if e is not None and "model" in S._axes(e)), None)
            out[n] = (c[n] if d is None
                      else gather_cat(c[n], self.ax, d), d)
        return out

    def _ssd(self, L: _Layer, x, c, cprefix, *, decode: bool, fresh: bool):
        cfg, ax = self.cfg, self.ax
        p = L.p.ssd
        h = ll.rms_norm(x, L.p.norm, cfg.norm_eps)
        zx = self._col(h, p.in_proj, L, ("ssd", "in_proj"))
        whole = None
        if c is not None:
            st = self._whole_state(c, cprefix, ("conv", "state"))
            whole = {n: t for n, (t, _) in st.items()}
        y = ll.ssd_mix(p, cfg, zx, cache=whole, decode=decode, fresh=fresh,
                       dtype=h.dtype)
        if c is not None:
            for n, (t, d) in st.items():
                if d is not None:
                    k = c[n].shape[d]
                    c[n].copy_(t.narrow(d, ax.index * k, k))
        return x + self._row(y, p.out_proj, L, ("ssd", "out_proj"))

    def _rglru(self, L: _Layer, x, c, *, decode: bool):
        cfg, ax = self.cfg, self.ax
        r = L.p.rglru
        h = ll.rms_norm(x, L.p.mix_norm, cfg.norm_eps)
        if L.s("rglru", "w_x"):
            lp = types.SimpleNamespace(
                w_x=r.w_x, w_y=r.w_y, w_out=r.w_out,
                conv_w=_mine(r.conv_w, ax), gate_i=_mine(r.gate_i, ax),
                gate_r=_mine(r.gate_r, ax),
                **{"lambda": _mine(getattr(r, "lambda"), ax)})
            y = tp_sum(ll.rglru_block(lp, cfg, tp_enter(h, ax), cache=c,
                                      decode=decode), ax)
        else:
            y = ll.rglru_block(r, cfg, h, cache=c, decode=decode)
        x = x + y
        return x + self._glu(L, "ffn", ll.rms_norm(x, L.p.ffn_norm,
                                                   cfg.norm_eps))

    def _dense(self, L: _Layer, x, pos, c, cprefix, *, decode: bool):
        cfg = self.cfg
        h = ll.rms_norm(x, L.p.attn_norm, cfg.norm_eps)
        if cfg.mla:
            x = x + self._mla(L, h, pos, c, cprefix, decode=decode)
        else:
            x = x + self._gqa(L, "attn", h, pos, c, cprefix, decode=decode)
        return x + self._ffn(L, ll.rms_norm(x, L.p.ffn_norm, cfg.norm_eps),
                             decode=decode)

    # ---- head -----------------------------------------------------------
    def _data_dim(self, name: str) -> Optional[int]:
        """The dimension of head leaf ``name`` split over "data" where a
        stationary step keeps it so (None: gathered whole)."""
        if not self.stationary:
            return None
        spec = self.specs.get(f"['{name}']", ())
        return next((d for d, e in enumerate(spec)
                     if e is not None and "data" in S._axes(e)), None)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' embeddings (B, T, d): the vocab-sharded rows looked
        up in the member's shard and summed over "model"; a stationary
        step looks up its columns and joins the data ranks' columns."""
        d = self._data_dim("embed")
        E = self.params["['embed']"] if d is not None else self.head("embed")
        if self._head_split("embed") != 0:
            emb = E[tokens.long()]
        else:
            v_loc, off = E.shape[0], self.ax.index * E.shape[0]
            tok = tokens.long()
            ok = (tok >= off) & (tok < off + v_loc)
            emb = E[(tok - off).clamp(0, v_loc - 1)]
            emb = tp_sum(torch.where(ok[..., None], emb,
                                     torch.zeros_like(emb)), self.ax)
        return emb if d is None else gather_cat(emb, self.lay.ring, -1)

    def vocab_split(self) -> bool:
        if "['unembed']" in self.params:
            return self._head_split("unembed") == 1
        return self._head_split("embed") == 0

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """The member's vocab shard of the logits (the whole vocabulary
        where the head is not split); a stationary step multiplies its
        slice of ``x`` by its rows and the data ranks sum."""
        tied = "['unembed']" not in self.params
        name = "embed" if tied else "unembed"
        d = self._data_dim(name)
        if d is None:
            W = self.head(name)
            W = W.T if tied else W
            if self.vocab_split():
                x = tp_enter(x, self.ax)
            return ll._matmul(x, W)
        W = self.params[f"['{name}']"]
        W = W.T if tied else W                     # (d / data, V / model)
        dax = self.lay.ring
        n = W.shape[0]
        return psum(ll._matmul(x.narrow(-1, dax.index * n, n), W), dax)

    # ---- the stack ------------------------------------------------------
    def _layers(self):
        """(param prefix, row, cache prefix, kind) of each layer in
        execution order."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            G, T = M.hybrid_layout(cfg)
            P = len(cfg.block_pattern)
            for i in range(G * P):
                pre = f"['groups']['b{i % P}']"
                yield pre, i // P, pre, cfg.block_pattern[i % P]
            for j in range(T):
                yield "['tail']", j, "['tail']", cfg.block_pattern[0]
            return
        if cfg.family == "audio":
            for i in range(cfg.n_layers):
                yield "['dec_blocks']", i, "['layers']", "dec"
            return
        kind = "ssd" if cfg.family == "ssm" else "attn"
        for i in range(cfg.n_layers):
            yield "['blocks']", i, "['layers']", kind

    def _layer_cache(self, cache: Optional[Dict], cprefix: str, j: int,
                     ln) -> Optional[Dict]:
        if cache is None:
            return None
        keys = re.findall(r"\['([^']+)'\]", cprefix)
        tree = cache
        for k in keys:
            tree = tree[k]
        c = {n: a[j] for n, a in tree.items()}
        c["len"] = ln
        return c

    def _seen(self, name, t) -> None:
        if self.probe is not None:
            self.probe(name, t)

    def forward(self, tokens: torch.Tensor, cache: Optional[Dict] = None,
                *, decode: bool = False, embeds=None, fresh: bool = True,
                last_only: bool = False, stationary: bool = False
                ) -> torch.Tensor:
        """The rank's batch rows ``tokens`` (B_loc, T) through the stack:
        decode over the rank's cache part (``len``: this step's lengths,
        the rows' own), a prefill writing it (``fresh``: the cache holds
        no token yet, the ssm scan starts from the zero state: a caller
        that knows it says so, the dry run included, where a length
        cannot be read), or (no cache) the training forward. Returns the
        member's vocab shard of the logits (the last position's with
        ``last_only``). ``stationary`` (serving only, where the rows are
        whole on every data rank: ``stationary``): the projections and the
        head stay where they lie, split over "data", and the data ranks
        sum or join their parts of each product."""
        cfg = self.cfg
        self.stationary = stationary
        if cfg.family == "audio":
            return self._whisper(tokens, cache, decode=decode, embeds=embeds,
                                 last_only=last_only)
        B, T = tokens.shape
        ln = None if cache is None else cache["len"]
        x = self.embed(tokens)
        if embeds is not None:
            x = torch.cat([embeds.to(x.dtype), x], 1)
        if decode:
            pos = M.default_positions(cfg, B, T, ln)
        else:
            pos = M.default_positions(cfg, B, x.shape[1]).to(x.device)
        for pre, i, cpre, kind in self._layers():
            L = self.layer(pre, i)
            c = self._layer_cache(cache, cpre, i, ln)
            if kind == "ssd":
                x = self._ssd(L, x, c, cpre, decode=decode, fresh=fresh)
            elif kind == "rglru":
                x = self._rglru(L, x, c, decode=decode)
            else:
                x = self._dense(L, x, pos, c, cpre, decode=decode)
            self._seen("x", x)
            del L
        if last_only:
            x = x[:, -1:]
        x = ll.rms_norm(x, self.head("final_norm"), cfg.norm_eps)
        self._seen("hidden", x)
        return self.unembed(x)

    # ---- whisper --------------------------------------------------------
    def _cross(self, L: _Layer, h, pos, ck, cv):
        cfg, ax = self.cfg, self.ax
        p = L.p.cross
        B, T, _ = h.shape
        if _heads_split(cfg, ax):
            q = self._mm(tp_enter(h, ax), p.wq, L, ("cross", "wq"))
            if cfg.qkv_bias:
                q = q + _mine(p.bq, ax)
            q = q.reshape(B, T, cfg.n_heads // ax.size, cfg.head_dim)
            out = ll._full_attention(q, _mine(ck, ax, 2), _mine(cv, ax, 2))
            return tp_sum(self._mm(out.reshape(B, T, -1), p.wo, L,
                                   ("cross", "wo")), ax)
        q = self._col(h, p.wq, L, ("cross", "wq"))
        if cfg.qkv_bias:
            q = q + p.bq
        q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
        out = ll._full_attention(q, ck, cv)
        return self._row(out.reshape(B, T, -1), p.wo, L, ("cross", "wo"))

    def _cross_kv(self, L: _Layer, enc_out):
        cfg, ax = self.cfg, self.ax
        p = L.p.cross
        B, F, _ = enc_out.shape
        k = self._col(enc_out, p.wk, L, ("cross", "wk"))
        v = self._col(enc_out, p.wv, L, ("cross", "wv"))
        return (k.reshape(B, F, cfg.kv_heads, cfg.head_dim),
                v.reshape(B, F, cfg.kv_heads, cfg.head_dim))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder on the rank's frames (B_loc, F, d)."""
        cfg = self.cfg
        B, F, d = frames.shape
        x = frames + M.sinusoid_positions(F, d, frames.dtype,
                                          frames.device)[None]
        pos = M.default_positions(cfg, B, F).to(x.device)
        for i in range(cfg.n_layers):
            L = self.layer("['enc_blocks']", i)
            h = ll.rms_norm(x, L.p.attn_norm, cfg.norm_eps)
            x = x + self._gqa(L, "attn", h, pos, None, None, decode=False,
                              causal=False)
            x = x + self._ffn(L, ll.rms_norm(x, L.p.ffn_norm, cfg.norm_eps),
                              decode=False)
            del L
        return ll.rms_norm(x, self.head("enc_norm"), cfg.norm_eps)

    def _whisper(self, tokens, cache, *, decode, embeds, last_only):
        cfg = self.cfg
        B, T = tokens.shape
        x = self.embed(tokens)
        if decode:
            ln = cache["len"]
            S_tab = cfg.max_decode_len or cache["layers"]["k"].shape[2]
            table = M.sinusoid_positions(S_tab, cfg.d_model, x.dtype,
                                         x.device)
            x = x + table[torch.clamp(ln, max=S_tab - 1).long()][:, None]
            pos = ln[:, None]
        else:
            if embeds is None:
                raise ValueError(f"{cfg.name} encodes audio frames: pass "
                                 f"them as embeds")
            x = x + M.sinusoid_positions(T, cfg.d_model, x.dtype,
                                         x.device)[None]
            pos = M.default_positions(cfg, B, T).to(x.device)
            enc_out = self.encode(embeds.to(x.dtype))
            ln = None if cache is None else cache["len"]
        for i in range(cfg.n_layers):
            L = self.layer("['dec_blocks']", i)
            if decode:
                ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            else:
                ck, cv = self._cross_kv(L, enc_out)
                if cache is not None:
                    cache["cross_k"][i] = ck
                    cache["cross_v"][i] = cv
            c = self._layer_cache(cache, "['layers']", i, ln)
            h = ll.rms_norm(x, L.p.attn_norm, cfg.norm_eps)
            x = x + self._gqa(L, "attn", h, pos, c, "['layers']",
                              decode=decode)
            x = x + self._cross(L, ll.rms_norm(x, L.p.cross_norm,
                                               cfg.norm_eps), pos, ck, cv)
            x = x + self._glu(L, "ffn", ll.rms_norm(x, L.p.ffn_norm,
                                                    cfg.norm_eps))
            self._seen("x", x)
            del L
        if last_only:
            x = x[:, -1:]
        x = ll.rms_norm(x, self.head("final_norm"), cfg.norm_eps)
        self._seen("hidden", x)
        return self.unembed(x)


# --------------------------------------------------------------------------- #
#  the serve steps
# --------------------------------------------------------------------------- #

def stationary(layout, B: int) -> bool:
    """Whether a batch of ``B`` rows is whole on every data rank (the
    batch axes that divide it leave "data" out: B = 1 and 2 over 4
    stages). A serve step then keeps the weights where they lie: each
    data rank multiplies its slice of the activations by its rows of a
    projection and the data ranks sum (or join the columns it holds), so
    a step moves activations, not the whole model, over "data" -- the
    product GSPMD partitions for a batch it cannot split."""
    e = batch_entry(layout.mesh, B)
    return layout.ring.size > 1 and (e is None or "data" not in S._axes(e))


class GspmdDecodeStep:
    """``gspmd_decode_step`` on one rank: ``step(cache, tokens (B_loc,
    T)) -> (the member's vocab shard of the logits (B_loc, T, V/tp),
    cache)``, the rank's cache part written in place and its ``len`` (the
    whole batch's, spec ``()``) advanced. Every rank of the world calls
    it together; ``rows``: the rank's rows of the batch of ``B``."""

    def __init__(self, model: GspmdModel, rows: slice, B: int):
        self.model, self.rows = model, rows
        self.stationary = stationary(model.lay, B)

    @torch.no_grad()
    def __call__(self, cache: Dict, tokens: torch.Tensor):
        full = cache["len"]
        ln = full[self.rows]
        local = dict(cache, len=ln)
        logits = self.model.forward(tokens, local, decode=True,
                                    stationary=self.stationary)
        full.add_(tokens.shape[1])
        return logits, cache


class GspmdPrefill:
    """``gspmd_prefill`` on one rank: ``prefill(cache, tokens (B_loc, S),
    embeds=None) -> (the last position's vocab shard of the logits,
    cache)``, the prompt's lines written into the rank's cache part."""

    def __init__(self, model: GspmdModel, rows: slice, B: int):
        self.model, self.rows = model, rows
        self.stationary = stationary(model.lay, B)

    @torch.no_grad()
    def __call__(self, cache: Dict, tokens: torch.Tensor, embeds=None, *,
                 fresh: Optional[bool] = None):
        full = cache["len"]
        if fresh is None:
            fresh = not bool(full.any())
        local = dict(cache, len=full[self.rows])
        logits = self.model.forward(tokens, local, decode=False,
                                    embeds=embeds, fresh=fresh,
                                    last_only=True,
                                    stationary=self.stationary)
        n = tokens.shape[1]
        if embeds is not None and self.model.cfg.family != "audio":
            n += embeds.shape[1]
        full.add_(n)
        return logits, cache


def greedy(model: GspmdModel, logits: torch.Tensor) -> torch.Tensor:
    """Greedy tokens (B_loc, T) int32 from a rank's logits, equal on
    every member."""
    if model.vocab_split():
        return rank_greedy(logits, model.ax, model.cfg.vocab)
    return logits.float().argmax(-1).to(torch.int32)


def full_logits(model: GspmdModel, logits: torch.Tensor) -> torch.Tensor:
    if model.vocab_split():
        return gather_logits(logits, model.ax, model.cfg.vocab)
    return logits


def _load(x):
    if isinstance(x, str):
        return torch.load(x, map_location="cpu", mmap=True)
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_gspmd_job(ctx, *, cfg: ModelConfig, n_stages: int, tp: int,
                   pods: int = 1, params, steps: int, prompts=None,
                   embeds=None, cache=None, first=None, ctx_len: int = 0,
                   dtype: str = "float32", keep_logits: bool = False,
                   return_cache: bool = False, trace: bool = False,
                   offsets: bool = True, check_replicated: bool = False,
                   fail_rank: Optional[int] = None) -> Dict:
    """One rank's run of the GSPMD layer (a ``launch.mesh.RankWorld`` job;
    every rank of a ``pods x n_stages x tp`` world runs it): its part of
    the one-device parameter tree ``params`` (a dict, or a ``torch.save``
    file, read mapped; ``gspmd_params``, fsdp) cast to ``dtype``; then
    either a GSPMD prefill of ``prompts`` (B, S) (``embeds``: the
    frontend's (B, F, d), vlm patches or whisper's frames) into a fresh
    cache part of ``ctx_len`` lines, or the rank's part of the one-device
    cache ``cache`` (a dict or a file; ``gspmd_cache``) with the first
    tokens ``first`` (B, 1); then ``steps`` greedy GSPMD decode steps.
    Returns the rank's coordinates and batch rows, its greedy tokens
    (steps, B_loc) (the prefill's first token included with
    ``prompts``), the seconds of each step between syncs, the full
    vocabulary's logits of the prefill and every step (``keep_logits``,
    on each member 0), its kernel launches over the steps (and over the
    prefill: ``prefill_launches``), the bytes of
    its parameter part, its cache part after the steps
    (``return_cache``), with ``trace`` the steps' share in collectives,
    and with ``check_replicated`` the activations it held equal to the bit
    across its stage's members. ``offsets`` False is the negative
    control: members merge their sequence shards as if each began at
    line 0. ``fail_rank``: that rank raises at its second decode step
    (the serve CLI's ``--chaos rank``)."""
    from ..kernels import ops
    from .serve import _replicated_probe
    from .telemetry import Tracer

    t0 = clock()
    lay = ctx.layout(n_stages, tp, pods)
    dev = lay.device
    tdt = getattr(torch, dtype)
    tree = _load(params)
    flat, specs = gspmd_params(tree, cfg, lay, dtype=tdt)
    del tree
    B = (prompts if prompts is not None else first).shape[0]
    rows = batch_rows(lay, B)
    if prompts is None:
        one = _load(cache)
        c = gspmd_cache(one, cfg, lay)
        cspecs = cache_specs(cfg, lay.mesh, one)
        del one
    else:
        c = gspmd_init_cache(cfg, lay, B, ctx_len, dtype=tdt)
        cspecs = cache_specs(cfg, lay.mesh, M.init_cache(
            cfg, B, ctx_len, dtype=tdt, device="meta"))
    seen: Dict[str, int] = {}
    unequal: List[str] = []
    probe = _replicated_probe(lay.model, seen, unequal) \
        if check_replicated else None
    model = GspmdModel(cfg, lay, flat, specs, cache_specs=cspecs,
                       offsets=offsets, probe=probe)
    tracer = Tracer() if trace else None
    lay.set_tracer(tracer)
    _sync(dev)
    load_s = clock() - t0
    kept, toks, secs, caches = [], [], [], []

    def keep(logits):
        if keep_logits:
            full = full_logits(model, logits)
            if lay.member == 0:
                kept.append(full.float().cpu().numpy())

    ops.reset_launch_counts()
    if prompts is not None:
        pre = GspmdPrefill(model, rows, B)
        tk = torch.as_tensor(np.asarray(prompts)[rows], device=dev).int()
        em = None if embeds is None else torch.as_tensor(
            np.asarray(embeds)[rows], device=dev).to(tdt)
        _sync(dev)
        ts = clock()
        logits, c = pre(c, tk, em, fresh=True)
        tok = greedy(model, logits)[:, -1:]
        _sync(dev)
        prefill_s = clock() - ts
        keep(logits)
        toks.append(tok[:, 0].cpu().numpy())
    else:
        prefill_s = None
        tok = torch.as_tensor(np.asarray(first)[rows], device=dev).int()
    prefill_launches = ops.launch_counts()
    step = GspmdDecodeStep(model, rows, B)
    tr = resolve_tracer(tracer)
    ops.reset_launch_counts()
    for t in range(steps):
        if fail_rank == ctx.rank and t == 1:
            raise RuntimeError(f"rank {ctx.rank}: injected failure at step "
                               f"{t}")
        _sync(dev)
        ts = clock()
        with tr.token_step(t, track="decode"):
            logits, c = step(c, tok)
            tok = greedy(model, logits)
            _sync(dev)
        secs.append(clock() - ts)
        toks.append(tok[:, 0].cpu().numpy())
        keep(logits)
    counts = ops.launch_counts()
    if return_cache:
        caches = {p: (t.float() if t.dtype == torch.bfloat16 else t
                      ).cpu().numpy().copy()
                  for p, t in S.flatten_with_path(c)}
    out = {"rank": ctx.rank, "pod": lay.pod, "stage": lay.stage,
           "member": lay.member, "rows": (rows.start, rows.stop),
           "t_start": t0, "load_s": load_s, "prefill_s": prefill_s,
           "tokens": np.stack(toks) if toks else np.zeros((0, 0)),
           "step_s": secs, "logits": kept, "launches": counts,
           "prefill_launches": prefill_launches,
           "nbytes": tree_nbytes(flat), "cache": caches,
           "replicated": seen, "unequal": unequal, "comm_share": None}
    if trace:
        stalls = tracer.stalls()
        wall = sum(s.wall_s for s in stalls)
        out["comm_share"] = sum(s.comms_s for s in stalls) / max(wall, 1e-12)
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out
