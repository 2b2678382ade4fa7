"""Decoder-only LM family: olmo / gemma / gemma3 / olmoe / deepseek-v2.

One configurable module covers all five LM architectures:

  * attention: MHA/GQA/MQA (``attn='gqa'``) or DeepSeek-V2 MLA (``'mla'``)
  * FFN: SwiGLU/GeGLU dense or shared+routed top-k MoE
  * layer pattern: uniform, N-local:1-global sliding window (gemma3),
    leading dense layers (deepseek-v2 layer 0)
  * non-parametric LayerNorm (olmo) or RMSNorm

Parameters are a tree of tensors laid out as the reference's: the
repeated layers stacked along a leading axis under ``layers`` (each
layer reads its views of them), the leading dense layers a list under
``dense``.  So the tree's paths and shapes are the reference's, and
``params_from_reference`` / ``params_to_reference`` carry a tree across
leaf by leaf.  With ``cfg.remat`` each stacked layer runs under
``torch.utils.checkpoint`` during training.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import carry_tree, to_numpy, to_torch
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_norm, cross_entropy_chunked, mlp_apply, mlp_init, normal,
)
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.utils.tree import (
    tree_items, tree_leaves, tree_map, tree_unflatten,
)


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    norm: str = "rmsnorm"
    attn: str = "gqa"  # gqa | mla
    q_lora: int = 0
    kv_lora: int = 0
    rope_dim: int = 64
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_dff: int = 0
    capacity_factor: float = 1.25
    dense_layers: int = 0  # leading dense layers before the MoE stack
    dense_dff: int = 0
    window: int = 0  # sliding-window size; 0 = full attention
    local_ratio: int = 0  # N local : 1 global interleave (gemma3: 5)
    remat: bool = True
    dtype: str = "bfloat16"
    loss_chunks: int = 8
    aux_weight: float = 0.01
    attn_impl: str = "naive"  # naive | blockwise | stub

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_is_global(self) -> np.ndarray:
        """bool[L_stack] — which stacked layers use full (global) attention."""
        L = self.n_layers - self.dense_layers
        if self.local_ratio <= 0 or self.window <= 0:
            return np.ones((L,), dtype=bool)
        r = self.local_ratio + 1
        return np.array([(i % r) == (r - 1) for i in range(L)])

    def param_count(self) -> int:
        return sum(t.numel() for t in tree_leaves(
            init_params(self, device="meta")))

    def model_flops_per_token(self) -> float:
        """6·N (dense) or 6·N_active (MoE) — embedding excluded.

        The reference's rule on its tree: a 4-D leaf under ``layers`` whose
        path names ``wi``, ``wg``, ``wo`` or ``router`` counts at
        ``top_k / n_experts`` in an MoE config (the stacked experts, and
        the stacked attention ``wo``)."""
        total = 0
        for path, leaf in tree_items(init_params(self, device="meta")):
            keys = [str(k) if isinstance(k, str) else "" for k in path]
            if "embed" in keys:
                continue
            n = leaf.numel()
            if (self.moe and leaf.ndim == 4 and "layers" in keys
                    and any(k in ("wi", "wg", "wo", "router") for k in keys)):
                n = n * self.top_k // max(self.n_experts, 1)  # active
            total += n
        return 6.0 * total


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: LMConfig, dense_ffn: bool, device, lead=()):
    dt = cfg.torch_dtype
    p = {}
    p["attn"] = (attn_lib.mla_init if cfg.attn == "mla"
                 else attn_lib.gqa_init)(gen, cfg, dt, device, lead)
    if cfg.moe and not dense_ffn:
        p["ffn"] = moe_lib.moe_init(gen, cfg, dt, device, lead)
    else:
        ff = cfg.dense_dff if (dense_ffn and cfg.dense_dff) else cfg.d_ff
        p["ffn"] = mlp_init(gen, cfg.d_model, ff, cfg.act, dt, device, lead)
    if cfg.norm == "rmsnorm":
        p["ln1"] = torch.zeros(lead + (cfg.d_model,), dtype=dt, device=device)
        p["ln2"] = torch.zeros(lead + (cfg.d_model,), dtype=dt, device=device)
    return p


def init_params(cfg: LMConfig, device=None, seed: int = 0):
    """The reference's distributions and scales, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.  ``device``
    None means CUDA, which must exist; ``"meta"`` allocates nothing."""
    device = resolve_device(device)
    generator = (None if device.type == "meta"
                 else torch.Generator(device).manual_seed(seed))
    dt = cfg.torch_dtype
    L = cfg.n_layers - cfg.dense_layers
    params = {
        "embed": normal(generator, (cfg.vocab, cfg.d_model),
                        1.0 / np.sqrt(cfg.d_model), dt, device),
        "layers": _layer_init(generator, cfg, False, device, lead=(L,)),
    }
    if cfg.dense_layers > 0:
        params["dense"] = [_layer_init(generator, cfg, True, device)
                           for _ in range(cfg.dense_layers)]
    if cfg.norm == "rmsnorm":
        params["ln_f"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    return params


# ---------------------------------------------------------------------------
# Weights carried across from the reference and back
# ---------------------------------------------------------------------------


def params_from_reference(tree, cfg: LMConfig, device=None):
    """The reference's parameter tree (numpy leaves, ``layers`` stacked,
    ``dense`` a list; bfloat16 leaves as ml_dtypes arrays or raw 2-byte
    words) as the port's, on ``device`` (None: CUDA).  Paths, shapes and
    dtypes must be ``cfg``'s."""
    return carry_tree(tree, init_params(cfg, device="meta"),
                  resolve_device(device))


def params_to_reference(tree):
    """The inverse, for parameters and AdamW state alike: numpy leaves on
    the host, bfloat16 as raw 2-byte words (``np.savez``'s ``|V2``;
    ``.view(ml_dtypes.bfloat16)`` reads them)."""
    return tree_map(to_numpy, tree)


def opt_state_from_reference(state, cfg: LMConfig, device=None):
    """The reference's AdamW state (``mu``, ``nu``: float32 trees on the
    parameters' paths; ``step``) as the port's."""
    device = resolve_device(device)
    f32 = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                         device="meta"),
                   init_params(cfg, device="meta"))
    step = to_torch(state["step"], device, torch.int32)
    return {"mu": carry_tree(state["mu"], f32, device),
            "nu": carry_tree(state["nu"], f32, device), "step": step}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def layer_views(stacked) -> list:
    """The stacked layer tree as one tree of views a layer (one ``unbind``
    a leaf: its backward stacks the layers' gradients once)."""
    cols = [t.unbind(0) for t in tree_leaves(stacked)]
    return [tree_unflatten(stacked, list(layer)) for layer in zip(*cols)]


def _block(params_l, x, positions, cfg: LMConfig, is_global: bool,
           dense_ffn: bool):
    h = apply_norm(cfg.norm, x, params_l.get("ln1"))
    if cfg.attn == "mla":
        a, kv = attn_lib.mla_forward(params_l["attn"], h, positions, cfg)
    else:
        a, kv = attn_lib.gqa_forward_flagged(
            params_l["attn"], h, positions, cfg.window, is_global,
            cfg.attn_impl)
    x = x + a
    h = apply_norm(cfg.norm, x, params_l.get("ln2"))
    if cfg.moe and not dense_ffn:
        f, aux = moe_lib.moe_apply(params_l["ffn"], h, cfg)
    else:
        f = mlp_apply(params_l["ffn"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux, kv


def _embed(params, tokens, cfg: LMConfig):
    x = params["embed"][tokens.long()].float() * np.sqrt(cfg.d_model)
    return x.to(cfg.torch_dtype)


def forward(params, tokens, cfg: LMConfig, collect_cache: bool = False):
    """tokens (B, S) -> final hidden (B, S, d), aux [, KV caches: the
    dense layers' list and the stacked layers' (k, v) (or (c, kr)) lists]."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device).expand(B, S)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_caches = []
    for pl_ in params.get("dense", []):
        x, aux, kv = _block(pl_, x, positions, cfg, True, dense_ffn=True)
        aux_total = aux_total + aux
        dense_caches.append(kv)

    remat = cfg.remat and torch.is_grad_enabled()
    caches = ([], [])
    for pl_, flag in zip(layer_views(params["layers"]),
                         cfg.layer_is_global().tolist()):
        if remat:
            x, aux, kv = checkpoint(_block, pl_, x, positions, cfg, flag,
                                    False, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            x, aux, kv = _block(pl_, x, positions, cfg, flag, False)
        aux_total = aux_total + aux
        if collect_cache:
            caches[0].append(kv[0])
            caches[1].append(kv[1])
    x = apply_norm(cfg.norm, x, params.get("ln_f"))
    if collect_cache:
        return x, aux_total, (dense_caches, caches)
    return x, aux_total


def logits_fn(x, embed):
    return torch.einsum("bsd,vd->bsv", x, embed).float() / np.sqrt(x.shape[-1])


def loss_fn(params, batch, cfg: LMConfig):
    x, aux = forward(params, batch["tokens"], cfg)
    ce = cross_entropy_chunked(
        logits_fn, x, params["embed"], batch["targets"], batch["mask"],
        n_chunks=cfg.loss_chunks,
    )
    return ce + cfg.aux_weight * aux, ce


def make_train_step(cfg: LMConfig, opt_cfg: AdamWConfig = AdamWConfig()):
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and moments are updated in place."""

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            loss, ce = loss_fn(tree_unflatten(params, live), batch, cfg)
            grads = torch.autograd.grad(loss, live)
        params, opt_state, gnorm = adamw_update(
            tree_unflatten(params, grads), opt_state, params, opt_cfg)
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------


def _stack_pad(parts: list, max_seq: int | None) -> torch.Tensor:
    """``torch.stack(parts)`` with axis 2 (the sequence) zero-padded to
    ``max_seq``, written once."""
    first = parts[0]
    S = first.shape[1]
    n = max(S, max_seq or 0)
    out = first.new_zeros((len(parts), first.shape[0], n) + first.shape[2:])
    for i, part in enumerate(parts):
        out[i, :, :S] = part
    return out


def make_prefill_step(cfg: LMConfig, max_seq: int | None = None):
    """(params, tokens (B,S)) -> (last-position logits, decode-ready cache)."""

    @torch.no_grad()
    def prefill(params, tokens):
        x, _, (dense_caches, stack) = forward(params, tokens, cfg,
                                              collect_cache=True)
        logits = logits_fn(x[:, -1:], params["embed"])
        if cfg.attn == "mla":
            cache = {"c": _stack_pad(stack[0], max_seq),
                     "kr": _stack_pad(stack[1], max_seq)}
            if dense_caches:
                cache["dense_c"] = _stack_pad([c for c, _ in dense_caches],
                                              max_seq)
                cache["dense_kr"] = _stack_pad([kr for _, kr in dense_caches],
                                               max_seq)
        else:
            cache = {"k": _stack_pad(stack[0], max_seq),
                     "v": _stack_pad(stack[1], max_seq)}
        return logits, cache

    return prefill


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    """Uniform (baseline) cache layout: every layer holds max_seq slots."""
    dt = dtype or cfg.torch_dtype
    device = resolve_device(device)
    L = cfg.n_layers - cfg.dense_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.attn == "mla":
        cache = {"c": zeros(L, batch, max_seq, cfg.kv_lora),
                 "kr": zeros(L, batch, max_seq, cfg.rope_dim)}
        if cfg.dense_layers > 0:
            cache["dense_c"] = zeros(cfg.dense_layers, batch, max_seq,
                                     cfg.kv_lora)
            cache["dense_kr"] = zeros(cfg.dense_layers, batch, max_seq,
                                      cfg.rope_dim)
        return cache
    return {"k": zeros(L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
            "v": zeros(L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)}


def make_decode_step(cfg: LMConfig):
    """(params, cache, token (B,1), pos int) -> (logits, cache).  The new
    key and value are written into ``cache`` in place at ``pos``, which
    must lie inside it."""
    flags = cfg.layer_is_global().tolist()

    @torch.no_grad()
    def decode(params, cache, token, pos):
        pos = int(pos)
        x = _embed(params, token, cfg)

        # leading dense layers (deepseek-v2 layer 0) run outside the stack
        for i, pl_ in enumerate(params.get("dense", [])):
            h = apply_norm(cfg.norm, x, pl_.get("ln1"))
            a, _ = attn_lib.mla_decode(pl_["attn"], h, cache["dense_c"][i],
                                       cache["dense_kr"][i], pos, cfg)
            x = x + a
            h = apply_norm(cfg.norm, x, pl_.get("ln2"))
            x = x + mlp_apply(pl_["ffn"], h, cfg.act)

        for i, pl_ in enumerate(layer_views(params["layers"])):
            h = apply_norm(cfg.norm, x, pl_.get("ln1"))
            if cfg.attn == "mla":
                a, _ = attn_lib.mla_decode(pl_["attn"], h, cache["c"][i],
                                           cache["kr"][i], pos, cfg)
            else:
                a, _ = attn_lib.gqa_decode_flagged(
                    pl_["attn"], h, cache["k"][i], cache["v"][i], pos,
                    cfg.window, flags[i])
            x = x + a
            h = apply_norm(cfg.norm, x, pl_.get("ln2"))
            if cfg.moe:
                f, _ = moe_lib.moe_apply(pl_["ffn"], h, cfg)
            else:
                f = mlp_apply(pl_["ffn"], h, cfg.act)
            x = x + f
        x = apply_norm(cfg.norm, x, params.get("ln_f"))
        return logits_fn(x, params["embed"]), cache

    return decode
