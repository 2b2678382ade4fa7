"""Shared neural layers: norms, rotary embedding, MLPs, chunked loss."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normal(gen, shape: tuple, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in float32 from ``gen``, cast to ``dtype``
    (the reference's ``(jax.random.normal(k, shape) * s).astype(dtype)``).
    On the meta device nothing is drawn or allocated."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * float(scale)).to(dtype)


def rms_norm(x, scale=None, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def layer_norm_nonparam(x, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x, scale=None):
    if kind == "rmsnorm":
        return rms_norm(x, scale)
    if kind == "layernorm_nonparam":
        return layer_norm_nonparam(x)
    raise ValueError(kind)


def rope_freqs(head_dim: int, max_pos: int, theta: float = 10_000.0,
               device=None):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    f = np.outer(np.arange(max_pos), inv)
    return (torch.as_tensor(np.cos(f), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(f), dtype=torch.float32, device=device))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, D) with D even; positions: broadcastable (..., S).

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]) in float32."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def mlp_apply(params, x, act: str):
    """Gated (SwiGLU/GeGLU) or plain MLP; params: wi/(wg)/wo.  GELU is
    the tanh approximation, ``jax.nn.gelu``'s default."""
    h = x @ params["wi"]
    if act in ("swiglu", "geglu"):
        g = x @ params["wg"]
        gate = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = h * gate
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = F.relu(h)
    return h @ params["wo"]


def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype, device,
             lead: tuple = ()):
    """An MLP's weights; ``lead`` prefixes every shape (the stacked layer
    axis)."""
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)
    p = {
        "wi": normal(gen, lead + (d_model, d_ff), s_in, dtype, device),
        "wo": normal(gen, lead + (d_ff, d_model), s_out, dtype, device),
    }
    if act in ("swiglu", "geglu"):
        p["wg"] = normal(gen, lead + (d_model, d_ff), s_in, dtype, device)
    return p


def cross_entropy_chunked(logits_fn, x_final, embed, targets, mask,
                          n_chunks: int = 8):
    """Next-token CE with the vocab projection chunked over the time axis.

    Avoids materializing (B, S, V) logits at once.  ``logits_fn`` maps a
    (B, C, d) slice to (B, C, V) (usually x @ embed.T).
    """
    B, S, _ = x_final.shape
    C = S // n_chunks
    if C * n_chunks != S:
        raise ValueError("sequence must divide the chunk count")
    tot = torch.zeros((), dtype=torch.float32, device=x_final.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x_final.device)
    for i in range(n_chunks):
        cut = slice(i * C, (i + 1) * C)
        logits = logits_fn(x_final[:, cut], embed).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[:, cut].unsqueeze(-1).long())[..., 0]
        ms = mask[:, cut]
        tot = tot + ((lse - gold) * ms).sum()
        cnt = cnt + ms.sum()
    return tot / torch.clamp(cnt, min=1.0)
