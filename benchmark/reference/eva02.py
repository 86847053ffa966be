"""Plain float32 forward of EVA-02 (Fang et al., arXiv:2303.11331).

Written from the published equations of ``EVA-02/asuka/modeling_finetune.py``
(github.com/baaivision/EVA; the ``..._xattn_fusedLN_NaiveSwiGLU_subln_RoPE``
variants) in plain PyTorch, in that file's form: separate q, k and v
linears (k without a bias), the rotary embedding of
``VisionRotaryEmbeddingFast`` with ``rotate_half`` by pairs applied to the
patch tokens and the cls row put back with ``torch.cat``, materialised
scores and softmax, ``inner_attn_ln`` before the projection, the SwiGLU
``w3(ffn_ln(silu(w1 x) * w2 x))``, the mean of the patch tokens and
``fc_norm``. Parameters are read from a dict keyed by that file's
state-dict names. Nothing here imports the program under test or JAX.

Every matrix product and convolution takes its operands through ``quant``,
and so does the residual stream after the stem and after every block
(identity for the reference; a control's lower precision rounds there what
a lower-precision program would store). ``faults`` plants a fault for the
calibration of a comparison's limits: ``"rope_off"`` leaves the rotary
embedding out of q and k, ``"ffn_ln_off"`` the MLP's layer norm out.

Departures from the published module, none of which changes the function:
the model is a function of a parameter dict, not an ``nn.Module``; dropout
is left out (its rates are 0); stochastic depth takes its per-example keep
draws as inputs; the rotary tables are rebuilt at each call. TF32 is off
while it runs. :func:`soft_ce` is the fine-tune's soft-target
cross-entropy (timm's ``SoftTargetCrossEntropy``), whose gradients autograd
gives.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
ROPE_THETA = 10000.0
PT_SEQ_LEN = 16
EVA02_LARGE_448 = {"img_size": 448, "patch_size": 14, "embed_dim": 1024, "depth": 24,
                   "num_heads": 16, "mlp_ratio": 4 * 2 / 3}


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def linear(x, P, name, quant):
    return F.linear(quant(x), quant(P[name + ".weight"]), P.get(name + ".bias"))


def layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], LN_EPS)


def drop_path(x, keep, rate):
    if keep is None or rate == 0.0:
        return x
    return x * keep.view(-1, 1, 1).float() / (1.0 - rate)


def drop_path_rates(depth: int, rate: float):
    """One rate per block, rising linearly from 0 to ``rate``."""
    return [float(r) for r in np.linspace(0.0, rate, depth)]


def drop_path_draws(depth: int, rate: float):
    """The rate of each stochastic-depth draw of one forward, in call order:
    two per block whose rate is above 0."""
    return [r for r in drop_path_rates(depth, rate) if r > 0.0 for _ in range(2)]


def rope_freqs(head_dim: int, grid: int, device=None):
    """``VisionRotaryEmbeddingFast(dim=head_dim // 2, pt_seq_len=16,
    ft_seq_len=grid)``'s ``(freqs_cos, freqs_sin)``, each ``(grid * grid,
    head_dim)``."""
    dim = head_dim // 2
    freqs = 1.0 / (ROPE_THETA ** (torch.arange(0, dim, 2)[:(dim // 2)].float() / dim))
    t = torch.arange(grid) / grid * PT_SEQ_LEN
    freqs = torch.einsum("..., f -> ... f", t, freqs)
    freqs = freqs.repeat_interleave(2, dim=-1)
    freqs = torch.cat((freqs[:, None, :].expand(grid, grid, dim),
                       freqs[None, :, :].expand(grid, grid, dim)), dim=-1)
    return (freqs.cos().view(-1, head_dim).to(device),
            freqs.sin().view(-1, head_dim).to(device))


def rotate_half(x):
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(dim=-1)
    x = torch.stack((-x2, x1), dim=-1)
    return x.reshape(*x.shape[:-2], -1)


def attention(x, P, name, heads, rope, quant, faults):
    b, n, c = x.shape
    q = F.linear(quant(x), quant(P[name + ".q_proj.weight"]), P[name + ".q_bias"])
    k = F.linear(quant(x), quant(P[name + ".k_proj.weight"]))
    v = F.linear(quant(x), quant(P[name + ".v_proj.weight"]), P[name + ".v_bias"])
    q = q.reshape(b, n, heads, -1).permute(0, 2, 1, 3)
    k = k.reshape(b, n, heads, -1).permute(0, 2, 1, 3)
    v = v.reshape(b, n, heads, -1).permute(0, 2, 1, 3)
    if "rope_off" not in faults:
        cos, sin = rope
        q_t = q[:, :, 1:, :]
        q = torch.cat((q[:, :, :1, :], q_t * cos + rotate_half(q_t) * sin), -2)
        k_t = k[:, :, 1:, :]
        k = torch.cat((k[:, :, :1, :], k_t * cos + rotate_half(k_t) * sin), -2)
    q = q * q.shape[-1] ** -0.5
    attn = quant(q) @ quant(k).transpose(-2, -1)
    attn = attn.softmax(dim=-1)
    x = (quant(attn) @ quant(v)).transpose(1, 2).reshape(b, n, -1)
    x = layer_norm(x, P, name + ".inner_attn_ln")
    return linear(x, P, name + ".proj", quant)


def mlp(x, P, name, quant, faults):
    x1 = linear(x, P, name + ".w1", quant)
    x2 = linear(x, P, name + ".w2", quant)
    hidden = F.silu(x1) * x2
    if "ffn_ln_off" not in faults:
        hidden = layer_norm(hidden, P, name + ".ffn_ln")
    return linear(hidden, P, name + ".w3", quant)


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (-(targets * F.log_softmax(logits, dim=-1)).sum(-1)).mean()


def forward(P: Dict[str, torch.Tensor], images: torch.Tensor, cfg: Dict,
            keeps: Sequence[torch.Tensor] = (), drop_path_rate: float = 0.0,
            quant: Callable = identity, faults: Sequence[str] = ()) -> torch.Tensor:
    """Logits of NHWC float ``images``; ``keeps`` are the stochastic-depth
    draws in call order (:func:`drop_path_draws`), empty for none."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        patch, heads = cfg["patch_size"], cfg["num_heads"]
        x = F.conv2d(quant(images.permute(0, 3, 1, 2)), quant(P["patch_embed.proj.weight"]),
                     P["patch_embed.proj.bias"], stride=patch)
        x = x.flatten(2).transpose(1, 2)
        b = x.shape[0]
        x = torch.cat((P["cls_token"].expand(b, -1, -1), x), dim=1)
        x = quant(x + P["pos_embed"])
        grid = cfg["img_size"] // patch
        rope = rope_freqs(cfg["embed_dim"] // heads, grid, x.device)
        rates = drop_path_rates(cfg["depth"], drop_path_rate)
        draws = iter(keeps)
        for i in range(cfg["depth"]):
            name = f"blocks.{i}"
            on = len(keeps) > 0 and rates[i] > 0.0
            f = attention(layer_norm(x, P, name + ".norm1"), P, name + ".attn", heads, rope,
                          quant, faults)
            x = x + drop_path(f, next(draws) if on else None, rates[i])
            f = mlp(layer_norm(x, P, name + ".norm2"), P, name + ".mlp", quant, faults)
            x = quant(x + drop_path(f, next(draws) if on else None, rates[i]))
        x = layer_norm(x[:, 1:, :].mean(1), P, "fc_norm")
        return linear(x, P, "head", quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
