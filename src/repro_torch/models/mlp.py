"""Feed-forward blocks: gated (llama-style) and plain 2-matrix MLPs (port
of `repro.models.mlp`)."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init

Tensor = torch.Tensor


def init_mlp(gen: torch.Generator, cfg, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu_mlp":
        return {"w_up": dense_init(gen, (d, f), device),
                "w_down": dense_init(gen, (f, d), device)}
    return {"w_gate": dense_init(gen, (d, f), device),
            "w_up": dense_init(gen, (d, f), device),
            "w_down": dense_init(gen, (f, d), device)}


def _ff(w, x: Tensor, cd) -> Tensor:
    """(B, T, a) · w(a, b) -> (B, T, b); dense einsum or, for a fused-layout
    QT leaf, quant_matmul."""
    from repro_torch.core.apply import is_qt, qt_linear
    if is_qt(w):
        B, T, a = x.shape
        return qt_linear(w, x.reshape(B * T, a), out_dtype=cd).reshape(
            B, T, -1)
    return torch.einsum("btd,df->btf", x, w.to(cd))


def apply_mlp(p: dict, x: Tensor, cfg, taps=None, constrain=None,
              quantize_cb=None) -> Tensor:
    """`constrain`: the plan's activation-sharding hook, called on the
    hidden activation ("ffn_hidden"), as JAX's full-sequence layer does."""
    cd = x.dtype
    act = act_fn(cfg.act)
    if taps is not None:
        taps["mlp_in"] = x        # feeds w_gate / w_up
        if quantize_cb is not None:
            p = {**p, **quantize_cb("mlp_in")}
    if "w_gate" in p:
        h = act(_ff(p["w_gate"], x, cd)) * _ff(p["w_up"], x, cd)
    else:
        h = act(_ff(p["w_up"], x, cd))
    if constrain is not None:
        h = constrain(h, "ffn_hidden")
    if taps is not None:
        taps["down_in"] = h       # feeds w_down
        if quantize_cb is not None:
            p = {**p, **quantize_cb("down_in")}
    return _ff(p["w_down"], h, cd)
