"""Mamba-1 selective state-space block (falcon-mamba's and jamba's mixer).

Counterpart of :mod:`repro.models.mamba`.  The sequence is cut into chunks
of ``chunk`` steps; a Python loop carries the ``[B, d_inner, n]`` state
across chunks, and inside a chunk the decay ``exp(dt·A)`` and the input
``dt·B·x`` (``[B, c, d_inner, n]``, chunk-local only) are solved by a
log-depth inclusive scan: log2(c) shifted passes of the combine ``(a1·a2,
b1·a2 + b2)``, as ``lax.associative_scan`` does, so a 64-step chunk is 6
passes and not 64 steps of launches.  The scan sums in another order than
JAX's, so the port agrees with the reference to float32 rounding, not to
the bit.  (A log-space cumulative sum would take one pass, but ``dt·A``
reaches about -100 over a chunk and ``exp(100)`` overflows float32.)

The ``dt_w`` product and the scan are plain PyTorch, as the reference's are
plain ``jnp``; ``in_proj``, ``x_proj`` and ``out_proj`` go through
:func:`~repro_torch.models.layers.dense`, so they run the residency's
kernels.  Decode keeps an O(1) state, batch first: ``{"conv": [B, d_conv-1,
d_inner], "ssm": [B, d_inner, n]}`` float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.layers import dense


def mamba_specs(cfg) -> dict:
    """The Mamba mixer's parameters (the reference's ParamSpecs, init rules
    included: ``A_log`` is ``ssm_a``, ``dt_b`` ``ssm_dt``)."""
    from repro_torch.models.model import ParamSpec

    di, n, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank_actual
    return {
        "in_proj": ParamSpec((cfg.d_model, 2 * di), cfg.dtype),
        "conv_w": ParamSpec((cfg.d_conv, di), torch.float32),
        "conv_b": ParamSpec((di,), torch.float32, "zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * n), cfg.dtype),
        "dt_w": ParamSpec((dtr, di), torch.float32),
        "dt_b": ParamSpec((di,), torch.float32, "ssm_dt"),
        "A_log": ParamSpec((di, n), torch.float32, "ssm_a"),
        "D": ParamSpec((di,), torch.float32, "ones"),
        "out_proj": ParamSpec((di, cfg.d_model), cfg.dtype),
    }


def _causal_conv(params, x_in, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, then SiLU.  ``conv_state [B,
    d_conv-1, di]`` is the tail of the previous segment's inputs (decode
    and chunked continuity).  Returns (output in ``x_in.dtype``, the new
    tail in float32)."""
    w = params["conv_w"]  # [d_conv, di]
    dc = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x_in.shape[0], dc - 1, x_in.shape[2]), dtype=x_in.dtype,
                          device=x_in.device)
    else:
        pad = conv_state.to(x_in.dtype)
    xp = torch.cat([pad, x_in], dim=1).to(torch.float32)
    s = x_in.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(dc)) + params["conv_b"]
    new_state = xp[:, xp.shape[1] - (dc - 1):] if dc > 1 else torch.zeros_like(pad)
    return F.silu(out).to(x_in.dtype), new_state.to(torch.float32)


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the combine ``(a1·a2, b1·a2 + b2)`` along axis 1
    in log2(c) shifted passes (Hillis-Steele)."""
    c = a.shape[1]
    shift = 1
    while shift < c:
        a_hi = a[:, shift:]
        b = torch.cat([b[:, :shift], b[:, :-shift] * a_hi + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a_hi], dim=1)
        shift *= 2
    return a, b


def _chunk_step(params, h0, dt_c, b_c, c_c, xc_c):
    """One chunk: decay and input built locally, scanned, contracted against
    C.  ``dt_c [B,c,di]`` f32, ``b_c / c_c [B,c,n]`` f32, ``xc_c [B,c,di]``
    (after the conv).  Returns (``y_c [B,c,di]`` f32, ``h_out [B,di,n]``)."""
    a = -torch.exp(params["A_log"])  # [di, n]
    decay = torch.exp(dt_c[..., None] * a)  # [B,c,di,n]
    inp = (dt_c * xc_c.to(torch.float32))[..., None] * b_c[:, :, None, :]
    pa, pb = _scan(decay, inp)
    h_all = pb + pa * h0[:, None]
    y_c = torch.einsum("bcdn,bcn->bcd", h_all, c_c)
    return y_c, h_all[:, -1]


def mamba_apply(params: dict, x: torch.Tensor, cfg, *, chunk: int = 64,
                state: Optional[dict] = None, return_state: bool = False, impl=None):
    """The selective SSM over ``x [B, S, D]`` → ``[B, S, D]``, from ``state``
    (default zeros).  With ``return_state`` also returns the state after
    the last step, ``{"conv", "ssm"}``."""
    b, s, _ = x.shape
    di, n, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank_actual
    xz = dense(params["in_proj"], x, impl=impl)
    x_in, z = xz[..., :di], xz[..., di:]
    x_conv, new_conv = _causal_conv(params, x_in, None if state is None else state["conv"])

    xdb = dense(params["x_proj"], x_conv, impl=impl).to(torch.float32)
    dt_low, bmat, cmat = xdb[..., :dtr], xdb[..., dtr:dtr + n], xdb[..., dtr + n:]
    dt = F.softplus(dt_low @ params["dt_w"] + params["dt_b"])  # [B,S,di]

    c = min(chunk, s)
    pad = (-s) % c
    x_conv_p = x_conv
    if pad:  # padded steps: dt = 0 ⇒ decay 1, input 0: the state is carried unchanged
        dt, bmat, cmat, x_conv_p = (F.pad(t, (0, 0, 0, pad))
                                    for t in (dt, bmat, cmat, x_conv))
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device) if state is None
         else state["ssm"].to(torch.float32))
    ys = []
    for c0 in range(0, s + pad, c):
        y_c, h = _chunk_step(params, h, dt[:, c0:c0 + c], bmat[:, c0:c0 + c],
                             cmat[:, c0:c0 + c], x_conv_p[:, c0:c0 + c])
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :s]

    y = y + params["D"] * x_conv.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = dense(params["out_proj"], y, impl=impl)
    if return_state:
        return out, {"conv": new_conv, "ssm": h}
    return out


def init_mamba_state(cfg, batch: int, device=None) -> dict:
    """Zero decode state on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    di, n, dc = cfg.d_inner, cfg.d_state, cfg.d_conv
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=torch.float32, device=device),
            "ssm": torch.zeros((batch, di, n), dtype=torch.float32, device=device)}


def mamba_decode(params, x, state, cfg, *, impl=None):
    """Tokens ``x [B, S, D]`` against the state (one step a token) →
    (output, new state)."""
    return mamba_apply(params, x, cfg, chunk=1, state=state, return_state=True, impl=impl)
