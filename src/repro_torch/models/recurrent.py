"""Attention-free temporal blocks (port of ``repro.models.recurrent``):
RG-LRU (Griffin / RecurrentGemma), mLSTM and sLSTM (xLSTM), each with a
whole-sequence form for prefill and a one-token step for decode that
carries an O(1) per-sequence state.

Plain functions on tensors and parameter dicts, in the reference's layout
(weights ``(in, out)``, ``x @ w``). The reference computes these blocks
outside any Pallas kernel (``lax.associative_scan``, ``lax.scan``,
einsums), and so does the port: plain PyTorch, on the CPU and on the card.
The sharding hints and the flop-count ``unroll`` mode of the reference
are mesh and lowering settings and are left out. Every form is
differentiable (nothing is written in place into a tensor that carries a
gradient), for training: the mLSTM chunk step is rematerialised in the
backward pass, as the reference's ``jax.checkpoint`` does
(``repro/models/recurrent.py:280``); the sLSTM step is not (the reference
checkpoints it too, ``:368``): it keeps a few ``(B, H, 4 hd)`` tensors a
token, small beside a layer's other activations, and the stage unit
around it is rematerialised already.

Numerics follow the reference op for op:

- matmul weights are cast to ``COMPUTE_DTYPE`` (bf16) at every use, so
  they may be stored in bf16; ``lam``, ``b_if``, sLSTM's ``r`` and the
  ``ln_inner`` norms are read as float32;
- an einsum the reference asks for with ``preferred_element_type=f32``
  (a float32 result of bf16 operands) upcasts its operands to float32,
  which is exact, and multiplies in float32 (TF32 must be off on the card);
- the RG-LRU's decode conv concatenates the float32 cached taps with the
  bf16 input, so it and what follows run in float32, where prefill's conv
  runs in bf16; the taps are summed in the reference's order;
- the RG-LRU's linear recurrence is combined in the reference's
  ``lax.associative_scan`` recursion (:func:`associative_scan`), log-depth
  and vectorised over the sequence;
- mLSTM's ``q / np.sqrt(hd)`` promotes to float32 (a NumPy scalar is not
  weakly typed) and is then kept in bf16 on the chunked path and float32
  on the one-token path; the activations are :func:`~.layers.gelu` and
  :func:`~.layers.silu`, XLA's bf16 op sequences.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .layers import COMPUTE_DTYPE, gelu, remat, rms_norm, silu

F32 = torch.float32


def _dense(generator: torch.Generator, shape, dev, dtype, scale=None) -> torch.Tensor:
    """The reference's ``dense_init``: normal / sqrt(fan_in) (``shape[0]``),
    or ``scale``; on the ``meta`` device the shape alone."""
    if torch.device(dev).type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(scale).to(device=dev, dtype=dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int = 1
                     ) -> List[torch.Tensor]:
    """Inclusive scan of ``elems`` along ``dim`` with the associative
    ``fn(c1, c2)`` (tuples of tensors), combined in the order of
    ``lax.associative_scan``'s odd/even recursion: adjacent pairs are
    reduced, the half-length sequence is scanned recursively, and the even
    positions are combined from it. log2(T) levels, each a few whole-tensor
    ops, so the result rounds as the reference's does."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)
    lead = (slice(None),) * dim

    def sl(t, start, stop=None, step=1):
        return t[lead + (slice(start, stop, step),)]

    reduced = fn([sl(e, 0, -1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd], [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        # interleave [e_0, ev...] (even positions) with od (odd ones),
        # out of place so that autograd sees plain ops
        evens = torch.cat([sl(e, 0, 1).to(ev.dtype), ev], dim=dim)
        m = od.shape[dim]
        pairs = torch.stack([sl(evens, 0, m), od], dim=dim + 1).flatten(dim, dim + 1)
        out.append(torch.cat([pairs, sl(evens, m)], dim=dim) if n % 2 else pairs)
    return out


# ------------------------------------------------------------------ RG-LRU
RGLRU_C = 8.0


def rglru_init(generator: torch.Generator, d_model: int, d_rnn: int,
               device: DeviceLike = "cuda",
               dtype: torch.dtype = COMPUTE_DTYPE) -> Dict[str, torch.Tensor]:
    """RG-LRU weights drawn in the reference's order (``rglru_init``):
    matmul and conv weights in ``dtype``; ``lam`` float32, set so that
    ``a = sigmoid(lam)^c`` lies in (0.9, 0.999)."""
    device = resolve_device(device)
    u = torch.rand(d_rnn, generator=generator, device=generator.device) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.exp(-torch.log(u) / RGLRU_C) - 1.0)      # softplus^-1
    d = lambda shape, scale=None: _dense(generator, shape, device, dtype, scale)
    return {
        "wx": d((d_model, d_rnn)), "wy": d((d_model, d_rnn)), "w_out": d((d_rnn, d_model)),
        "conv_w": d((4, d_rnn), 0.5), "wa": d((d_rnn, d_rnn)), "wi": d((d_rnn, d_rnn)),
        "lam": lam.to(device=device, dtype=F32),
    }


def _causal_conv4(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width 4. x: (B, T, C); state: (B, 3, C), the
    last three inputs before ``x`` (zeros without one). The taps add in the
    reference's order, ``0 + t0 + t1 + t2 + t3``, in the promoted dtype of
    ``state`` and ``x``. Returns ``(out, new_state)``."""
    pad = torch.zeros_like(x[:, :3]) if state is None else state
    dt = torch.promote_types(pad.dtype, x.dtype)
    xp = torch.cat([pad.to(dt), x.to(dt)], dim=1)
    n = xp.shape[1]
    out = None
    for i in range(4):
        t = xp[:, 3 - i:n - i] * w[3 - i]
        out = t if out is None else out + t
    return out, xp[:, -3:]


def _rglru_coeffs(p, u: torch.Tensor):
    """Gated coefficients of ``h_t = a_t * h_{t-1} + b_t``, float32."""
    uf = u.to(COMPUTE_DTYPE)
    r = torch.sigmoid((uf @ p["wa"].to(COMPUTE_DTYPE)).float())
    i = torch.sigmoid((uf @ p["wi"].to(COMPUTE_DTYPE)).float())
    log_a = -RGLRU_C * _softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) * (i * u.float())
    return a, b


def _rglru_combine(c1, c2):
    (a1, b1), (a2, b2) = c1, c2
    return [a1 * a2, a2 * b1 + b2]


def rglru_forward(p, x: torch.Tensor, h0=None, conv0=None):
    """Whole-sequence Griffin recurrent block. x: (B, T, D). The recurrence
    runs as :func:`associative_scan`. Returns ``(out, (h_T, conv_state))``:
    ``h_T`` (B, d_rnn) float32, ``conv_state`` (B, 3, d_rnn) in the conv's
    dtype."""
    xc = x.to(COMPUTE_DTYPE)
    gate = gelu(xc @ p["wy"].to(COMPUTE_DTYPE))
    u = xc @ p["wx"].to(COMPUTE_DTYPE)
    u, conv_state = _causal_conv4(u, p["conv_w"].to(COMPUTE_DTYPE), conv0)
    a, b = _rglru_coeffs(p, u)
    if h0 is not None:
        # fold the incoming state into the first step: b_0 += a_0 * h0
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, h = associative_scan(_rglru_combine, [a, b], dim=1)
    out = (h.to(COMPUTE_DTYPE) * gate) @ p["w_out"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), (h[:, -1], conv_state)


def rglru_step(p, x: torch.Tensor, h: torch.Tensor, conv_state: torch.Tensor):
    """One decode step. x: (B, 1, D); h: (B, d_rnn) float32; conv_state:
    (B, 3, d_rnn) float32 -- so the conv and the coefficients run in
    float32. Returns ``(out, h_new, conv_state)``."""
    xc = x.to(COMPUTE_DTYPE)
    gate = gelu(xc @ p["wy"].to(COMPUTE_DTYPE))
    u = xc @ p["wx"].to(COMPUTE_DTYPE)
    u, conv_state = _causal_conv4(u, p["conv_w"].to(COMPUTE_DTYPE), conv_state)
    a, b = _rglru_coeffs(p, u)
    h_new = a[:, 0] * h + b[:, 0]
    out = (h_new[:, None].to(COMPUTE_DTYPE) * gate) @ p["w_out"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), h_new, conv_state


# ------------------------------------------------------------------ mLSTM
def mlstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               proj_factor: float = 2.0, device: DeviceLike = "cuda",
               dtype: torch.dtype = COMPUTE_DTYPE) -> Dict[str, torch.Tensor]:
    """mLSTM block weights in the reference's order (``mlstm_init``);
    ``b_if`` (input gates 0, forget gates 3) and ``ln_inner`` float32."""
    device = resolve_device(device)
    pd = int(d_model * proj_factor)
    d = lambda shape, scale=None: _dense(generator, shape, device, dtype, scale)
    out = {"w_up": d((d_model, 2 * pd)), "wq": d((pd, pd)), "wk": d((pd, pd)),
           "wv": d((pd, pd)), "w_if": d((pd, 2 * n_heads), 0.01)}
    out["b_if"] = torch.cat([torch.zeros(n_heads), torch.full((n_heads,), 3.0)]).to(device)
    out["w_down"] = d((pd, d_model))
    out["ln_inner"] = torch.zeros(pd, dtype=F32, device=device)
    return out


def _mlstm_gates(p, u: torch.Tensor):
    """Input-gate pre-activations and log forget gates, float32."""
    gf = (u @ p["w_if"].to(COMPUTE_DTYPE)).float() + p["b_if"].float()
    n_heads = gf.shape[-1] // 2
    i_pre, f_pre = gf[..., :n_heads], gf[..., n_heads:]
    return i_pre, -_softplus(-f_pre)              # log sigmoid(f_pre)


def mlstm_qkv(p, u: torch.Tensor, n_heads: int, keep_dtype: Optional[torch.dtype] = None):
    """q, k, v ``(..., H, hd)`` in ``keep_dtype`` (float32 by default). q is
    divided by ``sqrt(hd)`` in float32, as the reference's division by a
    NumPy float64 scalar promotes it."""
    pd = u.shape[-1]
    hd = pd // n_heads
    shp = u.shape[:-1] + (n_heads, hd)
    q = (u @ p["wq"].to(COMPUTE_DTYPE)).reshape(shp).float() / float(np.float32(np.sqrt(hd)))
    k = (u @ p["wk"].to(COMPUTE_DTYPE)).reshape(shp)
    v = (u @ p["wv"].to(COMPUTE_DTYPE)).reshape(shp)
    kd = keep_dtype or F32
    return q.to(kd), k.to(kd), v.to(kd)


def mlstm_step_state(q, k, v, i_pre, logf, state):
    """The exact sequential recurrence, one step (the oracle and decode).
    q/k/v: (B, H, hd); i_pre/logf: (B, H); state: (C, n, m). Returns
    ``(h (B, H, hd), (C, n, m))``."""
    C, n, m = state
    m_new = torch.maximum(logf + m, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(logf + m - m_new)
    C_new = f[..., None, None] * C + i[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f[..., None] * n + i[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C_new, q)
    den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", n_new, q)), torch.exp(-m_new))
    return num / den[..., None], (C_new, n_new, m_new)


def _zero_state(B, H, hd, dev):
    return (torch.zeros(B, H, hd, hd, dtype=F32, device=dev),
            torch.zeros(B, H, hd, dtype=F32, device=dev),
            torch.zeros(B, H, dtype=F32, device=dev))


def mlstm_sequence_ref(q, k, v, i_pre, logf, state=None):
    """Step-by-step recurrence over time (the oracle of the chunkwise form).
    q/k/v: (B, T, H, hd); gates (B, T, H). Returns ``(h (B, T, H, hd),
    state)``."""
    B, T, H, hd = q.shape
    if state is None:
        state = _zero_state(B, H, hd, q.device)
    hs = []
    for t in range(T):
        h, state = mlstm_step_state(q[:, t], k[:, t], v[:, t], i_pre[:, t], logf[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def _mlstm_chunk(state, qt, kt, vt, it, ft):
    """One chunk of :func:`mlstm_sequence_chunked`: intra-chunk
    attention-like products plus the carried state's contribution, and the
    chunk-final state. qt/kt/vt (B, L, H, hd); it/ft (B, L, H)."""
    C0, n0, m0 = state
    L = qt.shape[1]
    F = torch.cumsum(ft, dim=1)                           # (B, L, H) log decay from start
    # log weight of source s for target t: D[t, s] = F_t - F_s + i_s, s <= t
    D = F[:, :, None] - F[:, None, :] + it[:, None, :]    # (B, t, s, H)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=qt.device))
    D = D.masked_fill(~tri[None, :, :, None], -math.inf)
    E = F + m0[:, None]                                   # state path log-scale
    m_t = torch.maximum(D.amax(dim=2), E)
    W = torch.exp(D - m_t[:, :, None])
    # intra-chunk numerator / denominator: bf16 operands, float32 products
    q32, k32, v32 = qt.float(), kt.float(), vt.float()
    s_qk = torch.einsum("blhd,bshd->blsh", q32, k32)
    ws = W * s_qk
    num_intra = torch.einsum("blsh,bshd->blhd", ws.to(vt.dtype).float(), v32)
    den_intra = ws.sum(dim=2)
    sc = torch.exp(E - m_t)                               # (B, L, H)
    num_state = torch.einsum("blh,bhij,blhj->blhi", sc, C0.float(), q32)
    den_state = sc * torch.einsum("bhj,blhj->blh", n0, q32)
    num = num_intra + num_state
    den = torch.maximum(torch.abs(den_intra + den_state), torch.exp(-m_t))
    h = num / den[..., None]
    # chunk-final state
    FL = F[:, -1]                                         # (B, H)
    m_state = torch.maximum(FL + m0, (FL[:, None] - F + it).amax(dim=1))
    w_old = torch.exp(FL + m0 - m_state)
    w_src = torch.exp(FL[:, None] - F + it - m_state[:, None])     # (B, L, H)
    C1 = w_old[..., None, None] * C0 + torch.einsum(
        "blhi,blhj->bhij", (w_src[..., None] * v32).to(vt.dtype).float(), k32)
    n1 = w_old[..., None] * n0 + torch.einsum("blh,blhj->bhj", w_src, k32)
    return (C1, n1, m_state), h


def mlstm_sequence_chunked(q, k, v, i_pre, logf, state=None, chunk: int = 64):
    """Chunkwise-parallel mLSTM: intra-chunk einsums plus the inter-chunk
    state recurrence, exact (stabilised) -- the reference's
    ``mlstm_sequence_chunked``. A sequence that is not a multiple of
    ``chunk`` is padded (zero q/k/v, input gate -1e30, forget gate 0), so
    the pad positions add nothing to the state."""
    B, T, H, hd = q.shape
    pad = (-T) % chunk
    if pad:
        zq = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        q, k, v = zq(q), zq(k), zq(v)
        i_pre = torch.nn.functional.pad(i_pre, (0, 0, 0, pad), value=-1e30)
        logf = torch.nn.functional.pad(logf, (0, 0, 0, pad))
    if state is None:
        state = _zero_state(B, H, hd, q.device)
    hs = []
    for c in range(0, T + pad, chunk):
        s = slice(c, c + chunk)
        # rematerialised in a backward pass, as the reference's chunk step
        # (its (B, L, L, H) weights are recomputed, not kept)
        state, h = remat(_mlstm_chunk, state, q[:, s], k[:, s], v[:, s], i_pre[:, s],
                         logf[:, s])
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :T], state


MLSTM_CHUNK = 256


def mlstm_block_forward(p, x: torch.Tensor, n_heads: int):
    """Full mLSTM residual block over a sequence from the zero state. x:
    (B, T, D). The chunk is ``min(MLSTM_CHUNK, max(8, T))``; a one-token
    sequence runs the sequential form with float32 q/k/v. Returns ``(out,
    (C, n, m))``."""
    B, T, D = x.shape
    xc = x.to(COMPUTE_DTYPE)
    up = xc @ p["w_up"].to(COMPUTE_DTYPE)
    pd = up.shape[-1] // 2
    u, z = up[..., :pd], up[..., pd:]
    chunk = min(MLSTM_CHUNK, max(8, T))
    chunked = T > 1
    q, k, v = mlstm_qkv(p, u, n_heads, keep_dtype=COMPUTE_DTYPE if chunked else F32)
    i_pre, logf = _mlstm_gates(p, u)
    if chunked:
        h, state = mlstm_sequence_chunked(q, k, v, i_pre, logf, chunk=chunk)
    else:
        h, state = mlstm_sequence_ref(q, k, v, i_pre, logf)
    h = rms_norm(h.to(COMPUTE_DTYPE).reshape(B, T, pd), p["ln_inner"])
    out = (h.to(COMPUTE_DTYPE) * silu(z)) @ p["w_down"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), state


def mlstm_block_step(p, x: torch.Tensor, n_heads: int, state):
    """One decode step of the mLSTM block. x: (B, 1, D); the inner norm
    reads the float32 ``h`` (the whole-sequence form rounds it to bf16
    first, as the reference does)."""
    B = x.shape[0]
    xc = x.to(COMPUTE_DTYPE)
    up = xc @ p["w_up"].to(COMPUTE_DTYPE)
    pd = up.shape[-1] // 2
    u, z = up[..., :pd], up[..., pd:]
    q, k, v = mlstm_qkv(p, u[:, 0], n_heads)
    i_pre, logf = _mlstm_gates(p, u[:, 0])
    h, state = mlstm_step_state(q, k, v, i_pre, logf, state)
    h = rms_norm(h.reshape(B, 1, pd), p["ln_inner"])
    out = (h.to(COMPUTE_DTYPE) * silu(z)) @ p["w_down"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), state


# ------------------------------------------------------------------ sLSTM
def slstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               device: DeviceLike = "cuda",
               dtype: torch.dtype = COMPUTE_DTYPE) -> Dict[str, torch.Tensor]:
    """sLSTM weights in the reference's order (``slstm_init``): the
    block-diagonal recurrent ``r`` (H, hd, 4 hd) and ``ln_inner`` float32."""
    device = resolve_device(device)
    hd = d_model // n_heads
    d = lambda shape, scale=None: _dense(generator, shape, device, dtype, scale)
    w_in = d((d_model, 4 * d_model))
    r = _dense(generator, (n_heads, hd, 4 * hd), device, F32)
    return {"w_in": w_in, "r": r, "b": torch.zeros(4 * d_model, dtype=dtype, device=device),
            "w_out": d((d_model, d_model)),
            "ln_inner": torch.zeros(d_model, dtype=F32, device=device)}


def slstm_forward(p, x: torch.Tensor, n_heads: int, state=None):
    """sLSTM over a sequence, one step at a time (its recurrent weights make
    it inherently sequential). x: (B, T, D); state: (c, n, m, h), each (B,
    H, hd) float32. The input projection and its bias are added in bf16.
    Returns ``(out, state)``."""
    B, T, D = x.shape
    H = n_heads
    hd = D // H
    if state is None:
        z = torch.zeros(B, H, hd, dtype=F32, device=x.device)
        state = (z, z, z, z)
    xin = (x.to(COMPUTE_DTYPE) @ p["w_in"].to(COMPUTE_DTYPE)) + p["b"].to(COMPUTE_DTYPE)
    xin = xin.float().reshape(B, T, H, 4 * hd)
    r = p["r"].float()
    c, n, m, h = state
    hs = []
    for t in range(T):
        pre = xin[:, t] + torch.einsum("bhd,hdk->bhk", h, r)
        i_pre, f_pre, z_pre, o_pre = pre.split(hd, dim=-1)
        m_new = torch.maximum(f_pre + m, i_pre)
        i = torch.exp(i_pre - m_new)
        f = torch.exp(f_pre + m - m_new)
        c = f * c + i * torch.tanh(z_pre)
        n = f * n + i
        h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out = rms_norm(torch.stack(hs, dim=1).reshape(B, T, D), p["ln_inner"])
    out = out.to(COMPUTE_DTYPE) @ p["w_out"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), (c, n, m, h)


def slstm_step(p, x: torch.Tensor, n_heads: int, state):
    """One decode step: :func:`slstm_forward` over one token."""
    return slstm_forward(p, x, n_heads, state)
