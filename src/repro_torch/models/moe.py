"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(port of ``repro/models/moe.py:25-169``).

The reference's fixed-shape dispatch, operation for operation: token-expert
pairs are sorted by expert id (a stable sort), given in-expert positions
from the first pair of each expert (``searchsorted``, left side), pairs past
an expert's capacity ``C`` are dropped, each expert's ``C`` rows are
gathered into an ``(G, E, C, D)`` buffer, run through the batched expert
einsums, rounded to the compute dtype and gathered back to their pairs,
then weighted and summed over each token's ``K`` experts (rounded as the
reference's jitted step rounds it: :func:`moe_forward`). Every shape is
static and nothing reads a value back to the host, so the step that runs
it can be captured as a CUDA graph. What decides which rows an expert
keeps is the pair order, so the port routes exactly the rows the reference
routes, idle decode slots included.

The expert products are ``torch.einsum`` (batched GEMMs): the reference
computes them outside any Pallas kernel. Sharding hints are left out. The
router's auxiliary load-balancing loss (Switch-style, ``repro/models/
moe.py:162-169``) is computed only where the caller asks for it
(``aux_loss=True``: the training path); serving reads only the output, so
its captured steps compute nothing more. Everything here is
differentiable: the dispatch and combine are gathers, the loss flows
through the router's probabilities.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .layers import COMPUTE_DTYPE, ffn_forward, silu


@dataclass(frozen=True)
class MoEConfig:
    """Copy of ``repro.models.moe.MoEConfig``."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0          # 0 = no shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    norm_topk_prob: bool = True


def moe_param_shapes(d_model: int, cfg: MoEConfig) -> dict:
    """The parameter layout of ``repro.models.moe.moe_init``: the router
    ``(D, E)``, the experts' ``wg``/``wu`` ``(E, D, F)`` and ``wd`` ``(E,
    F, D)``, and the shared SwiGLU expert where ``d_ff_shared`` is set."""
    E, F, D = cfg.num_experts, cfg.d_ff_expert, d_model
    shapes = {"router": (D, E), "wg": (E, D, F), "wu": (E, D, F), "wd": (E, F, D)}
    if cfg.d_ff_shared:
        Fs = cfg.d_ff_shared
        shapes["shared"] = {"wg": (D, Fs), "wu": (D, Fs), "wd": (Fs, D)}
    return shapes


def _auto_groups(T: int) -> int:
    """Dispatch group count (the reference's): a power of two, about 4096
    tokens per group, one group for small inputs."""
    g = 1
    while g < 256 and T // (2 * g) >= 4096:
        g *= 2
    return g


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, a tie going to the lower index. A stable descending
    sort keeps tied values in index order; ``torch.topk`` leaves the order
    of ties unspecified."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    """Rows each expert takes per group: ``max(1, int(cf * Tg * K / E))``."""
    return max(1, int(cfg.capacity_factor * tokens_per_group * cfg.top_k / cfg.num_experts))


def moe_forward(p, x: torch.Tensor, cfg: MoEConfig,
                compute_dtype: torch.dtype = COMPUTE_DTYPE, aux_loss: bool = False,
                expert_offset: int = 0, reduce: Optional[Callable] = None,
                shared_reduce: Optional[Callable] = None, enter: Optional[Callable] = None):
    """``x (B, L, D)`` -> ``(out, aux)``: the MoE output ``(B, L, D)`` in
    x's dtype and, with ``aux_loss``, the Switch load-balancing loss
    ``router_aux_weight * E * sum(mean probs * share of tokens whose first
    choice is the expert)``, a float32 scalar (else None). Tokens split into
    :func:`_auto_groups` dispatch groups, as the reference's default. The
    router's softmax is float32, then top-k, then the renormalisation of
    the kept weights (``norm_topk_prob``).

    Tensor parallel (plan ``heads``; ``x`` is then the global batch, and the
    router is whole, so the routing, the capacity and the drops are the
    global batch's): with expert parallelism the expert weights are this
    rank's ``E_local = wg.shape[0]`` experts from ``expert_offset``, and
    the rank fills and runs only their slots of the ``(G, E, C, D)``
    buffer; with expert-TP they are its block of ``d_ff_expert``. Either
    way the rank's combine is a partial of the routed output, summed in
    float32 by ``reduce`` before the one rounding; ``shared_reduce`` sums
    the shared expert's row-parallel ``wd`` product (:func:`ffn_forward`).
    ``enter`` (training under tensor parallelism: identity forward, the
    cotangent summed over ``model`` backward) takes what each rank uses
    only in part -- the float32 input of the experts (and of a split shared
    expert) and the routing weights of the partial combine -- while the
    router runs on ``x`` itself, whole on every rank, so its gradient and
    the aux loss's are whole too."""
    B, L, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    El = p["wg"].shape[0]                                    # the experts held here
    T = B * L
    G = _auto_groups(T)
    while T % G:
        G //= 2
    Tg = T // G
    dev = x.device
    xt = x.reshape(G, Tg, D).to(compute_dtype)
    xe = xt                                   # the experts' input
    if enter is not None and reduce is not None:
        xe = enter(x).reshape(G, Tg, D).to(compute_dtype)

    logits = (xt @ p["router"].to(compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)                    # (G, Tg, E)
    gate_w, gate_idx = top_k(probs, K)                       # (G, Tg, K)
    if cfg.norm_topk_prob:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # ---- capacity-limited sort-based dispatch (fixed shapes) ----
    C = capacity(cfg, Tg)
    TK = Tg * K
    flat_e = gate_idx.reshape(G, TK)
    order = torch.argsort(flat_e, dim=-1, stable=True)       # pairs by expert
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    first_of_e = torch.searchsorted(sorted_e, experts, side="left")       # (G, E)
    counts = torch.diff(torch.cat([first_of_e, torch.full((G, 1), TK, device=dev)], dim=1),
                        dim=1)                                            # (G, E)
    pos_in_e = torch.arange(TK, device=dev)[None, :] - torch.gather(first_of_e, 1, sorted_e)
    keep = pos_in_e < C                                      # (G, TK)
    tok_of_pair = order // K
    cols = torch.arange(C, device=dev)[None, None, :]
    # buf[g, e, c] = token of the pair at sorted position first_of_e + c,
    # for the held experts [expert_offset, expert_offset + El)
    held = slice(expert_offset, expert_offset + El)
    slot_src = (first_of_e[:, held, None] + cols).reshape(G, El * C)
    slot_valid = (cols < counts[:, held, None]).reshape(G, El * C)
    src_tok = torch.gather(tok_of_pair, 1, torch.clamp(slot_src, 0, TK - 1))
    buf = torch.gather(xe, 1, src_tok[..., None].expand(G, El * C, D))
    buf = torch.where(slot_valid[..., None], buf, torch.zeros((), dtype=buf.dtype, device=dev))
    buf = buf.reshape(G, El, C, D)

    # ---- expert computation ----
    wg = p["wg"].to(compute_dtype)
    wu = p["wu"].to(compute_dtype)
    wd = p["wd"].to(compute_dtype)
    h = silu(torch.einsum("gecd,edf->gecf", buf, wg)) * torch.einsum("gecd,edf->gecf", buf, wu)
    y = torch.einsum("gecf,efd->gecd", h, wd).to(compute_dtype)          # (G, El, C, D)

    # ---- combine (gather back) ----
    if El != E:                   # the pairs routed to the held experts
        keep = keep & (sorted_e >= expert_offset) & (sorted_e < expert_offset + El)
    y_flat = y.reshape(G, El * C, D)
    slot_of_pair = torch.where(keep, (sorted_e - expert_offset) * C + pos_in_e,
                               torch.zeros_like(pos_in_e))
    y_sorted = torch.gather(y_flat, 1, slot_of_pair[..., None].expand(G, TK, D))
    y_sorted = torch.where(keep[..., None], y_sorted,
                           torch.zeros((), dtype=y_sorted.dtype, device=dev))
    inv = torch.argsort(order, dim=-1, stable=True)
    y_pairs = torch.gather(y_sorted, 1, inv[..., None].expand(G, TK, D)).reshape(G, Tg, K, D)
    # the weights rounded to the compute dtype, then products and sum in
    # float32, rounded once: what XLA's fusion of the reference's
    # ``sum(gate_w.astype(cd) * y_pairs)`` computes under jit (the engine's
    # steps and the model's scanned stages; op by op, eagerly, it rounds
    # each product instead)
    if enter is not None and reduce is not None:
        gate_w = enter(gate_w)
    out = (gate_w.to(compute_dtype).float()[..., None] * y_pairs.float()).sum(dim=2)
    if reduce is not None:
        out = reduce(out)
    out = out.to(compute_dtype)

    out = out.to(x.dtype)
    if cfg.d_ff_shared:
        # added in x's dtype: under jit XLA drops the reference's rounding of
        # the sum to the compute dtype where the result is widened after
        shared = ffn_forward(p["shared"], xt if shared_reduce is None else xe, kind="swiglu",
                             compute_dtype=compute_dtype, reduce=shared_reduce)
        out = (out.to(compute_dtype) + shared).to(x.dtype)
    aux = None
    if aux_loss:
        me = probs.mean(dim=(0, 1))                                   # (E,)
        first = torch.nn.functional.one_hot(gate_idx[..., 0], E).float()
        aux = cfg.router_aux_weight * E * (me * first.mean(dim=(0, 1))).sum()
    return out.reshape(B, L, D), aux
