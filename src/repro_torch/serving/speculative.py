"""Draft proposers for speculative (draft-verify) decode (copy of
``repro.serving.speculative``; numpy only).

A proposer guesses the next ``k`` tokens of a request; the engine then
scores all of them in ONE stream-K verify sweep (k+1 stacked query rows
through the chunked-prefill kernels) and keeps the longest prefix the model
itself would have produced — so output is token-identical to plain greedy
decode regardless of draft quality. Drafts only change *throughput*: every
accepted draft amortizes one more logit row onto the same KV read.

The protocol is deliberately tiny so model-based drafters plug in::

    class DraftProposer(Protocol):
        def propose(self, req, k) -> list[int]: ...

``req`` is the engine's :class:`~repro_torch.serving.engine.Request`; the
proposal predicts the tokens that follow ``req.generated[-1]`` (the last
emitted token, whose KV the verify sweep writes). Returning fewer than
``k`` tokens — including none — is always legal; the engine just verifies
a shorter block.
"""
from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = ["DraftProposer", "NGramProposer", "OracleProposer"]


@runtime_checkable
class DraftProposer(Protocol):
    def propose(self, req, k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``req``'s stream."""
        ...


class NGramProposer:
    """Prompt-lookup drafting, the in-tree default: match the tail n-gram
    of (prompt + generated) against its latest earlier occurrence in the
    same sequence and propose the tokens that followed it. Costs no extra
    forward pass, and is strong exactly where speculative decode pays off
    most — repetitive or structured continuations (code, quotes, lists).
    Longer matches are preferred (``n`` down to ``min_n``); no match means
    no drafts, which degrades gracefully to plain decode."""

    def __init__(self, n: int = 3, min_n: int = 1):
        if not (1 <= min_n <= n):
            raise ValueError(f"need 1 <= min_n <= n, got n={n} min_n={min_n}")
        self.n = n
        self.min_n = min_n

    def propose(self, req, k: int) -> List[int]:
        if k < 1:
            return []
        hist = [int(t) for t in np.asarray(req.prompt).tolist()]
        hist += [int(t) for t in req.generated]
        L = len(hist)
        for n in range(min(self.n, L - 1), self.min_n - 1, -1):
            pat = hist[L - n:]
            for start in range(L - n - 1, -1, -1):
                if hist[start : start + n] == pat:
                    nxt = hist[start + n : start + n + k]
                    if nxt:
                        return nxt
        return []


class OracleProposer:
    """Replays pre-recorded greedy streams — the synthetic proposer behind
    the ``speculative`` bench suite. ``streams`` maps request uid to the
    token stream a non-speculative greedy run produced; at
    ``accept_rate=1.0`` every draft verifies, measuring the pure
    kernel-amortization upper bound (one KV sweep over k+1 rows).

    ``accept_rate < 1`` corrupts each draft position independently with
    probability ``1 - accept_rate``. Corruption is deterministic per
    ``(seed, uid, position)``, so a sweep over accept rates is exactly
    reproducible. A corrupted draft rejects at verify, which also rejects
    everything after it — realized block acceptance is geometric, like a
    real imperfect drafter's."""

    def __init__(
        self,
        streams: Dict[int, Sequence[int]],
        accept_rate: float = 1.0,
        seed: int = 0,
    ):
        if not (0.0 <= accept_rate <= 1.0):
            raise ValueError(f"accept_rate must be in [0, 1]: {accept_rate}")
        self.streams = {
            int(u): [int(t) for t in s] for u, s in streams.items()
        }
        self.accept_rate = accept_rate
        self.seed = seed

    def propose(self, req, k: int) -> List[int]:
        ref = self.streams.get(int(req.uid))
        if ref is None or k < 1:
            return []
        pos = len(req.generated)
        true = ref[pos : pos + k]
        if self.accept_rate >= 1.0:
            return list(true)
        out = []
        for i, t in enumerate(true):
            rng = np.random.default_rng(
                abs(hash((self.seed, int(req.uid), pos + i))) % (2**32)
            )
            if rng.random() < self.accept_rate:
                out.append(t)
            else:
                # any in-vocab token != t rejects at verify
                out.append(t - 1 if t > 0 else 1)
        return out
