"""Speculative-decoding configuration + the prompt-lookup n-gram drafter: the
port of modalities_tpu/serving/spec_decode.py (pure Python, its own copy).

The default drafter costs zero extra model: it proposes the k tokens that
followed the most recent earlier occurrence of the request's own trailing
n-gram (prompt-lookup decoding — great on repetitive continuations, harmless
on novel text because a wrong proposal just verifies to accept-length 0).
Proposals are verified by ONE batched target forward over `[slots, k+1]`
(engine `_spec_verify_dispatch` -> model `verify_paged`), so greedy output is
the plain-decode trajectory whatever the drafter proposes.

The drafter is deterministic (pure function of the token context), which is
what keeps preemption replay bitwise: a re-admitted request re-proposes the
same drafts and the greedy trajectory is proposal-independent anyway.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SpecDecodeConfig:
    """`spec_decode` config block (serving config / engine kwarg / env).

    k=0 disables speculation entirely (the engine never runs the verify
    forward). `ngram_max >= ngram_min >= 1` bound the suffix n-gram the
    prompt-lookup drafter matches, longest first."""

    k: int = 0
    drafter: str = "ngram"
    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"spec_decode.k must be >= 0, got {self.k}")
        if self.drafter != "ngram":
            raise ValueError(
                f"spec_decode.drafter={self.drafter!r}: only 'ngram' "
                "(prompt-lookup) is implemented"
            )
        if self.k > 0 and not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError(
                f"spec_decode needs 1 <= ngram_min <= ngram_max, got "
                f"{self.ngram_min}..{self.ngram_max}"
            )

    @property
    def enabled(self) -> bool:
        return self.k > 0

    @classmethod
    def from_env(cls) -> "SpecDecodeConfig":
        return cls(k=int(os.environ.get("MODALITIES_TPU_SERVE_SPEC_K", "0")))


def resolve_spec_config(spec) -> SpecDecodeConfig:
    """Engine-kwarg coercion: None -> env default, dict -> config block,
    SpecDecodeConfig passes through."""
    if spec is None:
        return SpecDecodeConfig.from_env()
    if isinstance(spec, SpecDecodeConfig):
        return spec
    if isinstance(spec, dict):
        return SpecDecodeConfig(**spec)
    raise ValueError(f"spec_decode must be None, a dict, or SpecDecodeConfig, got {spec!r}")


def propose_ngram(
    context: list[int], k: int, ngram_max: int, ngram_min: int
) -> Optional[list[int]]:
    """Prompt-lookup proposal: find the MOST RECENT earlier occurrence of the
    longest trailing n-gram of `context` (n from ngram_max down to ngram_min)
    and propose up to k tokens that followed it. None when nothing matches —
    the engine then dispatches a plain 1-token decode for that round, so no
    verify work is wasted."""
    n_ctx = len(context)
    k = int(k)
    for n in range(min(int(ngram_max), n_ctx - 1), int(ngram_min) - 1, -1):
        pattern = context[n_ctx - n :]
        # scan right-to-left: recency wins (the continuation most likely to
        # repeat is the latest one) — but a match too close to the context end
        # has fewer than k followers, so keep scanning for the most recent
        # occurrence with a FULL k followers (on periodic text that's one more
        # period back with the identical continuation) and only fall back to
        # the short recent one when no deeper match exists
        best: Optional[list[int]] = None
        for start in range(n_ctx - n - 1, -1, -1):
            if context[start : start + n] == pattern:
                # start + n <= n_ctx - 1, so at least one follower exists
                follow = context[start + n : start + n + k]
                if len(follow) == k:
                    return follow
                if best is None:
                    best = follow
        if best is not None:
            return best
    return None
