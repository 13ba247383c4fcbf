"""Inputs made from the seed. One general generator for each entry kind;
a traffic file (``traffic/<name>.json``) holds only its parameters.

``lm_batch`` draws training text whose token frequencies follow the
Zipf–Mandelbrot law that word counts of natural language follow,
p(rank r) ∝ (r + q)^-a, with a ≈ 1 and q ≈ 2.7 for English (Piantadosi,
"Zipf's word frequency law in natural language", 2014): a few tokens
repeat hundreds of times in a batch of 8,192 and most appear once or
never, as in tokenised text. (The port's ``data/pipeline.
synthetic_lm_batch`` is not copied: its affine recurrences collapse
modulo an even vocabulary, to a few hundred distinct ids in 8,192.)"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

BATCH_TAG = 0xE1FC0DE


def lm_batch(seed: int, step: int, vocab: int, batch: int, seq: int,
             zipf_a: float = 1.0, zipf_q: float = 2.7
             ) -> Dict[str, np.ndarray]:
    """{"tokens", "labels"}: ``[batch, seq]`` int64, the same for the same
    (seed, step); labels are the tokens shifted by one. Token ids are
    drawn by rank from the Zipf–Mandelbrot law, ranks mapped to ids by a
    permutation that the seed fixes for all its steps."""
    ids = np.random.default_rng(
        np.random.SeedSequence([seed, 1, BATCH_TAG])).permutation(vocab)
    cdf = np.cumsum((np.arange(1, vocab + 1) + zipf_q) ** -zipf_a)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 0,
                                                        BATCH_TAG]))
    rank = np.searchsorted(cdf, rng.random((batch, seq + 1)) * cdf[-1])
    toks = ids[np.minimum(rank, vocab - 1)].astype(np.int64)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def prompt_batches(seed: int, vocab: int, batch_tokens: int,
                   lengths: List[int], n: int) -> List[np.ndarray]:
    """``n`` batches of prompts, each of ``batch_tokens`` tokens: batch
    ``i`` holds ``batch_tokens // L`` prompts of the length
    ``L = lengths[i % len(lengths)]`` (a cycle every seed shares), with
    token ids uniform over the vocabulary from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, BATCH_TAG]))
    out = []
    for i in range(n):
        L = lengths[i % len(lengths)]
        out.append(rng.integers(0, vocab, size=(batch_tokens // L, L),
                                dtype=np.int64))
    return out
