"""Prompt-lookup drafting for speculative decoding (counterpart of
`paddle_tpu/inference/spec.py`).

The paged engine's verify step scores k drafted tokens plus the committed
last token in one forward; this module is the host half that makes the
drafts.  There is no second model: a slot drafts by n-gram lookup over its
own history (prompt and every token emitted so far), so traffic whose
continuations repeat (templates, a shared document quoted back) is the
traffic that gains.  Greedy equivalence does not depend on draft quality:
the verify step accepts draft i only while it equals the model's own greedy
token, so a bad draft costs idle positions of the window, never a wrong
token.

One instance per engine slot, mutated only by the scheduler under the
engine's lock.
"""

from __future__ import annotations


class NgramDrafter:
    """Per-slot prompt-lookup drafter (reference: spec.py:27).

    Indexes every n-gram (n = max_ngram .. 1) of the history as it grows;
    `propose(k)` matches the history's current n-token suffix against the
    latest earlier occurrence and returns the tokens that followed it,
    longest order first, at most k of them, possibly none.  The index keeps
    the latest two occurrences per n-gram: the latest occurrence of the
    current suffix is the suffix itself (nothing follows it), so the lookup
    falls back to the one before.
    """

    def __init__(self, max_ngram=3):
        self.max_ngram = max(1, int(max_ngram))
        self.tokens = []
        # order -> {ngram -> (previous_start, latest_start)}, a start being
        # the index of the token that follows the occurrence
        self._index = {n: {} for n in range(1, self.max_ngram + 1)}

    def __len__(self):
        return len(self.tokens)

    def reset(self, history):
        """Rebuild from `history` (the prompt plus the tokens emitted so
        far); returns self."""
        self.tokens = []
        self._index = {n: {} for n in range(1, self.max_ngram + 1)}
        for t in history:
            self.extend(t)
        return self

    def extend(self, tok):
        """Append one committed token and index the n-grams it completes."""
        self.tokens.append(int(tok))
        end = len(self.tokens)
        for n in range(1, min(self.max_ngram, end) + 1):
            d = self._index[n]
            key = tuple(self.tokens[end - n:end])
            prev = d.get(key)
            d[key] = (prev[1] if prev is not None else None, end)

    def propose(self, k):
        """Up to `k` draft tokens continuing the history, longest matching
        n-gram first; [] when no earlier occurrence exists.  A match that
        sits p < k tokens from the end bets that the stream repeats with
        period p, and the draft repeats that cycle out to k tokens (a
        constant run, the usual greedy attractor, would otherwise draft one
        token per window)."""
        k = int(k)
        if k <= 0 or not self.tokens:
            return []
        L = len(self.tokens)
        for n in range(min(self.max_ngram, L), 0, -1):
            starts = self._index[n].get(tuple(self.tokens[L - n:]))
            if starts is None:
                continue
            for j in starts[::-1]:  # latest occurrence first, then previous
                if j is not None and j < L:
                    if j + k <= L:
                        return self.tokens[j:j + k]
                    p = L - j
                    return [self.tokens[j + (i % p)] for i in range(k)]
        return []
