"""The one generator of served traffic: requests and their arrival times
from a traffic mix's parameters (``traffic/<name>.json``) and a seed.

Arrivals are an open loop at ``rate_rps``: the gaps between them are
``arrival_pool`` evenly spaced quantiles of an exponential of that mean
(Poisson arrivals), in an order drawn from the seed.  Lengths come from a
fixed pool as well: ``pool`` prompt lengths and ``pool`` output lengths at
evenly spaced quantiles of a lognormal of log-spread ``sigma`` clipped to
``[min, max]``, whose median is solved so that the pool's mean is the
mix's ``mean`` (a published mean length), paired by a permutation drawn
from ``length_seed`` and sent in an order drawn from the seed.  So two
seeds offer the same sizes and gaps in another order with other tokens,
and one seed offers the same requests every time.

``first_wave`` requests are due at once when the run starts, each cut to
a share ``(rank + 0.5) / first_wave`` of its lengths for its place in a
seeded order: the requests a server under this load holds in flight,
at spread stages, so that slots turn over at spread times from the start.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np


def quantiles(n: int) -> np.ndarray:
    """The probabilities ``(i + 0.5) / n``."""
    return (np.arange(n) + 0.5) / n


def _pool_at(median: float, sigma: float, lo: int, hi: int,
             z: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi
                   ).astype(np.int64)


def length_pool(spec: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` lengths at the quantiles of the clipped lognormal ``spec``
    (``mean``, ``sigma``, ``min``, ``max``), ascending, whose mean is
    ``spec["mean"]`` to within rounding."""
    z = np.array([statistics.NormalDist().inv_cdf(p) for p in quantiles(n)])
    lo, hi = int(spec["min"]), int(spec["max"])
    mean, sigma = float(spec["mean"]), float(spec["sigma"])
    if not lo < mean < hi:
        raise ValueError(f"mean {mean} outside ({lo}, {hi})")
    a, b = math.log(lo) - 10.0, math.log(hi) + 10.0
    for _ in range(100):                   # the pool's mean rises with it
        mid = 0.5 * (a + b)
        if _pool_at(math.exp(mid), sigma, lo, hi, z).mean() < mean:
            a = mid
        else:
            b = mid
    return _pool_at(math.exp(b), sigma, lo, hi, z)


def gap_pool(rate: float, n: int) -> np.ndarray:
    """``n`` gaps at the quantiles of an exponential of mean ``1 / rate``
    seconds."""
    return -np.log1p(-quantiles(n)) / float(rate)


def longest(mix: Dict[str, Any]) -> int:
    """The most tokens a request of ``mix`` holds: the longest prompt and
    the longest output."""
    return int(mix["prompt_len"]["max"]) + int(mix["output_len"]["max"])


class Traffic:
    """The requests of one run, in the order they arrive.  ``mix`` holds
    the traffic mix's keys and ``harness/serve.py``'s ``pool``,
    ``arrival_pool`` and ``length_seed``."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int):
        n = int(mix["pool"])
        fixed = np.random.default_rng(int(mix["length_seed"]))
        prompts = length_pool(mix["prompt_len"], n)
        outputs = length_pool(mix["output_len"], n)[fixed.permutation(n)]
        rng = np.random.default_rng(int(seed))
        self.pairs: List[Tuple[int, int]] = [
            (int(prompts[i]), int(outputs[i])) for i in rng.permutation(n)]
        self.gaps = rng.permutation(gap_pool(float(mix["rate_rps"]),
                                             int(mix["arrival_pool"])))
        self.wave = int(mix.get("first_wave", 0))
        self.stagger = rng.permutation(self.wave)
        self.vocab = int(vocab)
        self.rng = rng
        self.next = 0

    def _draw(self, share: float = 1.0) -> Tuple[List[int], int]:
        p, o = self.pairs[self.next % len(self.pairs)]
        self.next += 1
        if share < 1.0:
            p, o = max(1, round(p * share)), max(1, round(o * share))
        return self.rng.integers(1, self.vocab, size=p).tolist(), o

    def first_wave(self) -> List[Tuple[List[int], int]]:
        """The requests due at the start, cut to their staggered shares."""
        return [self._draw((int(r) + 0.5) / self.wave) for r in self.stagger]

    def arrivals(self) -> Iterator[Tuple[float, List[int], int]]:
        """``(seconds after the start, prompt, output length)`` of each
        later request, without end."""
        t, i = 0.0, 0
        while True:
            t += float(self.gaps[i % len(self.gaps)])
            i += 1
            prompt, out = self._draw()
            yield t, prompt, out
