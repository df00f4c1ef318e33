"""The one traffic generator: a mix file (traffic/<mix>.json) of lengths
and clients → each client's seeded stream of requests.

A mix's prompt and output lengths follow the exponential law of the mean
its `source` publishes (the one law that a published mean fixes alone, with
no shape parameter of the harness's own), at least `lo`, taken as a pool of
`pool` (prompt, output) pairs at the law's evenly spaced quantiles. A pair
is cut to the engine's context as a server cuts it: the prompt to
max_seq − 2, the output to what the context leaves. Every seed runs the
same pairs at the same points of the loop (`Mix`): the seed changes which
client sends which, and the prompt ids, and not how much work a window
holds. Prompt ids are uniform over [1, vocab) (0 is left out: it is what
the engine pads with), drawn per request from the seed."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Req:
    client: int
    index: int                # the client's request number
    prompt: list
    max_new: int


def quantile_lengths(spec: dict, n: int) -> list[int]:
    """n lengths at the quantiles (i + 0.5) / n of an exponential law of
    mean spec["mean"], each at least spec["lo"]."""
    return [max(spec["lo"], int(round(-spec["mean"] * math.log(1 - (i + 0.5) / n))))
            for i in range(n)]


def pool(mix: dict) -> list[tuple[int, int]]:
    """The mix's (prompt, output) pairs in their one fixed order, cut to
    the context."""
    n, max_seq = int(mix["pool"]), int(mix["max_seq"])
    fixed = np.random.default_rng(0)
    prompts = quantile_lengths(mix["prompt"], n)
    outputs = quantile_lengths(mix["output"], n)
    pairs = []
    for i, j in zip(fixed.permutation(n), fixed.permutation(n)):
        p = min(prompts[i], max_seq - 2)
        pairs.append((p, max(1, min(outputs[j], max_seq - 1 - p))))
    return pairs


class Mix:
    """One traffic mix, seeded. The pool's pairs stand in one fixed order
    (the same for every seed) dealt out round robin to `clients` lanes: lane
    L's k-th request is the pair at L + clients·k. The seed deals the lanes
    to the clients and draws the prompt ids, so that every seed has the same
    sizes in flight at the same point of the loop, in another order."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = vocab
        self.pairs = pool(mix)
        self.clients = int(mix["clients"])
        self.lanes = np.random.default_rng([self.seed, 1]).permutation(self.clients)

    def request(self, client: int, index: int) -> Req:
        """Client `client`'s request number `index`."""
        j = (int(self.lanes[client]) + self.clients * index) % len(self.pairs)
        rng = np.random.default_rng([self.seed, client, index])
        p, out = self.pairs[j]
        return Req(client, index, rng.integers(1, self.vocab, p).tolist(), out)
