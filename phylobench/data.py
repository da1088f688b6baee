"""A configuration's data drawn from the seed, shared by its loaders: the
random tree, the model and the tip states simulated on the device; and
the loaded cell that the request kinds drive.

The tree and its lengths come from ``numpy.random.default_rng(seed)``,
every site draw from a ``torch.Generator`` on the device seeded with the
same seed, so the same seed gives the same inputs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from phylobench.model import Rooted, model_arrays, random_binary_tree
from phylobench.simulate import simulate


def seed63(seed: int) -> int:
    """The seed as a non-negative 63-bit integer."""
    return int(seed) % (1 << 63)


class Stopwatch:
    """Seconds of each named stage since the one before."""

    def __init__(self):
        self.t, self.stages = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.stages[name] = now - self.t
        self.t = now


def draw(config: dict, seed: int, device):
    """(edges, lengths, rooted, model, tips): the tree (int32 [2n−3, 2],
    float64 [2n−3]), the model's float64 arrays and the tip states
    (uint8 [n_taxa, n_sites] on ``device``) of ``config``."""
    rng = np.random.default_rng(seed63(seed))
    tr = config["tree"]
    if tr["recipe"] != "random_binary":
        raise ValueError(f"unknown tree recipe {tr['recipe']!r}")
    n = int(config["n_taxa"])
    edges, lengths = random_binary_tree(rng, n, float(tr["min_len"]),
                                        float(tr["max_len"]))
    rooted = Rooted(edges, n)
    model = model_arrays(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed63(seed))
    tips = simulate(rooted, lengths, model, int(config["n_sites"]), gen,
                    device)
    if not all(bool((tips == s).any()) for s in range(config["states"])):
        raise ValueError("a state never occurs in the simulated sites")
    return edges, lengths, rooted, model, tips


@dataclasses.dataclass
class Loaded:
    """A configuration loaded for a run.

    The benchmark's own inputs (``edges``, ``lengths``, ``rooted``,
    ``model``, ``tips``: uint8 states on the host) serve the reference;
    ``part`` and ``tree`` are the program's. ``shape`` holds n_tips,
    n_patterns (compressed, unpadded, counted by the benchmark), C, S
    and n_codes."""
    config: dict
    edges: np.ndarray
    lengths: np.ndarray
    rooted: Rooted
    model: dict
    tips: torch.Tensor
    shape: dict
    part: object = None
    tree: object = None
    timings: dict = dataclasses.field(default_factory=dict)

    def release(self) -> None:
        """Drop the program's partition (the reference runs after)."""
        self.part = None
