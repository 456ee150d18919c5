"""Traffic: a mix file (``benchmark/mixes/<name>.json``) names its kind,
and the kind's generator (``benchmark/traffic/<kind>.py``) turns the
mix's parameters and the seed into requests.  A new mix of a known kind
is a data file; a new kind is a new generator file.

Request ``i`` is the same for every reader of the same mix and seed, so
the reference can ask for the requests the program served.
"""

from __future__ import annotations

import importlib

import numpy as np


class Traffic:
    def __init__(self, mix: dict, seed: int, n_views: int = 0):
        self.mix = mix
        self.gen = importlib.import_module(f"{__name__}.{mix['kind']}")
        self.rng = np.random.default_rng(int(seed))
        self.n_views = n_views
        self.cache: list = []

    def __getitem__(self, i: int) -> dict:
        while len(self.cache) <= i:
            self.cache.extend(self.gen.more(self.mix, self.rng, self.n_views,
                                            len(self.cache)))
        return self.cache[i]
