"""Training views in a fresh random permutation of the configuration's
views each epoch, each at a random background colour (uniform in
[0, 1]^3).  A request is ``{"view", "bg"}``."""


def more(mix: dict, rng, n_views: int, i: int) -> list:
    """The next epoch."""
    return [{"view": int(v), "bg": rng.uniform(0, 1, 3)}
            for v in rng.permutation(n_views)]
