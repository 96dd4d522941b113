"""Canonical experiment configurations: the port's twin of
beom_tpu/cases/__init__.py.

Each is a `make_case(**kw, device=...) -> (cfg, grid, forcing, state)`
factory.  Only the double gyre is ported so far.
"""

from beom_tpu_torch.cases import double_gyre

REGISTRY = {
    "double_gyre": double_gyre.make_case,
}

# where each case that is not yet ported sits in ROADMAP.md's queue 1
NOT_PORTED = {
    "two_layer": "ROADMAP queue 1 item 9 (slice 2: the other fb-path cases)",
    "coastal_wetdry":
        "ROADMAP queue 1 item 9 (slice 2: the other fb-path cases)",
    "shelf_forced":
        "ROADMAP queue 1 item 9 (slice 2: the other fb-path cases)",
    "rigid_lid": "ROADMAP queue 1 item 11 (slice 4: the projection schemes)",
}


def make_case(name: str, **kw):
    """Look up a canonical case by name and build it."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"case {name!r} is not ported to beom_tpu_torch yet: "
            f"{NOT_PORTED[name]}")
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown case {name!r}; available: {sorted(REGISTRY)}") from None
    return factory(**kw)
