"""Canonical experiment configurations: the port's twin of
beom_tpu/cases/__init__.py.

Each is a `make_case(**kw, device=...) -> (cfg, grid, forcing, state)`
factory.  The double gyre and the rigid-lid gyre are ported so far.
"""

from beom_tpu_torch.cases import double_gyre, rigid_lid

REGISTRY = {
    "double_gyre": double_gyre.make_case,
    "rigid_lid": rigid_lid.make_case,
}

# where each case that is not yet ported sits in ROADMAP.md's queue 1
NOT_PORTED = {
    "two_layer": "ROADMAP queue 1 item 9 (slice 3: the other fb-path cases)",
    "coastal_wetdry":
        "ROADMAP queue 1 item 9 (slice 3: the other fb-path cases)",
    "shelf_forced":
        "ROADMAP queue 1 item 9 (slice 3: the other fb-path cases)",
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
