"""Canonical experiment configurations: the port's twin of
beom_tpu/cases/__init__.py.

Each is a `make_case(**kw, device=...) -> (cfg, grid, forcing, state)`
factory:

  1. double_gyre      1-layer barotropic wind-driven double gyre
  2. two_layer        2-layer baroclinic gyre (interfacial coupling)
  3. rigid_lid        elliptic-solve pressure (projection stepping)
  4. coastal_wetdry   irregular coast + wetting/drying slosh
  5. shelf_forced     wind + tide forced 2-layer shelf with OBC / sponge
"""

from beom_tpu_torch.cases import (coastal_wetdry, double_gyre, rigid_lid,
                                  shelf_forced, two_layer)

REGISTRY = {
    "double_gyre": double_gyre.make_case,
    "two_layer": two_layer.make_case,
    "rigid_lid": rigid_lid.make_case,
    "coastal_wetdry": coastal_wetdry.make_case,
    "shelf_forced": shelf_forced.make_case,
}


def make_case(name: str, **kw):
    """Look up a canonical case by name and build it."""
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown case {name!r}; available: {sorted(REGISTRY)}") from None
    return factory(**kw)
