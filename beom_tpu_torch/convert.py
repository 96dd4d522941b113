"""Carry a configuration and its arrays between beom_tpu and the port.

`from_reference` takes the reference's Config as a dict
(`dataclasses.asdict`) and its Grid, Forcing and State leaves as numpy
arrays (mappings of field name to array, or objects with those
attributes), and returns the port's (cfg, grid, forcing, state) on
`device`.  `to_numpy` goes back the other way.  The backend names map
'xla' <-> 'eager' and 'pallas' <-> 'fused'.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State

_TO_PORT = {"xla": "eager", "pallas": "fused"}
_TO_REFERENCE = {v: k for k, v in _TO_PORT.items()}


def _leaf(src, name, default=KeyError):
    if isinstance(src, Mapping):
        return src[name] if default is KeyError else src.get(name, default)
    return getattr(src, name) if default is KeyError \
        else getattr(src, name, default)


def _tensors(cls, src, device):
    kw = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(_leaf(src, f.name))
        kw[f.name] = torch.tensor(a, device=device)
    return cls(**kw)


def from_reference(cfg_dict: Mapping, grid, forcing, state, device):
    """The port's (cfg, grid, forcing, state) from the reference's."""
    d = dict(cfg_dict)
    d["backend"] = _TO_PORT[d["backend"]]
    cfg = Config(**d)

    def tensor(name, default=KeyError):
        a = _leaf(state, name, default)
        return None if a is None else torch.tensor(np.asarray(a),
                                                   device=device)

    st = State(h=tensor("h"), u=tensor("u"), v=tensor("v"),
               t=cfg.npdtype.type(np.asarray(_leaf(state, "t"))),
               n=int(np.asarray(_leaf(state, "n"))),
               phi=tensor("phi", None), phi_prev=tensor("phi_prev", None))
    return (cfg, _tensors(Grid, grid, device),
            _tensors(Forcing, forcing, device), st)


def to_numpy(cfg: Config, grid: Grid, forcing: Forcing, state: State):
    """(cfg dict with the reference's backend name, grid, forcing and
    state as dicts of numpy arrays) for the reference's constructors."""
    d = dataclasses.asdict(cfg)
    d["backend"] = _TO_REFERENCE[d["backend"]]

    def arrays(obj):
        return {f.name: getattr(obj, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(obj)}

    st = {"h": state.h.detach().cpu().numpy(),
          "u": state.u.detach().cpu().numpy(),
          "v": state.v.detach().cpu().numpy(),
          "t": np.asarray(state.t, cfg.npdtype),
          "n": np.asarray(state.n, np.int32)}
    for name in ("phi", "phi_prev"):
        if getattr(state, name) is not None:
            st[name] = getattr(state, name).detach().cpu().numpy()
    return d, arrays(grid), arrays(forcing), st
