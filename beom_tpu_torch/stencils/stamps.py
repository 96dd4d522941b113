"""The opt-in timing mode of the persistent kernels (K5, K6): the kernel's
own span on the device from %globaltimer stamps inside it
(csrc/coop_stamps.cuh).

A caller passes `stamps=Stamps()` to a launch; after it the object holds,
in ms: `span` (the earliest entry of any CTA to the latest exit), `cta0`
(CTA 0's entry to its exit) and, where the kernel marks it, `setup` (CTA
0's entry to the end of its set-up passes).  It costs one small copy
before the launch and a wait for the kernel after it, so it stays off on
the main path.
"""

from __future__ import annotations

import torch

_NSTAMP = 5                     # csrc/coop_stamps.cuh NSTAMP
_ENTRY0, _SETUP0, _EXIT0, _MIN_ENTRY, _MAX_EXIT = range(_NSTAMP)


class Stamps:
    """One launch's times in ms, filled by `fill`."""

    def __init__(self):
        self.span = self.cta0 = self.setup = None
        self.buffer = None

    def arm(self, device) -> int:
        """The device buffer's address for the launch, its stamps reset:
        the earliest entry to ~0, the rest to 0."""
        init = torch.zeros(_NSTAMP, dtype=torch.int64)
        init[_MIN_ENTRY] = -1
        self.buffer = init.to(device)
        return self.buffer.data_ptr()

    def fill(self) -> "Stamps":
        """Wait for the launch and read its stamps."""
        s = [int(v) % (1 << 64) for v in self.buffer.cpu().tolist()]
        self.span = (s[_MAX_EXIT] - s[_MIN_ENTRY]) / 1e6
        self.cta0 = (s[_EXIT0] - s[_ENTRY0]) / 1e6
        if s[_SETUP0]:
            self.setup = (s[_SETUP0] - s[_ENTRY0]) / 1e6
        return self
