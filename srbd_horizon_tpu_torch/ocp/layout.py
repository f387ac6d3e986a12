"""Named variable layouts over flat state/input vectors (the port of
srbd_horizon_tpu/ocp/layout.py)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


class VarLayout:
    """An ordered mapping name -> contiguous slice of a flat vector."""

    def __init__(self, entries: List[Tuple[str, int]]):
        self.names: List[str] = [n for n, _ in entries]
        self.sizes: Dict[str, int] = dict(entries)
        self.slices: Dict[str, slice] = {}
        off = 0
        for name, size in entries:
            self.slices[name] = slice(off, off + size)
            off += size
        self.total = off

    def unpack(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Split a flat vector (or batch) into the named blocks."""
        return {n: vec[..., self.slices[n]] for n in self.names}
