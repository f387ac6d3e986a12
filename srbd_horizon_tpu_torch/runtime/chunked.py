"""Cache-blocked fleet execution (the port of
srbd_horizon_tpu/runtime/chunked.py): run a batched function over
fixed-size slices of the fleet, one after another, and concatenate the
results. Each member's computation is independent, so the results match
the unchunked call up to reduction order."""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree


def chunk_map(fn: Callable, chunk_size: int) -> Callable:
    """Wrap `fn` — whose every input and output leaf carries the fleet on
    its leading axis — so that it runs in `chunk_size`-member slices. The
    fleet size must be a multiple of `chunk_size`."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")

    def wrapped(*args):
        leaves, spec = pytree.tree_flatten(args)
        if not leaves:
            return fn(*args)
        batch = leaves[0].shape[0]
        if batch % chunk_size != 0:
            raise ValueError(
                f"fleet size {batch} is not a multiple of chunk_size "
                f"{chunk_size}"
            )
        n_chunks = batch // chunk_size
        if n_chunks == 1:
            return fn(*args)
        for leaf in leaves:
            if leaf.dim() == 0 or leaf.shape[0] != batch:
                raise ValueError(
                    "chunk_map requires every input leaf to carry the "
                    f"fleet batch ({batch}) on its leading axis; got "
                    f"shape {tuple(leaf.shape)}"
                )
        outs = []
        for i in range(n_chunks):
            sl = slice(i * chunk_size, (i + 1) * chunk_size)
            outs.append(fn(*pytree.tree_unflatten([l[sl] for l in leaves], spec)))
        out_leaves = [pytree.tree_flatten(o)[0] for o in outs]
        out_spec = pytree.tree_flatten(outs[0])[1]
        return pytree.tree_unflatten(
            [torch.cat(parts, dim=0) for parts in zip(*out_leaves)], out_spec
        )

    return wrapped
