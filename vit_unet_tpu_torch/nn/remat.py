"""Activation checkpointing of one block, the counterpart of flax's
``nn.remat`` in ``vit_unet_tpu/models/vit_unet.py``.

``torch.utils.checkpoint`` (non-reentrant) keeps only the block's input and
runs the block again in the backward to rebuild what the gradients need.
The port draws every dropout mask and kernel seed from an explicit
``torch.Generator`` and updates the head-mix BatchNorm's running statistics
inside the forward, neither of which checkpoint's ``preserve_rng_state``
covers.  So the recomputation here sets the generator back to its state
before the block's first run and the block's buffers back to their values
then (the same masks, seeds and, for ``bn_track``, the same normalising
statistics), and afterwards restores both as the first run left them:
the recomputation draws nothing and updates nothing, as JAX's, which runs
the block again on the same rng and discards its side effects.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def checkpointed(block: nn.Module, x: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None, **kwargs):
    """``block(x, generator=generator, **kwargs)``, its activations
    recomputed in the backward.  Without autograd it is the plain call."""
    if not torch.is_grad_enabled():
        return block(x, generator=generator, **kwargs)
    buffers = list(block.buffers())
    before = ([b.detach().clone() for b in buffers],
              None if generator is None else generator.get_state())
    runs = []

    def run(inp):
        if not runs:          # the forward
            runs.append(True)
            return block(inp, generator=generator, **kwargs)
        after = ([b.detach().clone() for b in buffers],
                 None if generator is None else generator.get_state())
        _set(buffers, generator, before)
        try:
            return block(inp, generator=generator, **kwargs)
        finally:
            _set(buffers, generator, after)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


@torch.no_grad()
def _set(buffers, generator, state) -> None:
    values, gen_state = state
    for buf, val in zip(buffers, values):
        buf.copy_(val)
    if generator is not None:
        generator.set_state(gen_state)
