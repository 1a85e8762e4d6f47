"""Dropout drawn from an explicit generator, the counterpart of flax's
``nn.Dropout``: keep each entry with probability 1 - rate and scale the kept
ones by 1/(1 - rate).  The port never uses torch's global generator, so a
train step is reproducible from the generator's seed."""
from __future__ import annotations

from typing import Optional

import torch


def require_generator(generator: Optional[torch.Generator], rate: float,
                      what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} at rate {rate} needs a generator: pass "
                         f"generator=torch.Generator(device) to forward")
    return generator


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            block: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """``x`` with dropout at ``rate``; the identity at rate 0.  ``block`` =
    (dim, index, count): ``x`` is block ``index`` of ``count`` equal blocks
    of ``dim`` of a whole tensor (a tensor-parallel rank's slice), and
    takes that block of the whole tensor's mask, so the generator draws
    what it draws for the whole tensor."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    gen = require_generator(generator, rate, "dropout")
    shape = list(x.shape)
    if block is not None:
        shape[block[0]] *= block[2]
    keep = torch.empty(shape, device=x.device).bernoulli_(1.0 - rate,
                                                          generator=gen)
    if block is not None:
        keep = keep.chunk(block[2], block[0])[block[1]]
    return x * (keep * (1.0 / (1.0 - rate))).to(x.dtype)
