"""Reflect-101 padding by an index map (jnp.pad mode='reflect').

``F.pad(mode="reflect")`` refuses a pad as wide as the axis; jnp.pad
reflects again.  That happens on the coarse pyramid levels of small
clips (a 10x12 level under the 21x21 GFTT box), so the port builds the
source index of every padded position itself: reflect-101 is periodic
with period 2(n-1).  The CUDA kernels that read reflect-padded data
(``csrc/gftt.cu``) use the same formula.
"""

from __future__ import annotations

import torch


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """(before + n + after,) int64 source indices of a reflect-101 pad."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def reflect_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-101 pad of the last two axes by ph rows and pw columns a side."""
    H, W = x.shape[-2:]
    ys = reflect_index(H, ph, ph, x.device)
    xs = reflect_index(W, pw, pw, x.device)
    return x.index_select(-2, ys).index_select(-1, xs)
