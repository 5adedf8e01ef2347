"""Threefry-2x32 counter PRNG, bit for bit as ``jax.random`` draws it.

The RANSAC hypotheses of the JAX package come from
``jax.random.uniform(fold_in(PRNGKey(seed + salt), pair), (n_hyp, m))``
with the default threefry2x32 implementation and partitionable bit
generation.  Reproducing those bits makes the port's robust fits
directly comparable with the reference's.

A key is a (..., 2) int64 tensor holding two uint32 words.  The 32-bit
arithmetic runs in int64 and is masked back to 32 bits after every
add and rotate; every function works on any device, and the keys
are made there by fills (no copy from the host, so a CUDA graph can
capture them).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.device import device_constant

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000  # float32 1.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counters (x0, x1) under key (k0, k1).

    All arguments are broadcastable int64 tensors holding uint32 values.
    """
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _MASK
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed mod 2**32]."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} does not fit a 32-bit PRNG seed")
    return device_constant((0, seed & _MASK), device, torch.int64)


def fold_in(key: torch.Tensor, data: torch.Tensor | int) -> torch.Tensor:
    """``jax.random.fold_in`` of every element of ``data`` into ``key``.

    key (2,) or (..., 2); data an int or int tensor.  Returns keys of
    shape broadcast(key[..., 0], data) + (2,).
    """
    if isinstance(data, torch.Tensor):
        data = data.to(key.device, torch.int64) & _MASK
    else:
        data = torch.full((), int(data) & _MASK, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: (*keys.shape[:-1], *shape) int64.

    Partitionable threefry: element i of the row-major iota is hashed
    as counters (hi(i), lo(i)) and the two output words are xor-ed.
    """
    count = int(np.prod(shape))
    if count >= 1 << 32:
        raise ValueError("random_bits supports fewer than 2**32 elements per key")
    lo = torch.arange(count, dtype=torch.int64, device=keys.device)
    k0 = keys[..., 0, None]
    k1 = keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return (y0 ^ y1).reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32, per key."""
    bits = random_bits(keys, shape)
    float_bits = (bits >> 9) | _ONE_BITS
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)


def keys_from_jax(keys: np.ndarray, device: torch.device | str = "cpu") -> torch.Tensor:
    """uint32 (..., 2) JAX key data -> the port's int64 key tensor."""
    arr = np.asarray(keys, dtype=np.uint32).astype(np.int64)
    return torch.as_tensor(arr, device=device)


def keys_to_jax(keys: torch.Tensor) -> np.ndarray:
    """The port's key tensor -> uint32 (..., 2) JAX key data."""
    return (keys.cpu().numpy() & _MASK).astype(np.uint32)
