"""Device policy of the port.

The device is always explicit and defaults to ``"cuda"``.  Asking for
CUDA where there is none raises; nothing carries on quietly on the
CPU.  The CPU runs only when a caller names it (the parity tests do),
and then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


def strict_fp32() -> None:
    """Keep float32 matrix products and convolutions in full float32.

    cuDNN convolutions default to TF32 (about three decimal digits); the
    main path is held to the JAX reference in float32, so both switches
    are set explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_constant(values: Sequence, device: torch.device | str, dtype: torch.dtype = torch.float32,
                    shape: Sequence[int] | None = None) -> torch.Tensor:
    """A small constant tensor made on ``device`` by fills, with no copy
    from the host: one zero fill, then one fill for each value that is
    not +0.

    ``torch.tensor(..., device="cuda")`` copies from pageable host
    memory, which waits for the stream and is refused while a CUDA graph
    is captured; a fill is an ordinary kernel.  Each value is rounded to
    ``dtype`` as ``torch.tensor`` rounds it.
    """
    out = torch.zeros(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        if v != 0 or math.copysign(1.0, v) < 0:
            out[i].fill_(v)
    return out if shape is None else out.reshape(tuple(shape))


def fetch_packed(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor to the host in ONE copy: flattened into one float64
    vector on the device (exact for float32 values, bools and integers
    below 2**53), copied, and split back into numpy arrays of the
    original shapes and dtypes."""
    names = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).to(torch.float64) for k in names]).cpu().numpy()
    out, pos = {}, 0
    for k in names:
        t = tensors[k]
        size = t.numel()
        dtype = {torch.bool: np.bool_, torch.float32: np.float32}.get(t.dtype, np.int64)
        out[k] = flat[pos:pos + size].astype(dtype).reshape(tuple(t.shape))
        pos += size
    return out
