"""Device choice and float32 matmul precision.

The entry points (``IndexBundle.build_from_chunks``/``load``,
``FusedQueryEngine``) take an explicit ``device``. Without one they run on
``cuda``; with no device given and no CUDA present they raise. There is no
silent CPU path: the CPU is used only when the caller asks for it, as the
tests do.

The projection and BM25 matmuls must stay full float32, as in the JAX
package, so this module pins both of PyTorch's TF32 switches off when it is
imported:

- ``torch.backends.cuda.matmul.allow_tf32 = False`` (float32 matmuls in
  full precision; PyTorch's default too, pinned here so that no caller's
  setting leaks in);
- ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch defaults it to True;
  the port runs no convolution, pinned for the same reason).
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``. A CUDA
    device, named or by default, raises when no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the port "
            "on the CPU")
    return dev
