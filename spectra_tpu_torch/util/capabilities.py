"""Device resolution for the port's entry points.

The JAX package probes its runtime for callbacks and complex support
(:mod:`spectra_tpu.util.capabilities`). The port needs one probe: is
there a CUDA device. Entry points take ``device=None``, which means
the GPU; without one they raise instead of running on the CPU. Callers
that want the CPU (the tests) ask for it by name.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
