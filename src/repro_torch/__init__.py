"""PyTorch/CUDA port of the OGASched reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
sub-package layout and function names (``core``, ``kernels``, ``sched``,
and for the LM substrate's serving path ``configs``, ``models``,
``serve``, ``launch``) so each function has one counterpart. It imports
``torch`` and numpy and nothing of JAX or ``repro``. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``
(``device.resolve_device``); on the card the fused OGA step, the sortscan
and bisection projections and flash attention are hand-written CUDA
kernels (``kernels/csrc``), on the CPU their plain PyTorch versions.
"""
from repro_torch.device import resolve_device  # noqa: F401
