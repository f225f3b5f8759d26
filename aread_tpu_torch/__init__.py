"""aread_tpu_torch — the PyTorch/CUDA port of ``aread_tpu`` for one NVIDIA
H100.

The package mirrors ``aread_tpu``'s layout and names so that each module's
counterpart is found at the same path (``ops/embedding.py``,
``models/aread.py``, ``train/hemp.py``, ``serve/predictor.py``, ...). It
imports torch, numpy, pandas (the CSV loader and the CLIs) and the
standard library only; it never imports JAX or anything of ``aread_tpu``.
``python -m aread_tpu_torch`` trains, ``python -m aread_tpu_torch.serve``
scores a CSV or serves HTTP.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise instead of falling back
(``device.resolve_device``). Every TPU kernel on the ported path is a
hand-written Hopper kernel beside a plain PyTorch version of the same
function; the wrapper takes the plain version only for CPU tensors.
"""

__version__ = "0.1.0"
