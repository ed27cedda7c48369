"""GreenFlow serving on PyTorch and CUDA (NVIDIA Hopper).

A second implementation of the ``repro`` package: the streamed serving
window (reward scoring -> Eq. 10 allocation -> downgrade guard ->
CompactPlan cascade execution -> nearline dual update) over a
``GeneratedSource`` request stream, the model zoo's cells, and the
training path (the train step, checkpoints, the offline experiment),
with hand-written CUDA kernels for every kernel the JAX package wrote
in Pallas and backward kernels where training needs them
(``kernels/csrc``).  The layout mirrors ``repro``: ``core/``,
``cascade/``, ``models/``, ``data/``, ``serving/``, ``training/``,
``kernels/``, ``launch/``, ``experiments.py``.

Every entry point takes an explicit ``device`` and defaults to CUDA; it
raises when no card is present unless the caller asked for the CPU,
where the kernels' plain-torch versions run instead.

Float32 throughout: TF32 is switched off for matmuls and convolutions
so results on the card can be held against the plain path.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
