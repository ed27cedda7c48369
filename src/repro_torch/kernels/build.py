"""Build the CUDA kernels from ``kernels/csrc`` at first use.

``torch.utils.cpp_extension.load`` compiles the kernels (``KERNELS``:
kernel name -> its ``csrc/*.cu`` source, plain CUDA with a C launcher,
no PyTorch headers, for ``sm_90a``) and their PyTorch binding
``csrc/bind.cpp`` into one extension.  ninja compiles the sources in parallel and rebuilds only
when a source or a flag changed.

The build directory defaults to ``build/kernels`` at the repository
root (listed in ``.gitignore``); ``REPRO_TORCH_BUILD_DIR`` overrides it.
The compiler is ``$CUDA_HOME/bin/nvcc``.  A missing compiler or a failed
compile raises: there is no fallback.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = {"cascade_truncate": "cascade_truncate.cu",
           "target_attention": "target_attention.cu",
           "embedding_bag": "embedding_bag.cu",
           "dot_interact": "dot_interact.cu",
           "cin_layer": "cin.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_wgmma": "flash_attention_wgmma.cu",
           "target_attention_bwd": "target_attention_bwd.cu",
           "embedding_bag_bwd": "embedding_bag_bwd.cu",
           "dot_interact_bwd": "dot_interact_bwd.cu",
           "cin_layer_bwd": "cin_bwd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}
CUDA_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3"]

_LOCK = threading.Lock()
_EXT = None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def load(*, verbose: bool = False):
    """The compiled extension module (built on first use).

    Raises RuntimeError when ``nvcc`` is missing or a compile fails."""
    global _EXT
    with _LOCK:
        if _EXT is None:
            from torch.utils import cpp_extension

            home = cpp_extension.CUDA_HOME
            nvcc = os.path.join(home or "", "bin", "nvcc")
            if not home or not os.path.exists(nvcc):
                raise RuntimeError(f"cannot build CUDA kernels: nvcc not "
                                   f"found (CUDA_HOME={home})")
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)
            sources = [CSRC / "bind.cpp"] + [CSRC / f
                                             for f in KERNELS.values()]
            _EXT = cpp_extension.load(
                name="repro_torch_kernels",
                sources=[str(s) for s in sources],
                extra_cflags=["-O3"], extra_cuda_cflags=CUDA_FLAGS,
                build_directory=str(out), verbose=verbose)
        return _EXT
