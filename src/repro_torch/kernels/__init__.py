"""Hand-written CUDA kernels (``csrc/``), their wrappers (``ops``), their
plain-torch versions (``ref``) and the build (``build``)."""
