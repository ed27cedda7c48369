"""Recsys models: the cascade's stage models DSSM (recall), YDNN
(prerank), DIN and DIEN (rank), and the zoo's DLRM and xDeepFM."""
from repro_torch.models.recsys import dlrm, xdeepfm

__all__ = ["dlrm", "xdeepfm"]
