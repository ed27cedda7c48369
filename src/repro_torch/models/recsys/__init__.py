"""Stage models: DSSM (recall), YDNN (prerank), DIN and DIEN (rank)."""
