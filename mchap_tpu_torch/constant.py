"""Shared constants; reference mchap/constant.py."""

# Default per-base sequencing error rate (Pfeiffer et al. 2018).
PFEIFFER_ERROR = 0.0024
