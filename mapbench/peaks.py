"""The card's published peaks (NVIDIA H100 SXM data sheet, at the full
700 W power limit), as ``chip_smoke.py`` states them; a share of a peak is
given beside the card's power limit, which each run prints."""

# int32 instructions a second: 132 multiprocessors x 64 int32 lanes x
# 1.98 GHz
INT32_OPS = 16.7e12
HBM_BYTES = 3.35e12
