"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W power limit); a run prints the card's power limit beside them."""

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
