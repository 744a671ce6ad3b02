"""Published peaks of the card the benchmark runs on (NVIDIA's H100 SXM
data sheet, dense rates, at the full 700 W power limit; a run prints the
card's name and power limit beside its numbers)."""

HBM_BYTES_PER_S = 3.35e12        # 80 GB of HBM3
