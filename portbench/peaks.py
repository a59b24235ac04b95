"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit), the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12        # HBM3
