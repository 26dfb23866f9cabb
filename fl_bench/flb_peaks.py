"""Published peaks of one NVIDIA H100 SXM5 at its 700 W limit, dense rates
(NVIDIA H100 Tensor Core GPU datasheet), copied from the port's
``utils/roofline.py`` so that the yardstick cannot move with the
program."""
BF16_FLOPS = 989.4e12        # FLOP/s: BF16 tensor core, dense
HBM_BW = 3.35e12             # bytes/s: HBM3
