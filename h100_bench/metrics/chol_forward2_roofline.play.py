"""chol_forward2_roofline.play: the share of its roofline that ``chol_forward2``
(``ops/chol.py`` -> ``csrc/chol.cu``'s ``chol_forward_kernel``) reaches in the
traced window, in % (``flops.chol_roofline``)."""

from h100_bench.flops import chol_roofline


def read(record):
    return chol_roofline(record, "chol_forward2", "chol_forward_kernel")
