"""back_solve_roofline.play: the share of its roofline that ``back_solve``
(``ops/chol.py`` -> ``csrc/chol.cu``'s ``back_solve_kernel``) reaches in the
traced window, in % (``flops.chol_roofline``)."""

from h100_bench.flops import chol_roofline


def read(record):
    return chol_roofline(record, "back_solve", "back_solve_kernel")
