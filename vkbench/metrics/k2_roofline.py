"""K2 (`vk_assemble`) share of its roofline, serving (`.serve`) or in the
train step (`.train`)."""

from vkbench import roofline, trace


def read(rec):
    return roofline.roofline_share("k2", rec["shapes"]["k2"],
                                   trace.kernel_s(rec["events"], rec["kernels"]["k2"]))
