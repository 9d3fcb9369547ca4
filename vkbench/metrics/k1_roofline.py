"""K1 (`vk_mask_pool`) share of its roofline, serving (`.serve`) or in the
train step (`.train`)."""

from vkbench import roofline, trace


def read(rec):
    return roofline.roofline_share("k1", rec["shapes"]["k1"],
                                   trace.kernel_s(rec["events"], rec["kernels"]["k1"]))
