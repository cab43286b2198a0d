"""forward_roofline.frame: the least time of the window's forward work (the
reference's path lengths times the frozen op model's bounce, over the
card's float32 peak) over the summed CUPTI time of the configuration's
forward kernel, in %. Nothing where the kernel did not run or the card has
no peak in the table."""
from harness import stats


def read(trace):
    f = trace.facts
    busy = stats.kernel_ns(trace.device, f.get("forward_kernel"),
                           trace.window) / 1e9
    return stats.roofline_share(f.get("forward_ops"), f.get("peak"), busy)
