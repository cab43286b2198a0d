"""device_idle.render: 1 - the union of the device's kernel and copy
intervals over the traced window's wall, in %."""
from harness import stats


def read(trace):
    if not trace.device:
        return None
    return 100.0 * stats.idle_share(trace.device, trace.window)
