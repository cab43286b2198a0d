"""host_ms.frame: per item, the harness's span around the program's call
less the device's intervals inside it (the host work the card waits for),
mean over the traced window's items, in ms."""
from harness import stats


def read(trace):
    if not trace.device:
        return None
    return stats.host_ms(trace.spans, trace.device)
