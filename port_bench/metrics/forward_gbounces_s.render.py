"""forward_gbounces_s.render: the bounces the forward kernel traced in the
traced window (the program's counter, render_pass_kernel.bounces, kept
while a profiler records) over the summed CUPTI time of the
configuration's forward kernel, in G bounces/s. Nothing without device
events, without the counter or where the kernel did not run."""
from harness import spans, stats


def read(trace):
    if not trace.device:
        return None
    bounces = spans.forward_bounces()
    ns = stats.kernel_ns(trace.device, trace.facts.get("forward_kernel"),
                         trace.window)
    if bounces is None or ns <= 0:
        return None
    return bounces / ns
