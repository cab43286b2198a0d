"""memcheck_ms.train: the program's rt.memcheck span, the free-memory check
(ops/wavefront_cuda.py::check_free, cudaMemGetInfo): its length less the
device's kernel and copy intervals inside it (the host work the card waits
for), per optimizer step, summed over the step's spans, mean over the traced
window's steps, in ms. Nothing without device events or without the span."""
from harness import spans


def read(trace):
    return spans.per_item_ms(trace, "rt.memcheck")
