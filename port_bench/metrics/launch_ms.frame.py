"""launch_ms.frame: the program's rt.launch span, the kernel launch's host side
(ops/wavefront_cuda.py::_launch: checks, parameters, scratch, the library
call): its length less the device's kernel and copy intervals inside it (the
host work the card waits for), per frame, summed over the frame's spans,
mean over the traced window's frames, in ms. Nothing without device events
or without the span."""
from harness import spans


def read(trace):
    return spans.per_item_ms(trace, "rt.launch")
