"""pack_ms.render: the program's rt.pack span, the kernel packing
(ops/wavefront_cuda.py::prepare_kernel: tables, chunk scan, BVH, the camera
and Perlin readback): its length less the device's kernel and copy intervals
inside it (the host work the card waits for), per item, summed over the
item's spans, mean over the traced window's images, in ms. Nothing without
device events or without the span."""
from harness import spans


def read(trace):
    return spans.per_item_ms(trace, "rt.pack")
