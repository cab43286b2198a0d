"""camera_ms.frame: the program's rt.frame.camera span, the camera swap
(ProgressiveRenderer._set_camera: derive, with_camera and its readback): its
length less the device's kernel and copy intervals inside it (the host work
the card waits for), mean over the traced window's moves, in ms. Nothing
without device events or without the span."""
from harness import spans


def read(trace):
    return spans.per_span_ms(trace, "rt.frame.camera")
