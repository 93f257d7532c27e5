"""Layer wavefront loop (ops/cuda/wavefront.py, K2a): the device
milliseconds a frame of `wavefront_bounce_kernel`."""


def read(tv):
    ms = tv.kernel_ms(0, lambda k: k == "wavefront_bounce_kernel")
    return ms if ms > 0.0 else None
