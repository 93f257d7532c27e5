"""Layer wavefront loop (K2b, ops/cuda/wavefront.cu): the device
milliseconds a frame of the partition, `wf_count_kernel` and
`wf_scatter_kernel`."""


def read(tv):
    ms = tv.kernel_ms(0, lambda k: k in ("wf_count_kernel", "wf_scatter_kernel"))
    return ms if ms > 0.0 else None
