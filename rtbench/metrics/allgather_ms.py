"""Layer sharding (parallel/sharding.py's gather of the bands): the device
milliseconds a frame of the NCCL all_gather kernel on the rank whose band
is slowest, which waits least for the others."""


def read(tv):
    if len(tv.ranks) < 2:
        return None
    ms = [tv.kernel_ms(i, lambda k: k == "render_kernel") for i in range(len(tv.ranks))]
    slowest = max(range(len(ms)), key=ms.__getitem__)
    gather = tv.kernel_ms(slowest, lambda k: k.startswith("nccl") and "AllGather" in k)
    return gather if gather > 0.0 else None
