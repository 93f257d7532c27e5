"""Layer megakernel K1 (`render_kernel` in ops/cuda/megakernel.cu): its
device milliseconds a frame, on the slowest rank where there are several."""


def read(tv):
    ms = [tv.kernel_ms(i, lambda k: k == "render_kernel") for i in range(len(tv.ranks))]
    return max(ms) if max(ms) > 0.0 else None
