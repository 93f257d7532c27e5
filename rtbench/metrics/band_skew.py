"""Layer sharding (parallel/sharding.py): the slowest rank's
`render_kernel` milliseconds a frame over the fastest's."""


def read(tv):
    if len(tv.ranks) < 2:
        return None
    ms = [tv.kernel_ms(i, lambda k: k == "render_kernel") for i in range(len(tv.ranks))]
    return max(ms) / min(ms) if min(ms) > 0.0 else None
