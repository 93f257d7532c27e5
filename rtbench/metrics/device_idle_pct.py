"""Layer device: the share of a frame in which no operation runs on the
card, averaged over ranks (collectives count as busy): one minus the busy
time a traced frame (the union of device operations in the profiler's
timeline) over the time a frame took before the trace began.  The
profiler slows the host by 7-15% a frame and would count that as idle."""


def read(tv):
    if tv.kind == "cpu" or tv.untraced_frame_s <= 0.0:
        return None
    return 100.0 * (1.0 - tv.busy_share())
