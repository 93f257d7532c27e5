"""Layer api (`api.render`: camera derivation, `pack_scene`, the launch):
the host's milliseconds inside the timed call, from entering it to its
return, by the harness's own host clock around the call (the program has
no spans of its own yet), mean over the frames before the trace began
(rank 0).  On the megakernel route the
call returns before the card finishes, so this is the enqueue."""


def read(tv):
    if not tv.enqueue_s:
        return None
    return 1e3 * sum(tv.enqueue_s) / len(tv.enqueue_s)
