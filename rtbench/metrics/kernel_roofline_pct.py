"""Layer kernels (`ops/cuda/*.cu`): the frame's roofline bound over the
device time of the kernels that render it, per frame, summed over ranks
(collectives left out).  The bound is the larger of the frame's operations
over the card's FP32 peak and its bytes over HBM bandwidth
(rtbench/roofline.py); the operations are the rays the kernels count times
the configuration's work a ray, so the share reads the same work whatever
engine renders the frame."""

from rtbench import roofline
from rtbench.trace import is_collective


def read(tv):
    if not tv.rays_traced or not tv.work_per_ray_flops or not roofline.known(tv.kind):
        return None
    per_frame_s = sum(r.per_frame_ms(lambda k: not is_collective(k)) for r in tv.ranks) / 1e3
    if per_frame_s <= 0.0:
        return None
    bound = roofline.bound_seconds(roofline.frame_ops(tv.rays_traced, tv.work_per_ray_flops),
                                   roofline.frame_bytes(tv.width, tv.height), tv.kind)
    return 100.0 * bound / per_frame_s
