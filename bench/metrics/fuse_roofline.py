"""``fuse`` (``csrc/tpgf_fusion.cu``) against its bound: the bytes Eq. 4
needs for the profiled rounds' inputs (one fusion per local step of each
client that reached the server, over its prefix at its depth and width:
two gradients read and one written, fp32) over the HBM rate, divided by
the device time of the kernel's symbols. Launches do not enter: the
count is the same whatever implements Eq. 4."""
from reference.shapes import vit_client_elems
from yardstick import hw, work

LAYER = "kernels: csrc/"
UNIT = "%"
MOVES = "train_samples_per_s"
KERNELS = ("fuse_kernel",)


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    t_dev = p.kernel_time_s(KERNELS)
    if t_dev <= 0:
        return None
    c, steps = ctx.config, int(ctx.traffic["local_steps"])
    bound = sum(steps * hw.bound_s(*work.fuse_work(vit_client_elems(c, d, w)),
                                   "float32")
                for u in p.units for d, w, avail in u["clients"] if avail)
    return 100.0 * bound / t_dev
