"""``tier_sum`` (``csrc/tpgf_fusion.cu``) against its bound: the
cross-tier fusions the profiled rounds' width groups require (one per
cohort of more than one width tier, over the server branch of its depth,
T tiers read and one result written, fp32) over the HBM rate, divided by
the device time of the kernel's symbols."""
from reference.shapes import vit_server_elems
from yardstick import hw, work

LAYER = "kernels: csrc/"
UNIT = "%"
MOVES = "train_samples_per_s"
KERNELS = ("tier_sum_kernel",)


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    t_dev = p.kernel_time_s(KERNELS)
    if t_dev <= 0:
        return None
    c, bound = ctx.config, 0.0
    for u in p.units:
        tiers = {}
        for d, w, _ in u["clients"]:
            tiers.setdefault(d, set()).add(w)
        for d, ws in tiers.items():
            if len(ws) > 1:
                bound += hw.bound_s(*work.tier_sum_work(
                    len(ws), vit_server_elems(c, d)), "float32")
    return 100.0 * bound / t_dev
