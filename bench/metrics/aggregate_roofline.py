"""``aggregate`` (``csrc/layer_aggregate.cu``) against its bound: Eq. 8
over the fleet's stack [N, L, F] of every stacked leaf of the encoder,
once a profiled round (the stack, the weights and the server rows read,
the rows written, fp32), over the HBM rate, divided by the device time
of the kernel's symbols."""
from reference.shapes import leaves, vit_tree
from yardstick import hw, work

LAYER = "kernels: csrc/"
UNIT = "%"
MOVES = "train_samples_per_s"
KERNELS = ("aggregate_kernel",)


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    t_dev = p.kernel_time_s(KERNELS)
    if t_dev <= 0:
        return None
    c, n = ctx.config, int(ctx.traffic["n_clients"])
    per_round = 0.0
    for _, leaf in leaves(vit_tree(c)["layers"]):
        L, feat = leaf.shape[0], 1
        for s in leaf.shape[1:]:
            feat *= s
        per_round += hw.bound_s(*work.aggregate_work(n, L, feat), "float32")
    return 100.0 * per_round * len(p.units) / t_dev
