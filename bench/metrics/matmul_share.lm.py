"""The share of the card's busy time over the profiled steps spent in
matrix-multiply kernels (cuBLAS and CUTLASS GEMMs, by the name patterns
below): the models' projections, expert products and heads."""
LAYER = "models: models/"
UNIT = "%"
MOVES = "train_tokens_per_s"
PATTERNS = ("gemm", "Gemm", "GEMM", "nvjet", "xmma", "cutlass", "sm90_",
            "ampere_", "Kernel2")


def read(ctx):
    p = ctx.profile
    if p is None or not p.kernels or p.busy_s <= 0:
        return None
    return 100.0 * p.kernel_time_s(PATTERNS) / p.busy_s
