"""FL003 corpus for the port: the round path reaches the fleet axis only
through launch.sharding's helpers; torch.distributed's queries are not
collectives. Parsed, never run."""
# fleetlint: scope=fleet
import torch.distributed as dist

from repro_torch.launch import sharding as SH


def pooled_gradient(tree, flags, mesh, n):
    rank = dist.get_rank() if dist.is_initialized() else 0
    tree = SH.fleet_sum_tree(tree, mesh)
    hit = SH.fleet_any(flags, mesh)
    return tree, hit, rank, SH.fleet_extent(mesh) * n
