"""FL003 corpus for the port: fleet collectives outside launch/sharding.py
and on groups that do not come from ``fleet_group``. Parsed, never
run."""
# fleetlint: scope=fleet
import torch
import torch.distributed as dist
from torch.distributed import all_gather

from repro_torch.launch import sharding as SH


def pooled_gradient(g, mesh, my_group):
    dist.all_reduce(g)                                  # the WORLD group
    dist.all_reduce(g, group=my_group)                  # not fleet_group
    torch.distributed.broadcast(g, 0, group=SH.fleet_group(mesh))
    out = [torch.empty_like(g) for _ in range(2)]
    all_gather(out, g, group=SH.fleet_group(mesh))      # a gather
    dist.barrier()
    return g, out
