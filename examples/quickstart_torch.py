"""Quickstart for the PyTorch/CUDA port: the SuperSFL pipeline end to end.

The port's counterpart of ``examples/quickstart.py``:

1. Builds the paper's setting at reduced scale: a ViT backbone supernet,
   a heterogeneous fleet (mem ~ U[2,16] GB, lat ~ U[20,200] ms), Eq. 1
   resource-aware depths, Dirichlet(0.5) non-IID data.
2. Assembles an ``Engine`` with the builder API: a strategy from the
   registry (ssfl / sfl / dfl / fedavg / fedavgm / fedadam / fedyogi /
   unstable / async_buffered / hasfl), an optimizer from
   ``repro_torch.optim``, and the scenario knobs (server availability,
   per-round client sampling).
3. Runs a few rounds and prints loss, accuracy, communication and the
   depth histogram.

Run on the card (the hand-written kernels carry TPGF and Eq. 8):

    PYTHONPATH=src python examples/quickstart_torch.py --strategy unstable

or on the CPU (the kernels' plain versions):

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        --rounds 2 --clients 4 --strategy hasfl
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.federated import Engine, available_strategies  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--strategy", default="ssfl",
                    choices=available_strategies())
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    cfg = base.get_reduced("vit16_cifar").replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, image_size=16, use_pallas=True)

    print("registered strategies:", available_strategies())
    engine = (Engine.builder(cfg)
              .clients(args.clients, availability=0.9, sample_frac=1.0)
              .strategy(args.strategy)
              .optimizer("sgd", lr=0.25)
              .rounds(local_steps=3, batch_size=32, seed=0)
              .execution(device=args.device)
              .build())

    depths = engine.state.fleet.depths
    print("client depth allocation (Eq. 1):",
          dict(zip(*map(list, np.unique(depths, return_counts=True)))))

    for r in range(args.rounds):
        rec = engine.run_round()
        if (r + 1) % 2 == 0 or r == args.rounds - 1:
            acc = engine.evaluate()
            print(f"round {rec['round']:2d}  fused_loss={rec['loss']:.3f}  "
                  f"test_acc={acc:.3f}  comm={rec['comm_mb']:.1f} MB")
    print("\nledger:", engine.accountant.summary())


if __name__ == "__main__":
    main()
