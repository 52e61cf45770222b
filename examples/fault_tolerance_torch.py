"""Fault-tolerance demo for the PyTorch/CUDA port (paper §II-C / Table III).

The port's counterpart of ``examples/fault_tolerance.py``: trains SuperSFL
under decreasing server-gradient availability and prints the final
accuracy of each setting. Accuracy degrades smoothly instead of
collapsing, because clients keep learning through their local classifier
and their fallback updates re-enter aggregation; at 0.0 ``evaluate``
serves the per-client local-head ensemble, the server head never having
trained.

Run on the card, or on the CPU:

    PYTHONPATH=src python examples/fault_tolerance_torch.py [n_rounds]
    PYTHONPATH=src python examples/fault_tolerance_torch.py 4 --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import base  # noqa: E402
from repro_torch.federated import Engine  # noqa: E402

MODES = {1.0: "fully server-assisted", 0.7: "mostly server-assisted",
         0.5: "partially server-assisted", 0.2: "mostly client-driven",
         0.0: "serverless"}


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("rounds", type=int, nargs="?", default=14)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    cfg = base.get_reduced("vit16_cifar").replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, image_size=16, use_pallas=True)
    print(f"{'availability':>14s} {'mode':>26s} {'final_acc':>10s}")
    for frac, mode in MODES.items():
        eng = Engine(cfg, args.clients, "ssfl", seed=3, lr=0.25,
                     local_steps=3, batch_size=32, availability=frac,
                     device=args.device)
        for _ in range(args.rounds):
            eng.run_round()
        print(f"{frac:14.1f} {mode:>26s} {eng.evaluate():10.3f}")


if __name__ == "__main__":
    main()
