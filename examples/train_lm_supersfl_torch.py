"""E2E launcher of the PyTorch/CUDA port: SuperSFL split-training of an
LM architecture through ``repro_torch.launch.train``.

The port's counterpart of ``examples/train_lm_supersfl.py``: the reduced
variant for 200 steps, showing the TPGF losses falling, with a checkpoint
at the end. It runs on the card; ``--device cpu`` runs it on the CPU:

    PYTHONPATH=src python examples/train_lm_supersfl_torch.py [arch]
    PYTHONPATH=src python examples/train_lm_supersfl_torch.py \\
        mamba2_2_7b --device cpu
    PYTHONPATH=src python examples/train_lm_supersfl_torch.py \\
        whisper_small --device cpu

Every config of ``repro_torch.configs`` trains here; an audio batch
carries zero encoder frames, as the reference's launcher gives them.
"""
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    arch = argv[0] if argv and not argv[0].startswith("-") else "llama3_2_3b"
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--reduced", "--steps", "200", "--batch", "8", "--seq", "64",
           "--lr", "3e-3", "--log-every", "25", "--device", device,
           "--ckpt", "results/quickckpt_torch"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.call(cmd, cwd=ROOT, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
