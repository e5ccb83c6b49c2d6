"""End-to-end LM training on the PyTorch port: a few hundred steps of the
(reduced) qwen2.5 architecture with the full stack — deterministic data
pipeline, AdamW, checkpointing, fault-tolerant loop.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      [--ckpt-dir DIR] [--device cpu]

The counterpart of ``examples/train_lm.py``: it hands the port's launcher
(``repro_torch.launch.train``) the same arguments plus ``--device`` (the
CUDA card unless it names another torch device).  Checkpoints go under
``--ckpt-dir``, by default a directory in the system's temporary directory;
a rerun resumes from the latest one there.
"""
import argparse
import os
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="200")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    train.main(["--arch", "qwen2.5-14b", "--steps", args.steps,
                "--ckpt-dir", args.ckpt_dir, "--device", args.device])


if __name__ == "__main__":
    main()
