"""Batched serving on the PyTorch port: prefill + greedy decode with a KV
cache.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

The counterpart of ``examples/serve_lm.py``: it hands the port's launcher
(``repro_torch.launch.serve``, which serves the arch's reduced config with
parameters from a generator seeded with 0) the same arguments, gemma3-4b
with 8 requests of 32 prompt tokens and 16 new tokens, plus ``--device``
(the CUDA card unless it names another torch device).
"""
import argparse

from repro_torch.launch import serve

ARGV = ["--arch", "gemma3-4b", "--requests", "8", "--prompt-len", "32",
        "--new-tokens", "16"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    serve.main(ARGV + ["--device", args.device])


if __name__ == "__main__":
    main()
