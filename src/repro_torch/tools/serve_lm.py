"""Continuous-batching LM serving example: a queue of synthetic requests
admitted into a fixed number of K/V-cache slots, each refilled as its
request finishes, with the throughput reported.

    PYTHONPATH=src python3 -m repro_torch.tools.serve_lm [--device cpu]

The sizes are those of the JAX package's ``examples/serve_lm.py``: prompts
of 6 tokens, 128 positions a slot, the reduced config of ``--arch``, which may be any LM config of
every family.  It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from ..launch.serve import run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='smollm-360m')
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--requests', type=int, default=8)
    ap.add_argument('--max-new', type=int, default=12)
    ap.add_argument('--device', default=None,
                    help="'cpu' for the host; the card by default")
    args = ap.parse_args()
    run(args.arch, slots=args.slots, n_requests=args.requests,
        prompt_len=6, max_new=args.max_new, max_seq=128, device=args.device)


if __name__ == '__main__':
    main()
