"""Where an xlstm's recurrent decode parts from its chunkwise forward.

    python3 tools/lm_block_gap.py [--layers 48] [--dtype bfloat16]
                                  [--device cpu]

draws xlstm-1.3b's weights at its published widths and ``--layers``
layers (a multiple of ``slstm_every``, 8) from a generator seeded 0, feeds
12 seeded tokens through every block at once (the chunkwise mLSTM form
and the sequential sLSTM loop of ``forward``) and one at a time (the
recurrent steps of ``decode_step``), and prints, for each block, the
largest gap between the two at the last token beside the residual
stream's magnitude, and each mLSTM block's branch and input RMS (the
branch rmsnorm-s its input, so an input's relative rounding error reaches
an output the size of the branch).  It runs on the card unless ``--device
cpu`` is given, and checks nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'src'))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import synthetic_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry, xlstm  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--layers', type=int, default=48)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--device', default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_config('xlstm-1.3b'),
                              n_layers=args.layers, dtype=args.dtype)
    model = registry.init_params(0, cfg, device=dev)
    toks = synthetic_batch(0, 0, 2, 12, cfg.vocab, device=dev)['tokens']
    blocks = [(f'{i}.mlstm.{j}', p, xlstm.mlstm_block, xlstm.mlstm_decode)
              for i, blk in enumerate(model.blocks)
              for j, p in enumerate(blk.mlstm)]
    blocks = sorted(blocks + [(f'{i}.slstm', blk.slstm, xlstm.slstm_block,
                               xlstm.slstm_decode)
                              for i, blk in enumerate(model.blocks)],
                    key=lambda b: [int(s) if s.isdigit() else s
                                   for s in b[0].split('.')])
    with torch.no_grad():
        x = L.embed(model.tok, toks)
        fwd, rms = [], []
        for _, p, block, _ in blocks:
            y = block(p, x, cfg)
            fwd.append(y[:, -1].float())
            rms.append((float(x.float().pow(2).mean().sqrt()),
                        float((y - x).float().pow(2).mean().sqrt())))
            x = y
        state = registry.init_decode_state(cfg, 2, 16, device=dev)
        for t in range(toks.shape[1]):
            x = L.embed(model.tok, toks[:, t:t + 1])
            dec = []
            for name, p, _, decode in blocks:
                i = int(name.split('.')[0])
                if 'mlstm' in name:
                    j = int(name.split('.')[-1])
                    x, state['mlstm'][i, j] = decode(p, x, state['mlstm'][i, j],
                                                     cfg)
                else:
                    x, (state['slstm_h'][i], state['slstm_c'][i]) = decode(
                        p, x, (state['slstm_h'][i], state['slstm_c'][i]), cfg)
                dec.append(x[:, 0].float())
    print(f'xlstm-1.3b, {cfg.n_layers} layers, {cfg.dtype}, on {dev}')
    for (name, *_), f, d, (x_rms, branch_rms) in zip(blocks, fwd, dec, rms):
        print(json.dumps({'block': name,
                          'gap': float((f - d).abs().max()),
                          'max_abs': float(f.abs().max()),
                          'input_rms': x_rms, 'branch_rms': branch_rms}))


if __name__ == '__main__':
    main()
