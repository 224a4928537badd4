"""Three-term roofline of one step of a dry-run cell, the counterpart of
the JAX package's ``analysis/roofline.py``.

    compute term    = FLOPs / (chips * peak FLOP/s)
    memory term     = HBM bytes / (chips * HBM bandwidth)
    collective term = collective bytes / (chips * link bandwidth)

Hardware constants: datasheet figures of the NVIDIA H100 SXM5 80GB HBM3
at its 700 W power limit (dense rates, no sparsity): 989 TFLOP/s of
bfloat16 on the tensor cores, 67 TFLOP/s of float32 outside them,
3.35 TB/s of HBM3, and NVLink 4 at 450 GB/s each way.  A pod, for the
cross-pod split of the collective bytes, is one NVLink domain: the eight
cards of one HGX H100 board.  A card set below 700 W runs slower under
load than these figures.

Sources: per-rank FLOPs, bytes and collective bytes come from the op
counter (``analysis.op_count``), which reads the ops of one eager call at
the dispatcher (the JAX package parses optimized HLO instead).  The
tensors a rank holds are its own, so the counts are already per chip.
"""
from __future__ import annotations

import dataclasses
import json

PEAK_BF16_PER_S = 989e12     # dense bfloat16, on the tensor cores
PEAK_F32_PER_S = 67e12       # float32, outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, each way
POD_SIZE = 8                 # cards of one NVLink domain (HGX H100)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device (per-chip) raw terms
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_bytes_crosspod_per_chip: float
    collective_counts: dict
    # seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    # analysis
    bottleneck: str = ''
    model_flops: float = 0.0
    useful_ratio: float = 0.0      # MODEL_FLOPS / (counted FLOPs * chips)
    bytes_per_device_hbm: float = 0.0   # peak from the memory record
    note: str = ''

    def finalize(self) -> 'Roofline':
        self.t_compute = self.flops_per_chip / PEAK_BF16_PER_S
        self.t_memory = self.bytes_per_chip / PEAK_BYTES_PER_S
        self.t_collective = self.coll_bytes_per_chip / NVLINK_BYTES_PER_S
        terms = {'compute': self.t_compute, 'memory': self.t_memory,
                 'collective': self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        total = self.flops_per_chip * self.chips
        self.useful_ratio = (self.model_flops / total) if total else 0.0
        return self

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: max of the three terms (perfect
        overlap of compute, HBM, and links)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step spent on the useful-compute floor: how close
        the counted program is to a perfect 6ND implementation at peak."""
        ideal = self.model_flops / (self.chips * PEAK_BF16_PER_S)
        return ideal / self.step_time if self.step_time else 0.0

    def row(self) -> dict:
        return {
            'arch': self.arch, 'shape': self.shape, 'mesh': self.mesh,
            'chips': self.chips,
            't_compute_s': self.t_compute, 't_memory_s': self.t_memory,
            't_collective_s': self.t_collective,
            'bottleneck': self.bottleneck,
            'model_flops': self.model_flops,
            'hlo_flops_total': self.flops_per_chip * self.chips,
            'useful_ratio': self.useful_ratio,
            'roofline_fraction': self.roofline_fraction,
            'hbm_bytes_per_device': self.bytes_per_device_hbm,
            'collective_counts': self.collective_counts,
            'coll_bytes_crosspod_per_chip': self.coll_bytes_crosspod_per_chip,
            'note': self.note,
        }


def from_counts(arch: str, shape: str, mesh_name: str, chips: int,
                counts: dict, *, model_flops: float = 0.0,
                memory: dict | None = None, note: str = '') -> Roofline:
    """Build a Roofline from the op counter's ``counts`` of one step (and
    the cell's memory record: its argument, output, temporary and code
    bytes sum to the device's peak, as the JAX package sums XLA's)."""
    peak = 0.0
    if memory is not None:
        peak = float(sum(memory.get(k, 0) or 0 for k in (
            'temp_size_in_bytes', 'argument_size_in_bytes',
            'output_size_in_bytes', 'generated_code_size_in_bytes')))
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=counts['flops'],
        bytes_per_chip=counts['bytes'],
        coll_bytes_per_chip=counts['collective_bytes'],
        coll_bytes_crosspod_per_chip=counts['collective_bytes_crosspod'],
        collective_counts=counts['collective_counts'],
        model_flops=model_flops,
        bytes_per_device_hbm=peak,
        note=note,
    ).finalize()


def fmt_seconds(x: float) -> str:
    if x >= 1.0:
        return f'{x:.2f}s'
    if x >= 1e-3:
        return f'{x * 1e3:.2f}ms'
    return f'{x * 1e6:.1f}us'


def fmt_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':<26} {'shape':<12} {'mesh':<6} "
           f"{'compute':>9} {'memory':>9} {'collect':>9} {'bound':>9} "
           f"{'useful':>7} {'roofl%':>7}")
    out = [hdr, '-' * len(hdr)]
    for r in rows:
        out.append(
            f"{r['arch']:<26} {r['shape']:<12} {r['mesh']:<6} "
            f"{fmt_seconds(r['t_compute_s']):>9} "
            f"{fmt_seconds(r['t_memory_s']):>9} "
            f"{fmt_seconds(r['t_collective_s']):>9} "
            f"{r['bottleneck']:>9} "
            f"{r['useful_ratio']:>7.2f} "
            f"{100 * r['roofline_fraction']:>6.1f}%")
    return '\n'.join(out)


def save_rows(rows: list[dict], path: str) -> None:
    with open(path, 'w') as f:
        json.dump(rows, f, indent=1, default=str)


def load_rows(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)
