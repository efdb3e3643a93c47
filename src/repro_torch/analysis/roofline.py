"""Roofline terms of a planned kernel or a whole program.

  compute    = flops      / (chips * machine.peak_flops)
  memory     = bytes_hbm  / (chips * machine.main_mem_bw)
  collective = bytes_coll / (chips * machine.link_bw)

The peaks come from a :class:`~repro_torch.core.machine.MachineModel`, not
from constants: ``H100`` gives 67 TFLOP/s (f32 on the CUDA cores, which the
port's kernels run on), 3.35 TB/s of HBM3 and 450 GB/s of NVLink; ``TPU_V5E``
gives the JAX package's 197 TFLOP/s, 819 GB/s and 50 GB/s, so its terms equal
``repro``'s there.  ``model_flops`` (6·N·D to train, 2·N·D to serve, N the
active parameters) over ``flops`` exposes recompute and dispatch overhead.

The terms of a whole step come from its traced cost
(``analysis/hlo_cost.py``: per-device FLOPs, bytes and collective result
bytes counted as the step runs, on ``meta`` tensors in a dry run):
:func:`from_compiled` takes that ``Cost`` where ``repro``'s takes the
compiled program, and :func:`collective_bytes` reads its collectives where
``repro``'s parses the HLO text.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.machine import H100, MachineModel


@dataclasses.dataclass
class Roofline:
    flops: float  # total flops (all devices)
    bytes_hbm: float  # total main-memory bytes moved
    bytes_coll: float  # summed collective bytes (all devices)
    chips: int
    model_flops: float = 0.0
    machine: MachineModel = H100  # whose peaks the time terms divide by

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.machine.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / (self.chips * self.machine.main_mem_bw)

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / (self.chips * self.machine.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS/(chips*peak) over the bound time: the share of peak
        compute this program could at best sustain given its dominant
        roofline term."""
        if not self.t_bound:
            return 0.0
        return (self.model_flops / (self.chips * self.machine.peak_flops)) / self.t_bound

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_coll": self.bytes_coll, "chips": self.chips,
            "model_flops": self.model_flops, "machine": self.machine.name,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(kind: str, n_active_params: int, tokens: int) -> float:
    if kind == "train":
        return 6.0 * n_active_params * tokens
    return 2.0 * n_active_params * tokens  # prefill / decode forward


def collective_bytes(cost) -> dict[str, float]:
    """Per-category result bytes of the collectives a traced step issued
    (a :class:`~repro_torch.analysis.hlo_cost.Cost`), per device."""
    from repro_torch.analysis.hlo_cost import COLLECTIVES

    return {k: cost.coll[k] for k in COLLECTIVES}


def from_compiled(cost, kind: str, n_active: int, tokens: int, chips: int, *,
                  io_bytes: float = 0.0, machine: MachineModel = H100) -> Roofline:
    """All three terms from a step's per-device traced ``cost``, scaled
    back to all-device totals (x chips) so the Roofline terms divide
    consistently; ``io_bytes`` (the step's argument and output bytes, per
    device) stream main memory once."""
    coll = sum(cost.coll.values())
    return Roofline(
        flops=cost.flops * chips, bytes_hbm=(cost.bytes + io_bytes) * chips,
        bytes_coll=coll * chips, chips=chips,
        model_flops=model_flops(kind, n_active, tokens), machine=machine,
    )
