"""Machine models: Manticore (the paper's target), TPU v5e, and the H100.

The paper's space-complexity arguments (Sections 2.1.2, 2.2.2, 2.3.2, 3.1.2,
3.2.2) are all of the form "working set + DMA double-buffers must fit the
128 KiB cluster scratchpad".  That capacity argument is encoded once, here,
parameterized by the machine, so the *same* planner that reproduces the
paper's Manticore numbers (Delta_O <= 24/12, D_O <= 768/384) also picks the
thread-block tiles of the CUDA kernels against the H100's shared memory.

``MANTICORE`` and ``TPU_V5E`` are kept field for field as the JAX package
has them, so the planners' picks on both can be held against it.
"""

from __future__ import annotations

import dataclasses

KIB = 1024
MIB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Capacity/bandwidth model of one compute unit and its fabric."""

    name: str
    # Fast local memory per compute unit (Manticore: L1 SPM; TPU: VMEM;
    # H100: the shared memory one thread block can opt into).
    local_mem_bytes: int
    # Bytes reserved per DMA stream to cover main-memory round-trip latency
    # (paper Sec. 2.1.2: 256 cycles x 64 B/cycle = 16 KiB per stream).
    dma_buffer_bytes: int
    # Compute units that can share data over the fast local network
    # (paper: 16 clusters per L2 quadrant; TPU: chips on an ICI ring axis).
    local_group_size: int
    # Peak compute, main-memory BW, and local-link BW (for rooflines).
    peak_flops: float
    main_mem_bw: float
    link_bw: float
    # Number of compute units in one "chip" (Manticore chiplet: 128 clusters).
    units: int = 1
    # Block-size granularity the compute unit wants.  Planners emit blocks
    # in multiples of this.
    lane: int = 1
    # Whether streamed input blocks are double-buffered *inside* the local
    # memory budget (True) or flow through the fixed reserved DMA buffers
    # (Manticore's 16 KiB stream buffers, paper Sec. 2.1.2: False).
    charge_stream_blocks: bool = True
    # Per-block-name upper bounds that replace the planners' defaults on
    # this machine: ``(("block_n", 128), ...)``.  Empty keeps the defaults.
    block_caps: tuple[tuple[str, int], ...] = ()

    def dma_reserve(self, streams: int) -> int:
        """Bytes reserved for ``streams`` double-buffered DMA streams."""
        return streams * self.dma_buffer_bytes

    def usable_for_working_set(self, streams: int) -> int:
        return self.local_mem_bytes - self.dma_reserve(streams)

    def block_cap(self, name: str, default: int) -> int:
        """The largest ``name`` block a planner may emit here."""
        return dict(self.block_caps).get(name, default)


# The paper's machine (Sec. 1): 128 KiB L1 per cluster, 16 KiB per DMA
# stream buffer, 16 clusters per L2 quadrant, 8 FPUs x 1 dp-MAC/cycle
# (2 sp-MACs/cycle) @ 1 GHz nominal, 512-bit DMA @ 1 GHz into the tree NoC.
MANTICORE = MachineModel(
    name="manticore",
    local_mem_bytes=128 * KIB,
    dma_buffer_bytes=16 * KIB,
    local_group_size=16,
    peak_flops=128 * 8 * 2 * 2 * 1e9,  # chiplet, sp: 128 cl x 8 FPU x 2 MAC x 2 flop
    main_mem_bw=64 * 1e9,  # one 512-bit HBM2E port @ 1 GHz
    link_bw=64 * 1e9,  # 512-bit cluster DMA port @ 1 GHz
    units=128,
    lane=1,
    charge_stream_blocks=False,  # streams ride the reserved 16 KiB buffers
)

# TPU v5e, the JAX package's target (kept so its planner picks can be held
# against the port's): 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s per ICI
# link; 64 MiB of VMEM budgeted, 4 MiB per double-buffered stream.
TPU_V5E = MachineModel(
    name="tpu_v5e",
    local_mem_bytes=64 * MIB,
    dma_buffer_bytes=4 * MIB,
    local_group_size=16,  # one axis of a 16x16 pod slice
    peak_flops=197e12,
    main_mem_bw=819e9,
    link_bw=50e9,
    units=1,
    lane=128,
    charge_stream_blocks=True,  # Pallas double-buffers whole blocks in VMEM
)

# NVIDIA H100 SXM5 80 GB (the variant `nvidia-smi` reports on the card the
# port is measured on; data sheet figures at the 700 W limit).  One "unit"
# is one SM; its budget is the dynamic shared memory a single thread block
# can opt into: 227 KB = 232,448 B.
#
# What the budget holds is exactly what each CUDA kernel allocates per
# thread block (kernels/csrc/*.cu), all of it in SHARED MEMORY:
#   * the f32 accumulator tile (matmul: block_m x block_n; direct conv:
#     block_h*W_O x block_do; wgrad: F x F x block_di x block_do; NT:
#     block_m x block_k; the fused dX/dW matmul: the whole-M dX strip and
#     the dW tile), resident across the whole contraction loop -- except in
#     the wgrad and NT kernels at their main blocks, which keep the
#     accumulators in registers and use the region for the stages during
#     the loop (wgrad) and for the epilogue's fixed-order sum and 16-byte
#     stores;
#   * two stages of each streamed tile (the X and W tiles of a matmul, the
#     halo'd input strip and the filter or gradient block of a conv),
#     filled by cp.async (or, for NT's transposed tiles, through registers)
#     while the previous stage is consumed — hence
#     charge_stream_blocks=True and no separate DMA reservation.
# REGISTERS (not charged) hold each thread's partial sums: for one step in
# the other kernels (a 4x8 matmul item, 1 pixel x 8 channels of conv), for
# the whole loop in wgrad (9 taps x 8 channels) and NT (a 4x8 tile).
#
# lane = 8: every kernel gives each thread 8 output channels / columns, so
# blocks come in multiples of 8.  The caps bound the tiles to what 256
# threads cover well; the planners' capacity argument picks below them.
# Each kernel's wrapper accepts exactly the blocks its ``supported_blocks``
# names (kernels/matmul/matmul.py, kernels/matmul/bwd.py,
# kernels/conv2d/conv2d.py, kernels/conv2d/bwd.py).
H100 = MachineModel(
    name="h100",
    local_mem_bytes=232_448,
    dma_buffer_bytes=0,  # cp.async stages land in the charged tiles
    local_group_size=4,  # cards of one host joined all to all by NVLink
    peak_flops=67e12,  # f32 on the CUDA cores (no tensor cores), SXM5
    main_mem_bw=3.35e12,  # HBM3, SXM5 80 GB
    link_bw=450e9,  # NVLink 4, one direction
    units=132,
    lane=8,
    charge_stream_blocks=True,
    block_caps=(("block_di", 16), ("block_do", 64), ("block_k", 32),
                ("block_m", 64), ("block_n", 128)),
)

MACHINES = {m.name: m for m in (MANTICORE, TPU_V5E, H100)}

# How many blocks one H100 SM holds at once, for the kernels that split a
# contraction over blocks to fill the card (wgrad and the matmuls): an SM has 228 KB
# of shared memory, less 1 KB the system keeps for each resident block,
# and the kernels' 256 threads and register tiles leave room for two.
H100_SM_SMEM_BYTES = 233_472
H100_SMEM_RESERVED = 1_024
H100_RESIDENT_TARGET = 2
H100_MAX_GRID_Z = 65535  # the split rides the grid's z axis


def h100_resident_blocks(smem_bytes: int) -> int:
    """Blocks of ``smem_bytes`` shared memory that one H100 SM holds at
    once, from 1 up to H100_RESIDENT_TARGET."""
    fit = H100_SM_SMEM_BYTES // (smem_bytes + H100_SMEM_RESERVED)
    return max(1, min(H100_RESIDENT_TARGET, fit))


def h100_split(*, grid: int, steps: int, smem_bytes: int) -> int:
    """Thread blocks that share each output tile's contraction loop of
    ``steps`` steps, for a matmul kernel whose grid has ``grid`` output
    tiles: 1 where the grid fills one wave of the card's SMs, else as many
    as fill the resident block slots, never more than the loop has steps
    or the grid's z axis holds.  A function of the shapes alone, so the
    order of the partial sums (and the result) never changes."""
    if grid >= H100.units:
        return 1
    slots = h100_resident_blocks(smem_bytes) * H100.units
    return max(1, min(steps, slots // grid, H100_MAX_GRID_Z))


def machine_named(name: str, default: MachineModel = H100) -> MachineModel:
    """The MachineModel a Schedule's ``machine`` name refers to (``default``
    for a name that is not registered)."""
    return MACHINES.get(name, default)


WORD_BYTES = {"sp": 4, "dp": 8, "bf16": 2, "f32": 4, "f64": 8}


def word_bytes(precision: str) -> int:
    """Bytes of one word (one element) at ``precision`` (paper Sec. 1.2.2:
    4 B single, 8 B double precision)."""
    try:
        return WORD_BYTES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None
