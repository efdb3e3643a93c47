"""The paper's analysis framework as code: Eqs. (1)-(14).

For each of the five algorithms (conv Algs 1-3, FC Algs 4-5) this module
gives the closed-form *compute*, *space*, and *communication* complexity and
the resulting compute-to-communication ratio (CCR), exactly as derived in
the paper.  ``schedule_sim.py`` cross-checks every closed form by actually
walking the loop nests and counting DMA words.  The planners of the port
charge the same closed forms when they pick the CUDA kernels' blocks.

Conventions (paper Sec. 1.2.2): one MAC = 2 flops; a "word" is one element
(4 B single precision, 8 B double precision); CCR is MAC/word.

Known paper slip, reproduced deliberately: the numerical intuition in
Sec. 2.3.4 (541.4 / 540.6 MAC/word) does not follow from the paper's own
Eq. (10); it matches Eq. (10) with the ``D_I`` factor dropped from the
input-slice term.  ``alg3_ccr_offchip_as_quoted`` reproduces the quoted
numbers; ``.ccr_offchip`` on :func:`alg3_traffic` follows Eq. (10)
faithfully.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.machine import MachineModel, word_bytes

# ---------------------------------------------------------------------------
# Layer shapes (hyperparameters of Table 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """Convolutional layer hyperparameters (paper Table 1)."""

    W_I: int  # input width and height
    D_I: int  # input depth
    D_O: int  # output depth
    F: int  # receptive field
    S: int = 1  # stride
    P: int = 1  # zero padding

    @property
    def W_O(self) -> int:
        """Output width/height: W_O = (W_I + 2P - F)/S + 1 (paper Sec. 1.1)."""
        num = self.W_I + 2 * self.P - self.F
        if num % self.S:
            raise ValueError(f"(W_I+2P-F)={num} not divisible by stride {self.S}")
        return num // self.S + 1

    def validate(self) -> None:
        if self.F > self.W_I + 2 * self.P:
            raise ValueError("receptive field larger than padded input")
        for f in ("W_I", "D_I", "D_O", "F", "S"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")
        if self.P < 0:
            raise ValueError("padding must be non-negative")


@dataclasses.dataclass(frozen=True)
class FCShape:
    """Fully-connected layer hyperparameters.

    An FC layer is a conv layer with F = W_I, S = 1, P = 0 (paper Sec. 1.1),
    plus a batch dimension B (paper Sec. 3).
    """

    W_I: int
    D_I: int
    D_O: int
    B: int

    def validate(self) -> None:
        for f in ("W_I", "D_I", "D_O", "B"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")


# ---------------------------------------------------------------------------
# Traffic model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Word-granular traffic of one layer execution under one algorithm."""

    macs: int  # total multiply-accumulates across all clusters
    main_loads: int  # words loaded from main (off-chip) memory
    main_stores: int  # words stored to main memory
    intercluster: int = 0  # words moved cluster-to-cluster (on-chip)

    @property
    def main_words(self) -> int:
        return self.main_loads + self.main_stores

    @property
    def ccr(self) -> float:
        """Overall CCR in MAC/word: all memory traffic, on- or off-chip
        (paper Sec. 2.3.4: 'the overall CCR is not affected' by Alg 3)."""
        return self.macs / (self.main_words + self.intercluster)

    @property
    def ccr_offchip(self) -> float:
        """CCR counting only off-chip main-memory words."""
        return self.macs / self.main_words

    def flops_per_byte(self, precision: str, offchip_only: bool = False) -> float:
        """CCR converted to flop/B for a given precision (2 flop per MAC)."""
        ccr = self.ccr_offchip if offchip_only else self.ccr
        return ccr * 2.0 / word_bytes(precision)


# ---------------------------------------------------------------------------
# Conv layers
# ---------------------------------------------------------------------------


def conv_macs(s: ConvShape) -> int:
    """Total MACs of the layer: W_I^2 * F^2 * D_I * D_O (paper Sec. 2.1.1).

    NOTE the paper counts Conv() as W_I^2*F^2 MACs (it slides the filter over
    the *input* extent); we keep that convention for fidelity.  For S=1, P
    'same' padding this equals W_O^2*F^2.
    """
    return s.W_I**2 * s.F**2 * s.D_I * s.D_O


def alg1_traffic(s: ConvShape) -> Traffic:
    """Alg 1: parallelize output depth slices over clusters (Sec. 2.1.3)."""
    loads = s.D_O * s.D_I * (s.W_I**2 + s.F**2)
    stores = s.D_O * s.W_O**2
    return Traffic(macs=conv_macs(s), main_loads=loads, main_stores=stores)


def alg1_ccr(s: ConvShape) -> float:
    """Eq. (2): D_I*W_I^2*F^2 / (D_I*(W_I^2+F^2) + W_O^2)."""
    return (s.D_I * s.W_I**2 * s.F**2) / (s.D_I * (s.W_I**2 + s.F**2) + s.W_O**2)


def alg1_ccr_approx(s: ConvShape) -> float:
    """Eq. (6): CCR ~= F^2  (for W_O=W_I, D_I>>1, W_I^2>>F^2)."""
    return float(s.F**2)


def alg2_traffic(s: ConvShape, stack: int) -> Traffic:
    """Alg 2: stacks of Delta_O output slices per cluster (Sec. 2.2.3, Eq. 7)."""
    n_stacks = math.ceil(s.D_O / stack)
    loads = n_stacks * s.D_I * s.W_I**2 + s.D_O * s.D_I * s.F**2
    stores = s.D_O * s.W_O**2
    return Traffic(macs=conv_macs(s), main_loads=loads, main_stores=stores)


def _strip_rows(s: ConvShape, h_block: int):
    """Real (non-padding) input rows each halo'd strip streams, plus the
    strip's real output rows.  Strip ``h`` covers output rows
    ``[h*h_block, h*h_block + h_block)``; its halo'd input window is rows
    ``[h*h_block*S - P, h*h_block*S - P + (h_block-1)*S + F)`` of the
    unpadded image — zero-padding rows cost no traffic (paper convention:
    Eq. (7) charges W_I^2 input words, not (W_I+2P)^2)."""
    h_in = (h_block - 1) * s.S + s.F
    H_O = s.W_O  # square images throughout the paper
    for h0 in range(0, H_O, h_block):
        lo = h0 * s.S - s.P
        rows_in = min(lo + h_in, s.W_I) - max(lo, 0)
        yield max(0, rows_in), min(h_block, H_O - h0)


def alg2_strip_traffic(s: ConvShape, stack: int, h_block: int) -> Traffic:
    """Strip-tiled Alg 2 (the direct conv kernel's schedule): the output stack is
    held as an ``h_block x W_O`` strip, so each of the ``ceil(H_O/h_block)``
    strips re-streams its halo'd input rows once per stack.  Degenerates to
    Eq. (7) exactly at ``h_block = H_O`` (one strip, halo covers the image).
    """
    n_stacks = math.ceil(s.D_O / stack)
    n_strips = math.ceil(s.W_O / h_block)
    input_words = sum(r_in * s.W_I for r_in, _ in _strip_rows(s, h_block))
    # Each strip is a full Alg 2 pass over its rows: input rows once per
    # stack, filter slabs once per (strip, d_i, d_o) — the kernel's grid
    # order re-streams filters per strip, so the model charges it.
    loads = n_stacks * s.D_I * input_words + n_strips * s.D_O * s.D_I * s.F**2
    stores = s.D_O * s.W_O**2
    return Traffic(macs=conv_macs(s), main_loads=loads, main_stores=stores)


def conv_dgrad_shape(s: ConvShape) -> ConvShape:
    """The backward-data (dgrad) geometry of a conv layer: dX is a
    *stride-1* conv over the S-dilated gradient with spatially flipped
    filters and swapped channel roles (DESIGN.md Sec. 4) — itself a
    ConvShape, so every Alg 1-3 closed form and capacity rule applies to
    the backward pass unchanged.  Requires P <= F-1 (the transposed
    padding F-1-P stays non-negative)."""
    if s.P > s.F - 1:
        raise ValueError(f"dgrad needs P <= F-1, got P={s.P} for F={s.F}")
    return ConvShape(W_I=(s.W_O - 1) * s.S + 1, D_I=s.D_O, D_O=s.D_I,
                     F=s.F, S=1, P=s.F - 1 - s.P)


def conv_dgrad_traffic(s: ConvShape, stack: int, h_block: int,
                       batch: int = 1) -> Traffic:
    """Strip-tiled dgrad traffic: alg2_strip_traffic on the transposed
    geometry (gradient slices stream, Delta_I output slices of dX stack),
    once per batch element."""
    t = alg2_strip_traffic(conv_dgrad_shape(s), stack, h_block)
    return Traffic(macs=batch * t.macs, main_loads=batch * t.main_loads,
                   main_stores=batch * t.main_stores)


def conv_wgrad_traffic(s: ConvShape, stack: int, h_block: int,
                       di_block: int = 1, batch: int = 1) -> Traffic:
    """Backward-filter (wgrad) traffic of the strip-tiled schedule: the
    F^2 x Delta_I x Delta_O filter-gradient accumulator is the resident
    stack.  Each of the ceil(D_O/stack) gradient stacks re-streams every
    halo'd input strip (zero-padding rows free, as in Eq. 7); each of the
    ceil(D_I/di_block) input blocks re-streams the whole gradient plane;
    dW stores exactly once, accumulated over batch and strips on-cluster.
    MACs are counted over the *output* extent (each dW MAC pairs one
    gradient element with one input element) — equal to conv_macs when
    W_O = W_I."""
    n_do = math.ceil(s.D_O / stack)
    n_di = math.ceil(s.D_I / di_block)
    H_O = s.W_O  # square images throughout the paper
    input_words = sum(r_in * s.W_I for r_in, _ in _strip_rows(s, h_block))
    loads = batch * (n_do * s.D_I * input_words + n_di * s.D_O * H_O * s.W_O)
    stores = s.F**2 * s.D_I * s.D_O
    macs = batch * H_O * s.W_O * s.F**2 * s.D_I * s.D_O
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def alg3_traffic(s: ConvShape, stack: int, group: int = 16) -> Traffic:
    """Alg 3: Alg 2 + ring reuse of input slices within an L2 quadrant
    (Sec. 2.3.3, Eqs. 9-10).  ``group`` is the quadrant size (16 clusters).
    """
    n_stacks = math.ceil(s.D_O / stack)
    input_words = n_stacks * s.D_I * s.W_I**2
    # 15/16 of input-slice loads come from a neighbouring cluster, 1/16 from
    # main memory (Eq. 9 / Eq. 10).
    inter = (group - 1) * input_words // group
    main_in = input_words - inter
    loads = main_in + s.D_O * s.D_I * s.F**2
    stores = s.D_O * s.W_O**2
    return Traffic(
        macs=conv_macs(s), main_loads=loads, main_stores=stores, intercluster=inter
    )


def alg3_ccr_offchip_as_quoted(s: ConvShape, stack: int, group: int = 16) -> float:
    """The paper's *quoted* Sec. 2.3.4 numbers (541.4 / 540.6 MAC/word).

    These match Eq. (10) with the D_I factor dropped from the input term —
    an arithmetic slip in the paper's numerical intuition.  Kept so tests can
    pin the published numbers while `alg3_traffic().ccr_offchip` stays
    faithful to Eq. (10).
    """
    n_stacks = math.ceil(s.D_O / stack)
    input_main = n_stacks * s.W_I**2 // group  # paper slip: no * D_I
    denom = input_main + s.D_O * s.D_I * s.F**2 + s.D_O * s.W_O**2
    return conv_macs(s) / denom


# Space complexity (words) -------------------------------------------------


def alg1_space_words(s: ConvShape) -> int:
    """Sec. 2.1.2: W_O^2 + W_I^2 + F^2 words minimum."""
    return s.W_O**2 + s.W_I**2 + s.F**2


def alg2_space_words(s: ConvShape, stack: int) -> int:
    """Sec. 2.2.2: Delta_O*W_O^2 + W_I^2 + F^2 words minimum."""
    return stack * s.W_O**2 + s.W_I**2 + s.F**2


def alg3_space_words(s: ConvShape, stack: int) -> int:
    """Sec. 2.3.2: Alg 2 + one forwarding buffer of W_I^2 words."""
    return alg2_space_words(s, stack) + s.W_I**2


def alg2_strip_space_words(s: ConvShape, stack: int, h_block: int) -> int:
    """Strip-tiled working set: Delta_O strips of h_block*W_O output words
    plus one halo'd input strip of ((h_block-1)S+F) x (W_I+2P) and F^2
    filter words — the accumulator no longer scales with the full plane."""
    h_in = (h_block - 1) * s.S + s.F
    return stack * h_block * s.W_O + h_in * (s.W_I + 2 * s.P) + s.F**2


def alg2_max_stack(s: ConvShape, machine: MachineModel, precision: str) -> int:
    """Largest Delta_O fitting local memory (Sec. 2.2.2).

    The paper reserves 2 x 16 KiB DMA buffers for the input slice and the
    filter parameters; the rest of the 128 KiB holds the output stack.
    """
    wb = word_bytes(precision)
    budget = machine.usable_for_working_set(streams=2)
    return budget // (wb * s.W_O**2)


def alg2_strip_max_stack(
    s: ConvShape, machine: MachineModel, precision: str, h_block: int
) -> int:
    """Largest Delta_O fitting local memory under strip tiling: the strip
    accumulator costs h_block*W_O words per output slice instead of W_O^2,
    so shrinking the strip grows the stack the capacity rule can pick —
    the two-dimensional (h_block, Delta_O) trade-off the kernel schedules."""
    wb = word_bytes(precision)
    budget = machine.usable_for_working_set(streams=2)
    return budget // (wb * h_block * s.W_O)


def alg3_max_stack(s: ConvShape, machine: MachineModel, precision: str) -> int:
    """Largest Delta_O for Alg 3 (Sec. 2.3.2): additionally keep one input
    depth slice resident so the neighbouring cluster can read it."""
    wb = word_bytes(precision)
    budget = machine.usable_for_working_set(streams=2) - wb * s.W_I**2
    return budget // (wb * s.W_O**2)


# ---------------------------------------------------------------------------
# FC layers
# ---------------------------------------------------------------------------


def fc_macs(s: FCShape) -> int:
    """Sec. 3.1.1: W_I^2 * B * D_O * D_I MACs across all clusters."""
    return s.W_I**2 * s.B * s.D_O * s.D_I


def alg4_traffic(s: FCShape, clusters: int = 128) -> Traffic:
    """Alg 4: parallel input depth slices, private outputs, tree reduction
    (Sec. 3.1.3)."""
    loads = s.D_I * s.W_I**2 * (s.B + s.D_O)
    stores = s.D_O * s.B
    inter = (clusters - 1) * s.D_O * s.B  # 127 * D_O * B for 128 clusters
    return Traffic(macs=fc_macs(s), main_loads=loads, main_stores=stores, intercluster=inter)


def alg4_ccr(s: FCShape) -> float:
    """Eq. (11): B*D_O/(B+D_O) — the in-parallel-region CCR."""
    return (s.B * s.D_O) / (s.B + s.D_O)


def alg5_traffic(s: FCShape, stack: int, clusters: int = 128) -> Traffic:
    """Alg 5: output stacks of Delta_O + parallel input slices
    (Sec. 3.2.3, Eqs. 12-13)."""
    n_stacks = math.ceil(s.D_O / stack)
    loads = n_stacks * s.D_I * s.B * s.W_I**2 + s.D_O * s.D_I * s.W_I**2
    stores = s.D_O * s.B
    inter = (clusters - 1) * s.D_O * s.B
    return Traffic(macs=fc_macs(s), main_loads=loads, main_stores=stores, intercluster=inter)


def alg5_ccr(s: FCShape, stack: int) -> float:
    """Eq. (14): B*D_O / (ceil(D_O/Delta_O)*B + D_O)."""
    n_stacks = math.ceil(s.D_O / stack)
    return (s.B * s.D_O) / (n_stacks * s.B + s.D_O)


def alg4_space_words(s: FCShape) -> int:
    """Sec. 3.1.2: D_O*B + W_I^2*(B+1) words minimum."""
    return s.D_O * s.B + s.W_I**2 * (s.B + 1)


def alg5_space_words(s: FCShape, stack: int) -> int:
    """Sec. 3.2.2: Delta_O*B + W_I^2*(B+1) words minimum."""
    return stack * s.B + s.W_I**2 * (s.B + 1)


def alg45_max_stack(s: FCShape, machine: MachineModel, precision: str) -> int:
    """Largest Delta_O (Alg 5) / D_O (Alg 4) whose private output volume fits
    after reserving 2 x 16 KiB DMA buffers (Sec. 3.1.2): 96 KiB on Manticore,
    giving D_O <= 768 (sp) / 384 (dp) at B = 32."""
    wb = word_bytes(precision)
    budget = machine.usable_for_working_set(streams=2)
    return budget // (wb * s.B)


# ---------------------------------------------------------------------------
# Sharded (multi-device) closed forms: the mesh-aware planner's word model
# ---------------------------------------------------------------------------
#
# Arithmetic only, no mesh: the port's planners still raise for more than
# one device (``ShardablePlanner.plan_sharded``), and these forms wait for
# their sharded branches.


def tree_reduce_words(n_parts: int, words_each: int) -> int:
    """Pairwise tree reduction of ``n_parts`` private volumes: each merge
    reads one full volume over the network — (n_parts - 1) * words_each
    total (paper Sec. 3.1.3: 127 * D_O * B for 128 clusters).  The closed
    form behind every psum/batch-contraction ``ici_words`` count."""
    total = 0
    live = n_parts
    while live > 1:
        merges = live // 2
        total += merges * words_each
        live -= merges
    return total


def matmul_block_traffic(*, m: int, n: int, k: int, block_m: int,
                         block_n: int, block_k: int) -> Traffic:
    """Closed form of the blocked-matmul grid walk on the padded problem
    (== schedule_sim.simulate_matmul_blocks): an x block and a w block per
    (i, j, kk) step, one output block store per (i, j) — i.e. x re-streams
    once per output stack, w once per m-block, Alg 5's Eqs. (12)-(13) when
    one m-block covers the batch."""
    mp = math.ceil(m / block_m) * block_m
    np_ = math.ceil(n / block_n) * block_n
    kp = math.ceil(k / block_k) * block_k
    loads = (np_ // block_n) * mp * kp + (mp // block_m) * kp * np_
    stores = mp * np_
    return Traffic(macs=mp * np_ * kp, main_loads=loads, main_stores=stores)


def conv_im2col_traffic(*, H_O: int, W_O: int, F: int, S: int, d_in: int,
                        d_out: int, block_h: int, block_m: int, block_n: int,
                        block_k: int, pool: int = 1, batch: int = 1) -> Traffic:
    """im2col-GEMM conv traffic (== schedule_sim.simulate_conv_im2col).

    The layer runs strip by strip: each strip of ``block_h`` output rows
    expands its receptive fields into a patch matrix A of
    ``batch * rows * W_O`` rows by ``F*F*d_in`` columns and multiplies it
    against the reshaped filter matrix [F*F*d_in, d_out] with the blocked
    GEMM (``matmul_block_traffic``).  The patch matrix never materializes
    whole in HBM — only strip-at-a-time — but its *words are charged in
    full*: every output position reads its complete F x F x d_in patch, an
    input read amplification of ``F*F/S**2`` relative to the raw image
    (each input pixel belongs to up to F^2/S^2 patches, and zero-padding
    pixels are charged like real ones — the patch matrix materializes
    them).  That amplification is the direct kernel's structural edge at
    F > S; im2col wins it back when S > F (strided convs read only the
    pixels their patches use, while the strip kernel streams whole rows)
    or when the GEMM's blocking beats the strip accumulator's.

    With ``pool > 1`` the pool epilogue is *not* fused into the GEMM (the
    direct kernel fuses it into the flush): the un-pooled strip outputs
    store from the GEMM, then the pool pass re-reads each window and
    stores the pooled plane.
    """
    k = F * F * d_in
    loads = stores = macs = 0
    for h0 in range(0, H_O, block_h):
        rows = min(block_h, H_O - h0)
        t = matmul_block_traffic(m=batch * rows * W_O, n=d_out, k=k,
                                 block_m=block_m, block_n=block_n,
                                 block_k=block_k)
        loads += t.main_loads
        stores += t.main_stores
        macs += t.macs
    if pool > 1:
        pooled = (H_O // pool) * (W_O // pool)
        loads += batch * pooled * pool * pool * d_out
        stores += batch * pooled * d_out
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def ring_traffic(*, m: int, n: int, k: int, devices: int) -> Traffic:
    """Alg 3's ring reuse on the FC/matmul mesh: X is
    K-sharded, W is N-sharded with full K, and each device multiplies the
    resident X shard while permuting it to its ring neighbour — so every
    X word is loaded from main memory exactly once (by its home device)
    and travels the ring (devices - 1) times, exactly like the paper's
    DmaLoad from cluster (CID - 1) mod 16.

    Per device: loads = M*K/P (own shard) + K*N/P (its weight columns),
    stores = M*N/P, interconnect sends = (P-1) * M*K/P.
    """
    if devices <= 0 or k % devices or n % devices:
        raise ValueError(
            f"ring needs K and N divisible by the mesh: k={k}, n={n}, "
            f"devices={devices}")
    k_loc, n_loc = k // devices, n // devices
    loads = devices * (m * k_loc + k * n_loc)  # == m*k + k*n
    stores = devices * m * n_loc  # == m*n
    inter = devices * (devices - 1) * m * k_loc  # == (P-1) * m*k
    return Traffic(macs=m * n * k, main_loads=loads, main_stores=stores,
                   intercluster=inter)


def fc_psum_traffic(*, m: int, n: int, k: int, devices: int, block_m: int,
                    block_n: int, block_k: int) -> Traffic:
    """The sharded FC layer's "psum" strategy (Alg 4 over a mesh axis):
    every device runs the blocked matmul on its K-shard and the private
    [M, N] partial outputs merge by tree reduction."""
    if devices <= 0 or k % devices:
        raise ValueError(f"psum needs K divisible by the mesh: k={k}, "
                         f"devices={devices}")
    local = matmul_block_traffic(m=m, n=n, k=k // devices, block_m=block_m,
                                 block_n=block_n, block_k=block_k)
    return Traffic(
        macs=devices * local.macs,
        main_loads=devices * local.main_loads,
        main_stores=devices * local.main_stores,
        intercluster=tree_reduce_words(devices, m * n),
    )


def tp_matmul_traffic(*, m: int, n: int, k: int, devices: int, block_m: int,
                      block_n: int, block_k: int) -> Traffic:
    """Megatron-style tensor-parallel matmul: W is column (N) sharded, X
    replicated, so each device runs the blocked matmul on its [k, n/P]
    weight columns and the private [m, n/P] activation shards all-gather
    over the interconnect — (P - 1) * m * n words, the same count whether
    the gather runs as a ring or a tree (``tree_reduce_words``).

    The trade against "batch" data parallelism is weight words vs
    activation words: batch re-streams the *full* weight per device
    (P * k * n loads total) while TP streams each weight column once
    (k * n total) but pays the activation gather — at small m (serving
    decode, small microbatches) the weight term dominates and TP wins;
    at large m batch parallelism's zero ici wins."""
    if devices <= 0 or n % devices:
        raise ValueError(
            f"tp needs N divisible by the mesh: n={n}, devices={devices}")
    local = matmul_block_traffic(m=m, n=n // devices, k=k, block_m=block_m,
                                 block_n=block_n, block_k=block_k)
    return Traffic(
        macs=devices * local.macs,
        main_loads=devices * local.main_loads,
        main_stores=devices * local.main_stores,
        intercluster=tree_reduce_words(devices, m * n),
    )


def moe_all_to_all_words(*, tokens: int, d_model: int, top_k: int,
                         n_experts: int, devices: int) -> int:
    """Expert-parallel MoE all-to-all interconnect words (dispatch +
    return): each device owns ``tokens / P`` rows routed to ``top_k``
    experts each; experts are sharded ``E / P`` per device, and with the
    balanced slot-major dispatch (models/moe.py's capacity argsort) every
    expert receives an equal share of each device's routed rows.  A row
    bound for a remote expert crosses the interconnect twice — d_model
    words out to the expert's device, d_model back after the FFN — and a
    fraction (P - 1) / P of every device's routed rows are remote:

        2 * d_model * top_k * (tokens / P) * (P - 1)

    Pinned word-for-word against ``schedule_sim.simulate_moe_all_to_all``
    (the literal per-device, per-expert dispatch walk)."""
    if devices <= 0 or tokens % devices:
        raise ValueError(f"ep needs tokens divisible by the mesh: "
                         f"tokens={tokens}, devices={devices}")
    if n_experts % devices:
        raise ValueError(f"ep needs experts divisible by the mesh: "
                         f"n_experts={n_experts}, devices={devices}")
    t_loc = tokens // devices
    if (t_loc * top_k) % n_experts:
        raise ValueError(
            f"balanced dispatch needs local routed rows divisible by the "
            f"experts: tokens/P * top_k = {t_loc * top_k}, "
            f"n_experts={n_experts}")
    return 2 * d_model * top_k * t_loc * (devices - 1)


def conv_sharded_traffic(s: ConvShape, stack: int, h_block: int, *,
                         devices: int, strategy: str = "batch",
                         batch: int = 1) -> Traffic:
    """Sharded strip-tiled conv (forward): pure data parallelism.

    "batch" shards the batch dimension (each device walks the full strip
    schedule on batch/devices images); "stack" shards output depth (each
    device owns D_O/devices slices and re-streams the whole input for its
    stacks).  Neither moves interconnect words in the forward pass — the
    split matters because the sharded *wgrad* pays the tree reduction.
    """
    if strategy == "batch":
        if batch % devices:
            raise ValueError(f"batch {batch} not divisible by {devices}")
        t = alg2_strip_traffic(s, stack, h_block)
        return Traffic(macs=batch * t.macs, main_loads=batch * t.main_loads,
                       main_stores=batch * t.main_stores)
    if strategy == "stack":
        if s.D_O % devices:
            raise ValueError(f"D_O {s.D_O} not divisible by {devices}")
        sl = dataclasses.replace(s, D_O=s.D_O // devices)
        t = alg2_strip_traffic(sl, min(stack, sl.D_O), h_block)
        return Traffic(macs=batch * devices * t.macs,
                       main_loads=batch * devices * t.main_loads,
                       main_stores=batch * devices * t.main_stores)
    raise ValueError(strategy)


# ---------------------------------------------------------------------------
# Critical-path steps: the overlap-aware cost axis (words -> words + steps)
# ---------------------------------------------------------------------------
#
# A planned kernel is a software pipeline: each grid step's input DMA
# overlaps the previous step's compute, so once per-step words are hidden
# the wall time scales with the number of *sequential steps on the critical
# path*.  The closed forms below must equal the executed walkers in
# schedule_sim (house rule); planners record the result in
# ``Schedule.critical_path_steps`` and the backward planners argmin
# ``modeled_words + critical_path_steps``.


def grid_steps(grid) -> int:
    """Sequential steps of a plain software-pipelined grid
    (== schedule_sim.simulate_grid_steps): one step per grid point plus
    one pipeline-fill step (the first fetch overlaps no compute)."""
    steps = 1
    for g in grid:
        steps *= g
    return steps + 1


def conv_dgrad_fused_steps(*, H_I: int, d_in: int, block_h: int,
                           block_do: int, batch: int = 1) -> int:
    """Critical-path steps of the fused-epilogue dgrad variant
    (== schedule_sim.simulate_conv_dgrad_fused_steps).  The d_out stream
    is folded *inside* each grid step by the double-buffered DMA loop, so
    the sequential grid walks only (batch, dX strip, dX channel stack);
    plus one pipeline-fill step and one step for the mask-scatter
    prologue that rebuilds the full-rate dY from the pooled gradient."""
    n_h = -(-H_I // block_h)
    n_do = -(-d_in // block_do)
    return batch * n_h * n_do + 2


def conv_wgrad_steps(*, H_O: int, d_in: int, d_out: int, block_h: int,
                     block_di: int, block_do: int, batch: int = 1,
                     pipelined: bool = False) -> int:
    """Critical-path steps of the wgrad kernel
    (== schedule_sim.simulate_conv_wgrad_steps).  The direct grid walks
    (d_i block, d_o stack, batch, strip) + fill; the pipelined variant
    folds the (batch, strip) accumulation sweep into each (d_i, d_o) step
    with double-buffered strip DMA, leaving only n_di * n_do sequential
    steps."""
    n_di = -(-d_in // block_di)
    n_do = -(-d_out // block_do)
    n_h = -(-H_O // block_h)
    inner = 1 if pipelined else batch * n_h
    return n_di * n_do * inner + 1


def epilogue_scatter_traffic(*, H_O: int, W_O: int, d_out: int, pool: int,
                             batch: int = 1, in_bytes: int = 4) -> Traffic:
    """The fused epilogue VJP's scatter pass
    (== schedule_sim.simulate_epilogue_scatter): read the pooled gradient
    and the int8 pool-argmax/ReLU mask (charged in words — ``in_bytes``
    mask bytes pack into one word), store the full-rate dY that the dgrad
    and wgrad streams then consume.  This replaces the recompute path's
    full forward-conv re-run (``alg2_strip_traffic`` words) whose only
    purpose was rebuilding the same mask."""
    pooled = batch * (H_O // pool) * (W_O // pool) * d_out
    loads = pooled + -(-pooled // in_bytes)  # pooled dY + packed int8 mask
    stores = batch * H_O * W_O * d_out  # scattered full-rate dY
    return Traffic(macs=0, main_loads=loads, main_stores=stores)


# ---------------------------------------------------------------------------
# Roofline hook: is the algorithm memory-bound on a machine?
# ---------------------------------------------------------------------------


def bound_kind(t: Traffic, machine: MachineModel, precision: str) -> str:
    """Classify compute- vs memory-bound: compare the layer's off-chip
    arithmetic intensity (flop/B) against the machine balance point."""
    intensity = t.flops_per_byte(precision, offchip_only=True)
    balance = machine.peak_flops / machine.main_mem_bw
    return "compute-bound" if intensity >= balance else "memory-bound"
