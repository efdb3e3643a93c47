"""Word-counting simulators for the paper's Algorithms 1-5.

Each simulator walks the *exact* loop nest of the corresponding pseudocode
(including the software-pipelined prefetch structure, ragged final stacks,
and Alg 3's modulo-16 ring schedule) and tallies every DmaLoad/DmaStore and
inter-cluster transfer in words.  Tests assert these counts equal the
closed forms in :mod:`repro_torch.core.ccr` — i.e. we *validate the
paper's analysis by executing its schedules*.  Pure Python: nothing here
runs on the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

from repro_torch.core.ccr import (
    ConvShape, FCShape, Traffic, conv_dgrad_shape, conv_macs, fc_macs, tree_reduce_words,
)


def simulate_alg1(s: ConvShape) -> Traffic:
    """Algorithm 1: one output depth slice per cluster task."""
    loads = stores = macs = 0
    for _d_o in range(s.D_O):  # parallelize over clusters
        # Prefetch of iteration 0 + in-loop prefetch of d_i+1 together load
        # exactly one input slice + one filter slab per d_i.
        for _d_i in range(s.D_I):
            loads += s.W_I**2  # DmaLoad(I[:,:,d_i])
            loads += s.F**2  # DmaLoad(F[:,:,d_i,d_o])
            macs += s.W_I**2 * s.F**2  # Conv()
        stores += s.W_O**2  # DmaStore(O[:,:,d_o])
    assert macs == conv_macs(s)
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def _stacks(D_O: int, stack: int):
    for begin in range(0, D_O, stack):
        yield begin, min(begin + stack, D_O)


def simulate_alg2(s: ConvShape, stack: int) -> Traffic:
    """Algorithm 2: stacks of Delta_O output depth slices per cluster task."""
    loads = stores = macs = 0
    for begin, end in _stacks(s.D_O, stack):  # parallelize over clusters
        for _d_i in range(s.D_I):
            loads += s.W_I**2  # input slice, loaded once per stack
            for _d_o in range(begin, end):
                loads += s.F**2  # filter slab per (d_i, d_o)
                macs += s.W_I**2 * s.F**2
        stores += (end - begin) * s.W_O**2
    assert macs == conv_macs(s)
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def simulate_alg2_strip(s: ConvShape, stack: int, h_block: int) -> Traffic:
    """Strip-tiled Algorithm 2 (the direct conv kernel's schedule, DESIGN.md
    Sec. 2): the outer loops walk (strip, stack), the inner loop is the
    paper's ``for d_i``; each strip streams only its halo'd input rows
    (zero-padding rows are free) and re-streams filter slabs, and the
    flush stores the strip of the output stack exactly once."""
    H_O = s.W_O  # square images throughout the paper
    h_in = (h_block - 1) * s.S + s.F
    loads = stores = macs = 0
    for h0 in range(0, H_O, h_block):  # spatial strips
        lo = h0 * s.S - s.P  # first halo'd input row (unpadded coords)
        rows_in = max(0, min(lo + h_in, s.W_I) - max(lo, 0))
        rows_out = min(h_block, H_O - h0)
        for begin, end in _stacks(s.D_O, stack):  # parallelize over clusters
            for _d_i in range(s.D_I):
                loads += rows_in * s.W_I  # halo'd input strip, once per stack
                for _d_o in range(begin, end):
                    loads += s.F**2  # filter slab per (strip, d_i, d_o)
                    macs += rows_out * s.W_I * s.F**2
            stores += (end - begin) * rows_out * s.W_O
    if s.W_O == s.W_I:  # paper convention counts MACs over the input extent
        assert macs == conv_macs(s)
    return Traffic(macs=conv_macs(s), main_loads=loads, main_stores=stores)


def simulate_alg3(s: ConvShape, stack: int, group: int = 16) -> Traffic:
    """Algorithm 3: Alg 2 + ring reuse of input slices inside an L2 quadrant.

    Each task runs on a cluster; CID_in_L2 = CID mod ``group``.  A cluster
    loads input slice ``d`` from main memory iff ``d % group == CID_in_L2``
    (it is that slice's "home"), otherwise from its ring predecessor.
    Faithful to the pseudocode including the wrap-around loop order
    ``d_i <- CID..D_I then 0..CID``.
    """
    loads = stores = macs = inter = 0
    for task, (begin, end) in enumerate(_stacks(s.D_O, stack)):
        cid = task % group  # round-robin placement inside a quadrant
        start = cid % s.D_I if s.D_I else 0
        # Initial load: DmaLoad(I[:,:,CID_in_L2]) from main memory.
        loads += s.W_I**2
        order = list(range(start, s.D_I)) + list(range(0, start))
        for d_i in order:
            d_next = (d_i + 1) % s.D_I
            if d_next != start:  # prefetch next slice
                if d_next % group == cid:
                    loads += s.W_I**2  # home slice: from main memory
                else:
                    inter += s.W_I**2  # from ring predecessor's L1
            for _d_o in range(begin, end):
                loads += s.F**2
                macs += s.W_I**2 * s.F**2
        stores += (end - begin) * s.W_O**2
    assert macs == conv_macs(s)
    return Traffic(macs=macs, main_loads=loads, main_stores=stores, intercluster=inter)


def simulate_conv_dgrad(s: ConvShape, stack: int, h_block: int,
                        batch: int = 1) -> Traffic:
    """Walk the dgrad schedule: the strip-tiled Alg 2 loop nest over the
    transposed geometry (ccr.conv_dgrad_shape — S-dilated gradient in,
    flipped channel-swapped filters, Delta_I output stacking), executed
    once per batch element."""
    sT = conv_dgrad_shape(s)
    loads = stores = macs = 0
    for _b in range(batch):
        t = simulate_alg2_strip(sT, stack, h_block)
        loads += t.main_loads
        stores += t.main_stores
        macs += t.macs
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def simulate_conv_wgrad(s: ConvShape, stack: int, h_block: int,
                        di_block: int = 1, batch: int = 1) -> Traffic:
    """Walk the wgrad kernel's grid (d_i-block, d_o-stack, batch, strip):
    every step streams the halo'd input strip (zero-padding rows free) and
    the gradient strip; the F^2 x Delta_I x Delta_O accumulator stays
    resident across the whole (batch, strip) sweep and flushes exactly
    once at the end."""
    H_O = s.W_O  # square images throughout the paper
    h_in = (h_block - 1) * s.S + s.F
    loads = macs = 0
    for di0 in range(0, s.D_I, di_block):
        ndi = min(di_block, s.D_I - di0)
        for do0 in range(0, s.D_O, stack):
            ndo = min(stack, s.D_O - do0)
            for _b in range(batch):
                for h0 in range(0, H_O, h_block):
                    lo = h0 * s.S - s.P
                    rows_in = max(0, min(lo + h_in, s.W_I) - max(lo, 0))
                    rows_out = min(h_block, H_O - h0)
                    loads += rows_in * s.W_I * ndi   # DmaLoad input strip
                    loads += rows_out * s.W_O * ndo  # DmaLoad gradient strip
                    macs += rows_out * s.W_O * s.F**2 * ndi * ndo
    stores = s.F**2 * s.D_I * s.D_O  # single DmaStore of accumulated dW
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def simulate_matmul_blocks(m: int, n: int, k: int,
                           bm: int, bn: int, bk: int) -> Traffic:
    """Walk the blocked-matmul grid (i, j, kk) exactly as the kernel's
    tiles are fetched: an x block (bm x bk) and a w block (bk x bn) per
    step, one (bm x bn) store per (i, j); the walk is over the padded
    problem, as on the device.  The dX kernel is this walk with roles
    (m, n, k) -> (m, k, n); the dW kernel with (k, n, m)."""
    mp = -(-m // bm) * bm
    np_ = -(-n // bn) * bn
    kp = -(-k // bk) * bk
    loads = stores = macs = 0
    for _i in range(mp // bm):
        for _j in range(np_ // bn):
            for _kk in range(kp // bk):
                loads += bm * bk + bk * bn
                macs += bm * bn * bk
            stores += bm * bn
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def simulate_conv_im2col(*, H_O: int, W_O: int, F: int, S: int, d_in: int,
                         d_out: int, block_h: int, block_m: int,
                         block_n: int, block_k: int, pool: int = 1,
                         batch: int = 1) -> Traffic:
    """Walk the im2col-GEMM conv schedule strip by strip: each strip of
    ``block_h`` output rows expands into a patch matrix of
    ``batch * rows * W_O`` x ``F*F*d_in`` (every patch word charged —
    the F*F/S^2 read amplification of im2col, zero-padding included) and
    runs the blocked-matmul grid walk against the [F*F*d_in, d_out]
    filter matrix; with ``pool > 1`` the unfused pool epilogue re-reads
    every pool window of the stored conv output and stores the pooled
    plane.  ``ccr.conv_im2col_traffic`` must equal this executed count."""
    k = F * F * d_in
    loads = stores = macs = 0
    for h0 in range(0, H_O, block_h):  # spatial strips, patch matrix per strip
        rows = min(block_h, H_O - h0)
        t = simulate_matmul_blocks(batch * rows * W_O, d_out, k,
                                   block_m, block_n, block_k)
        loads += t.main_loads
        stores += t.main_stores
        macs += t.macs
    if pool > 1:  # unfused pool epilogue over the stored conv output
        for _b in range(batch):
            for _ph in range(H_O // pool):
                for _pw in range(W_O // pool):
                    loads += pool * pool * d_out  # re-read the window
                    stores += d_out  # pooled element per output slice
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def simulate_attention_blocks(
    *, seq_q: int, seq_kv: int, head_dim: int, block_q: int, block_kv: int,
    n_q_heads: int = 1, n_kv_heads: int = 1, batch: int = 1,
    causal: bool = False, window: int | None = None,
) -> Traffic:
    """Walk the flash-attention grid (batch*head, q block, kv block)
    applying the kernel's block-level `run` predicate verbatim: causal
    skips KV blocks entirely in the future, a sliding window skips blocks
    entirely before the window.  Counts q/k/v block loads, output stores
    and both matmuls' MACs — AttentionPlanner's closed form must equal
    this executed count.  The skips are real savings on the kernel too:
    it walks each q block's run range alone, so a skipped K/V block is
    never fetched."""
    del n_kv_heads  # GQA shares no HBM traffic: the grid refetches per q head
    sqp = -(-seq_q // block_q) * block_q
    skvp = -(-seq_kv // block_kv) * block_kv
    loads = stores = macs = 0
    for _h in range(batch * n_q_heads):
        for qb in range(sqp // block_q):
            q_start = qb * block_q
            loads += block_q * head_dim  # q block, once per (head, qb)
            for kb in range(skvp // block_kv):
                k_start = kb * block_kv
                run = True
                if causal:  # kernel: k_start <= q_start + block_q - 1
                    run = run and k_start <= q_start + block_q - 1
                if window is not None:  # kernel: block not fully pre-window
                    run = run and k_start + block_kv - 1 > q_start - window
                if run:
                    loads += 2 * block_kv * head_dim  # k and v blocks
                    macs += 2 * block_q * block_kv * head_dim  # qk^T and pv
            stores += block_q * head_dim
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def simulate_ring(*, m: int, n: int, k: int, devices: int) -> Traffic:
    """Walk core/ring.py's Alg-3 ring schedule device by device: each
    device loads its own X shard [m, k/P] and its full-K weight columns
    [k, n/P] from main memory, then runs P multiply steps, permuting the
    resident shard to its ring neighbour after each of the first P-1
    (the last step's shard is already resident — Alg 3's P-1 hops)."""
    if devices <= 0 or k % devices or n % devices:  # as ccr.ring_traffic
        raise ValueError(
            f"ring needs K and N divisible by the mesh: k={k}, n={n}, "
            f"devices={devices}")
    k_loc, n_loc = k // devices, n // devices
    loads = stores = macs = inter = 0
    for _dev in range(devices):
        loads += m * k_loc  # DmaLoad of the device's own input shard
        loads += k * n_loc  # full-K weight columns for its output shard
        for step in range(devices):
            macs += m * n_loc * k_loc  # resident shard @ matching W rows
            if step < devices - 1:
                inter += m * k_loc  # send to the ring neighbour
        stores += m * n_loc  # its N-shard of the output
    return Traffic(macs=macs, main_loads=loads, main_stores=stores,
                   intercluster=inter)


def simulate_fc_psum(*, m: int, n: int, k: int, devices: int, block_m: int,
                     block_n: int, block_k: int) -> Traffic:
    """Walk the sharded FC "psum" strategy: every device executes the
    blocked-matmul grid on its K-shard (simulate_matmul_blocks), then the
    private [m, n] partial outputs merge by pairwise tree reduction.
    Devices are symmetric, so one device's grid is walked and scaled."""
    t = simulate_matmul_blocks(m, n, k // devices, block_m, block_n,
                               block_k)
    inter = tree_reduce_words(devices, m * n)
    return Traffic(macs=devices * t.macs, main_loads=devices * t.main_loads,
                   main_stores=devices * t.main_stores, intercluster=inter)


def simulate_tp_matmul(*, m: int, n: int, k: int, devices: int, block_m: int,
                       block_n: int, block_k: int) -> Traffic:
    """Walk the tensor-parallel (megatron column-split) matmul device by
    device: each device runs the blocked-matmul grid on its [k, n/P]
    weight columns (simulate_matmul_blocks), then ring-all-gathers its
    private [m, n/P] activation shard — P - 1 hops per device, each
    moving the m * n/P shard.  == ccr.tp_matmul_traffic (the gather's
    total (P-1) * m * n words match the tree form exactly)."""
    if devices <= 0 or n % devices:  # as ccr.tp_matmul_traffic
        raise ValueError(
            f"tp needs N divisible by the mesh: n={n}, devices={devices}")
    n_loc = n // devices
    loads = stores = macs = inter = 0
    for _dev in range(devices):
        t = simulate_matmul_blocks(m, n_loc, k, block_m, block_n, block_k)
        loads += t.main_loads
        stores += t.main_stores
        macs += t.macs
        for _step in range(devices - 1):
            inter += m * n_loc  # send its shard around the ring
    return Traffic(macs=macs, main_loads=loads, main_stores=stores,
                   intercluster=inter)


def simulate_moe_all_to_all(*, tokens: int, d_model: int, top_k: int,
                            n_experts: int, devices: int) -> int:
    """Walk the expert-parallel dispatch literally: for every device, for
    every routed row (tokens/P rows * top_k routes, spread evenly over
    the experts by the balanced slot-major dispatch), find the expert's
    owner device (experts are contiguously sharded E/P per device, as in
    ``repro``'s expert-parallel MoE shards them); a remote row
    crosses the interconnect twice (d_model out, d_model back).
    == ccr.moe_all_to_all_words."""
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
    rows_per_expert = t_loc * top_k // n_experts
    e_local = n_experts // devices
    inter = 0
    for p in range(devices):
        for e in range(n_experts):
            owner = e // e_local
            if owner != p:
                for _row in range(rows_per_expert):
                    inter += 2 * d_model  # dispatch out + FFN result back
    return inter


def simulate_sharded_conv_strip(s: ConvShape, stack: int, h_block: int, *,
                                devices: int, strategy: str = "batch",
                                batch: int = 1) -> Traffic:
    """Walk the sharded strip-tiled conv forward: under "batch" each device
    runs the full simulate_alg2_strip nest on its batch/devices images;
    under "stack" each device owns D_O/devices output slices and walks the
    nest on that local depth.  No interconnect words move (forward data
    parallelism; the backward wgrad pays the tree reduction).  One
    (device, image) nest is walked and scaled — every iteration of the
    symmetric outer loops is identical."""
    if strategy == "batch":
        if batch % devices:
            raise ValueError(f"batch {batch} not divisible by {devices}")
        t = simulate_alg2_strip(s, stack, h_block)
        n = batch  # devices * (batch // devices) identical image walks
    elif strategy == "stack":
        if s.D_O % devices:
            raise ValueError(f"D_O {s.D_O} not divisible by {devices}")
        sl = dataclasses.replace(s, D_O=s.D_O // devices)
        t = simulate_alg2_strip(sl, min(stack, sl.D_O), h_block)
        n = devices * batch
    else:
        raise ValueError(strategy)
    return Traffic(macs=n * t.macs, main_loads=n * t.main_loads,
                   main_stores=n * t.main_stores)


def simulate_alg4(s: FCShape, clusters: int = 128) -> Traffic:
    """Algorithm 4: input depth slices parallel over clusters, private
    outputs, tree reduction."""
    loads = stores = macs = 0
    for _d_i in range(s.D_I):  # parallelize over clusters
        loads += s.W_I**2 * s.B  # DmaLoad(I[:,:,d_i,:]) - whole batch
        for _d_o in range(s.D_O):
            loads += s.W_I**2  # DmaLoad(F[:,:,d_i,d_o])
            for _b in range(s.B):
                macs += s.W_I**2  # ElemMac()
    inter = tree_reduce_words(clusters, s.D_O * s.B)
    stores = s.D_O * s.B  # one cluster stores O
    assert macs == fc_macs(s)
    return Traffic(macs=macs, main_loads=loads, main_stores=stores, intercluster=inter)


def simulate_alg5(s: FCShape, stack: int, clusters: int = 128) -> Traffic:
    """Algorithm 5: outer loop over output stacks, Alg 4 inside."""
    loads = stores = macs = inter = 0
    for begin, end in _stacks(s.D_O, stack):
        for _d_i in range(s.D_I):  # parallelize over clusters
            loads += s.W_I**2 * s.B
            for _d_o in range(begin, end):
                loads += s.W_I**2
                macs += s.W_I**2 * s.B
        inter += tree_reduce_words(clusters, (end - begin) * s.B)
        stores += (end - begin) * s.B
    assert macs == fc_macs(s)
    return Traffic(macs=macs, main_loads=loads, main_stores=stores, intercluster=inter)


# ---------------------------------------------------------------------------
# Critical-path step walkers (the overlap-aware cost axis).  Each walks the
# literal sequential loop structure of the kernel's software pipeline and
# counts steps; tests assert the counts equal the ccr closed forms.
# ---------------------------------------------------------------------------


def simulate_grid_steps(grid) -> int:
    """Walk a plain software-pipelined grid point by point: every grid
    point is one sequential step, plus the pipeline-fill fetch before the
    first compute.  == ccr.grid_steps."""
    steps = 1  # pipeline fill: the first fetch overlaps no compute
    for _pt in itertools.product(*(range(g) for g in grid)):
        steps += 1
    return steps


def simulate_conv_dgrad_fused_steps(*, H_I: int, d_in: int, block_h: int,
                                    block_do: int, batch: int = 1) -> int:
    """Walk the fused-epilogue dgrad pipeline: one mask-scatter prologue
    step, one double-buffer warm-up fetch, then one step per
    (batch, dX strip, dX stack) grid point — the d_out stream is folded
    inside each step by the overlapped DMA loop, so it adds no sequential
    steps.  == ccr.conv_dgrad_fused_steps."""
    steps = 1  # scatter prologue: pooled dY + mask -> full-rate dY
    steps += 1  # pipeline fill: warm-up fetch of the first d_out slab
    for _b in range(batch):
        for _h0 in range(0, H_I, block_h):
            for _do0 in range(0, d_in, block_do):
                steps += 1
    return steps


def simulate_conv_wgrad_steps(*, H_O: int, d_in: int, d_out: int,
                              block_h: int, block_di: int, block_do: int,
                              batch: int = 1,
                              pipelined: bool = False) -> int:
    """Walk the wgrad grid: direct runs every (d_i, d_o, batch, strip)
    point sequentially; pipelined folds the (batch, strip) accumulation
    sweep into each (d_i, d_o) step behind double-buffered strip DMA.
    == ccr.conv_wgrad_steps."""
    steps = 1  # pipeline fill
    for _di0 in range(0, d_in, block_di):
        for _do0 in range(0, d_out, block_do):
            if pipelined:
                steps += 1  # (batch, strip) sweep hidden inside the step
            else:
                for _b in range(batch):
                    for _h0 in range(0, H_O, block_h):
                        steps += 1
    return steps


def simulate_epilogue_scatter(*, H_O: int, W_O: int, d_out: int, pool: int,
                              batch: int = 1, in_bytes: int = 4) -> Traffic:
    """Walk the fused epilogue VJP's scatter: per pooled output pixel read
    the pooled gradient element, route it to the argmax position of its
    pool window (zeros elsewhere), store the full pool*pool window of the
    full-rate dY; the int8 mask is read once, packed in_bytes per word.
    == ccr.epilogue_scatter_traffic."""
    loads = stores = 0
    for _b in range(batch):
        for _ph in range(H_O // pool):
            for _pw in range(W_O // pool):
                loads += d_out  # pooled gradient element per slice
                for _py in range(pool):
                    for _px in range(pool):
                        stores += d_out  # scattered full-rate dY
    pooled = batch * (H_O // pool) * (W_O // pool) * d_out
    loads += -(-pooled // in_bytes)  # int8 mask, in_bytes packed per word
    return Traffic(macs=0, main_loads=loads, main_stores=stores)


def n_stacks(D_O: int, stack: int) -> int:
    return math.ceil(D_O / stack)
