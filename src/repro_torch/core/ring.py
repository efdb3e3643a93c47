"""Algorithm 3 on the mesh: ring reuse of input shards with overlap.

The paper's Alg 3 replaces main-memory loads of input depth slices with
loads from the neighbouring cluster.  Across ranks the same reuse replaces
an all-gather of the activations with neighbour permutes, each overlapped
with the product of the shard already resident:

  * each rank owns one K-shard of the activations (an "input depth slice")
    and the full-K weight columns of its N-shard (its Delta_O output
    stack's filter parameters);
  * at every step it multiplies the resident activation shard against the
    matching weight rows on the port's matmul kernel (the local schedule
    the ShardedSchedule carries) while the shard travels on to its ring
    neighbour — the transfer hidden behind the product like the paper's
    double-buffered DmaLoad from cluster (CID-1) mod 16.

After P steps every rank holds its complete output shard; the only
collective is P-1 neighbour permutes (the last resident shard needs no
trailing hop — ``schedule_sim.simulate_ring`` walks exactly this loop).
The backward is the reverse ring: each step's dX contribution travels back
along the inverse permutation while the next one is computed, and each
weight block's dW is the saved shard against the output's cotangent, both
on the planned dX/dW kernels at the ring's local shapes.

The partitioning is a planner output: :func:`ring_matmul` resolves a
:class:`~repro_torch.plan.ShardedSchedule` through the ``matmul`` op
(``strategy="ring"``) and executes it through the registry's sharded
dispatch, so the specs come from ``schedule.partition`` and the modeled
words from ``ccr.ring_traffic``.
"""

from __future__ import annotations

import torch

from repro_torch.runtime import collectives as coll


def _w_block(w_cols, src: int, k_loc: int):
    return w_cols[src * k_loc:(src + 1) * k_loc]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_shard, w_cols, mesh, axis, schedule):
        from repro_torch.kernels.matmul.ops import fc_matmul

        p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        k_loc = x_shard.shape[1]
        perm = [(j, (j + 1) % p) for j in range(p)]
        acc = torch.zeros(x_shard.shape[0], w_cols.shape[1], dtype=torch.float32,
                          device=x_shard.device)
        xs, seen = x_shard.detach(), []
        for i in range(p):
            seen.append(xs)
            # P-1 permutes, then the last resident shard with no trailing hop.
            hop = coll.ppermute_start(xs, mesh, axis, perm) if i < p - 1 else None
            acc += fc_matmul(xs, _w_block(w_cols, (idx - i) % p, k_loc),
                             schedule=schedule).float()
            if hop is not None:
                xs = hop.wait()
        ctx.save_for_backward(w_cols, *seen)
        ctx.mesh, ctx.axis = mesh, axis
        return acc.to(x_shard.dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.fc_layer import _fc_bwd

        w_cols, *seen = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        k_loc = seen[0].shape[1]
        back = [(j, (j - 1) % p) for j in range(p)]
        dw = torch.zeros_like(w_cols)

        def step(i):
            src = (idx - i) % p
            dx_i, dw_i = _fc_bwd(seen[i], _w_block(w_cols, src, k_loc), g, None, None,
                                 needs=(True, True))
            dw[src * k_loc:(src + 1) * k_loc] = dw_i
            return dx_i

        # Step i's shard arrived from i hops up the ring: its cotangent goes
        # back one hop a step, summed with each earlier step's on the way.
        dx = step(p - 1)
        for i in range(p - 2, -1, -1):
            hop = coll.ppermute_start(dx, mesh, axis, back)
            dx_i = step(i)
            dx = hop.wait() + dx_i
        return dx, dw, None, None, None


def ring_matmul_local(x_shard, w_cols, mesh, axis: str, schedule=None):
    """Rank-local Alg 3: ``x_shard`` [M, K/P] (this rank's input slice),
    ``w_cols`` [K, N/P] (the full-K weight columns of this rank's output
    stack) -> [M, N/P].  ``schedule`` is the local Schedule of each step's
    product (the planner's when ``None``)."""
    return _Ring.apply(x_shard, w_cols, mesh, axis, schedule)


def ring_matmul(x, w, mesh, axis: str = "model", schedule=None):
    """O = X @ W with X K-sharded and W N-sharded over ``axis``; every rank
    passes the global x [M, K] and w [K, N] and gets the global [M, N].

    ``schedule`` (a ShardedSchedule) pins the partitioning; by default the
    mesh-aware MatmulPlanner plans it with the ring strategy pinned."""
    from repro_torch.plan import get_op

    op = get_op("matmul")
    if schedule is None:
        schedule = op.plan_sharded(x, w, mesh=mesh, axis=axis, strategy="ring")
    return op.sharded(x, w, schedule=schedule, mesh=mesh)
