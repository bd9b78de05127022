"""Train-step builders: the plain step and the wavelet-synced multi-pod step
(port of ``repro.train.train_step``).

Both return ``(params, opt_state, metrics)``-style results and take trees
of tensors where they live (``repro_torch.models`` runs on the params'
device).  Gradients come from ``torch.autograd.grad`` over detached
copies of the parameter leaves that require grad, so the caller's tensors
are never marked or changed; every returned tensor is new and detached.
A bfloat16 parameter gets a bfloat16 gradient, as ``jax.value_and_grad``
gives.

The plain step accumulates microbatch gradients in float32 zeros and
divides once (the reference scans over the microbatches).  The wavelet
step runs SPMD where the reference runs ``shard_map`` manual over
``pod``: every rank of ``mesh``'s ``pod`` axis is one pod, holds its own
replica and calls the step in step with the others; the inter-pod
gradient all-reduce goes through ``grad_compress.pod_sync_tree``'s
integer-DWT band codec.  The ``data`` and ``model`` axes are one rank
within a pod here (the reference leaves them to XLA's partitioner).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist
from torch import Tensor

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.compression import divide_f32
from repro_torch.models import transformer as TF
from repro_torch.train import grad_compress as G
from repro_torch.train import optim

PyTree = Any


def _split_microbatches(batch: PyTree, n_micro: int) -> PyTree:
    """(B, ...) -> (n_micro, B/n_micro, ...) views."""

    def split(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    return T.map_leaves(split, batch)


def _grads_of(cfg: ArchConfig, ce_chunk: int) -> Callable:
    """``compute(params, batch) -> (loss, metrics, grads)``, all detached."""

    def compute(params, batch):
        live = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        with torch.enable_grad():
            loss, metrics = TF.loss_fn(T.unflatten(params, live), cfg, batch,
                                       ce_chunk=ce_chunk)
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                T.unflatten(params, list(grads)))

    return compute


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: optim.AdamWConfig = optim.AdamWConfig(),
    *,
    n_microbatches: int = 1,
    ce_chunk: int = 0,
) -> Callable:
    """Plain (paper-faithful baseline) step:
    ``(params, opt_state, batch) -> (params, opt_state, metrics)``."""
    compute = _grads_of(cfg, ce_chunk)

    def train_step(params, opt_state, batch):
        if n_microbatches > 1:
            micro = _split_microbatches(batch, n_microbatches)
            loss_sum = None
            g_sum = T.map_leaves(lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                                       device=p.device), params)
            for i in range(n_microbatches):
                loss, _, grads = compute(params, T.map_leaves(lambda x: x[i], micro))
                loss_sum = loss if loss_sum is None else loss_sum + loss
                g_sum = T.unflatten(g_sum, [a + g.to(torch.float32) for a, g in zip(
                    T.leaves(g_sum), T.leaves(grads))])
            loss = divide_f32(loss_sum, n_microbatches)
            grads = T.map_leaves(lambda g: divide_f32(g, n_microbatches), g_sum)
            metrics = {}
        else:
            loss, metrics, grads = compute(params, batch)
        new_params, new_opt, opt_metrics = optim.adamw_update(grads, opt_state, params, opt_cfg)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_wavelet_train_step(
    cfg: ArchConfig,
    mesh,
    opt_cfg: optim.AdamWConfig = optim.AdamWConfig(),
    sync_cfg: G.WaveletSyncConfig = G.WaveletSyncConfig(),
    *,
    ce_chunk: int = 0,
) -> Callable:
    """Multi-pod step with integer-DWT-codec gradient sync over ``pod``:
    ``(params, opt_state, err_fb, batch) -> (params, opt, err, metrics)``.

    Every rank of ``mesh``'s ``pod`` axis calls it in step.  Its trees are
    the rank's block of the reference's pod-sharded trees: params, the
    moments and the float32 error feedback each carry a leading pod axis
    of length 1 (``podded(tree, 1)``, or rows ``[r, r + 1)`` of
    ``podded(tree, n_pods)``); ``opt_state.step`` is the shared 0-dim
    step.  ``batch`` is the global batch: rank ``r`` of ``n`` trains on
    its rows ``[r * B / n, (r + 1) * B / n)``.  The replicas stay
    identical because the synced gradients are identical on every rank.
    The loss and every metric are means over the pods."""
    from repro_torch.collectives import AxisComm

    comm = AxisComm(mesh, "pod")
    n = comm.size
    compute = _grads_of(cfg, ce_chunk)

    def rows(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} does not split over {n} pods")
        return x[comm.index * (b // n):(comm.index + 1) * (b // n)]

    def pmean(scalars: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Every 0-dim float32 scalar's mean over the pods, in one all_reduce."""
        keys = sorted(scalars)
        summed = comm.all_reduce(torch.stack([scalars[k].to(torch.float32) for k in keys]),
                                 dist.ReduceOp.SUM, op="pmean")
        return dict(zip(keys, divide_f32(summed, n).unbind(0)))

    def step(params_p, opt_p, err_p, batch):
        lead = {int(x.shape[0]) for x in T.leaves(params_p) + T.leaves(err_p)}
        if lead != {1}:
            raise ValueError(f"pod-local trees need a leading pod axis of 1, got {sorted(lead)}")
        params = unpodded(params_p)
        opt_state = optim.AdamWState(step=opt_p.step, m=unpodded(opt_p.m), v=unpodded(opt_p.v))
        loss, metrics, grads = compute(params, T.map_leaves(rows, batch))
        grads, err_fb = G.pod_sync_tree(grads, unpodded(err_p), sync_cfg, "pod", mesh=mesh)
        new_params, new_opt, opt_metrics = optim.adamw_update(grads, opt_state, params, opt_cfg)
        out_metrics = pmean({**metrics, **opt_metrics, "loss": loss})
        return (podded(new_params, 1), podded_opt(new_opt, 1), podded(err_fb, 1),
                out_metrics)

    return step


def podded(tree: PyTree, n_pods: int) -> PyTree:
    """Add a leading pod-replica axis (see make_wavelet_train_step): a
    broadcast view, no copy."""
    return T.map_leaves(lambda p: p[None].expand((n_pods,) + tuple(p.shape)), tree)


def podded_opt(opt: optim.AdamWState, n_pods: int) -> optim.AdamWState:
    return optim.AdamWState(step=opt.step, m=podded(opt.m, n_pods), v=podded(opt.v, n_pods))


def unpodded(tree: PyTree) -> PyTree:
    return T.map_leaves(lambda p: p[0], tree)


def init_podded_error_feedback(params: PyTree, n_pods: int) -> PyTree:
    """Pod-local error-feedback state with explicit leading pod axis."""
    return T.map_leaves(lambda p: torch.zeros((n_pods,) + tuple(p.shape), dtype=torch.float32,
                                              device=p.device), params)
