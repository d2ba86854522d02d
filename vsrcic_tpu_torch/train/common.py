"""Shared training machinery: the Adam optimizer, schedules, train state.

Counterpart of `vsrcic_tpu/train/common.py`. Parameters, gradients and the
optimizer's moments are nested dicts of tensors (`core/nn.py`). Adam is
written out here rather than taken from `torch.optim.Adam`, so that its
arithmetic is optax's, term for term: the moments as
``(1 - b) * g**k + b * m``, the bias corrections as f32 ``1 - b**count``,
and the step ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with eps outside the
root (`torch.optim.Adam` divides by ``sqrt(nu) / sqrt(bc2) + eps``
instead). The learning rate can change between steps
(`set_learning_rate`).

Under a data-parallel mesh (`parallel.mesh.DataMesh`) each rank takes the
gradient of its block's share of the global loss, and `apply_grads` sums
the ranks' gradients (one all-reduce over a flat buffer) before Adam, and
so before Adam's clamp: JAX clips the summed gradient. Every rank then
runs the same Adam on the same bits.

`value_and_grad` runs inside the recorder's spans `train.forward` and
`train.backward`, `apply_grads` inside `train.adam`
(`utils/observability.py`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from vsrcic_tpu_torch.parallel.mesh import all_reduce_sum, all_reduce_tree
from vsrcic_tpu_torch.utils import observability as obs
from vsrcic_tpu_torch.utils.params import flatten, unflatten


def rank_generator(gen: torch.Generator, mesh) -> torch.Generator:
    """gen, or under a mesh a generator of this rank's own, seeded from
    gen's seed and the rank (seed * size + rank: distinct for every seed
    and rank of a world), on gen's device. JAX folds the shard index into
    its key for the same purpose."""
    if mesh is None or gen is None:
        return gen
    return torch.Generator(device=gen.device).manual_seed(
        gen.initial_seed() * mesh.size + mesh.rank)


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of the same structure."""
    flats = [flatten(t) for t in trees]
    return unflatten({k: fn(*(f[k] for f in flats)) for k in flats[0]})


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


class AdamState(NamedTuple):
    count: int                       # updates applied so far
    mu: Any                          # first moments, like params
    nu: Any                          # second moments, like params
    hyperparams: Dict[str, float]    # {"learning_rate": lr}, mutable


class Adam:
    """torch.optim.Adam's defaults (betas (0.9, 0.999), eps 1e-8) in optax's
    arithmetic, with an optional elementwise gradient clamp to
    [-grad_clip, grad_clip] before the moments (optax.clip)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.grad_clip = grad_clip

    def init(self, params) -> AdamState:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params),
                         {"learning_rate": self.lr})

    @torch.no_grad()
    def update(self, grads, state: AdamState):
        """(updates to add to the params, next state)."""
        # optax holds the hyperparameters as f32 arrays and forms 1 - b in
        # f32 (1 - f32(0.9) is not f32(0.1)); every scalar here is such an
        # f32 value, exact as a Python float
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        b1, b2, eps = f32(self.b1), f32(self.b2), f32(self.eps)
        c1, c2 = f32(np.float32(1) - np.float32(b1)), f32(
            np.float32(1) - np.float32(b2))
        if self.grad_clip is not None:
            c = self.grad_clip
            grads = tree_map(lambda g: g.clamp(-c, c), grads)
        mu = tree_map(lambda g, m: c1 * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: c2 * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        # the divisors as 0-d tensors on the moments' device: CUDA's division
        # by a Python scalar multiplies by its reciprocal, which optax does
        # not
        dev = next(iter(flatten(mu).values())).device
        bc1, bc2 = (torch.full((), f32(1 - np.float32(b) ** np.float32(count)),
                               dtype=torch.float32, device=dev)
                    for b in (b1, b2))
        neg_lr = -f32(state.hyperparams["learning_rate"])
        updates = tree_map(
            lambda m, v: neg_lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)),
            mu, nu)
        return updates, AdamState(count, mu, nu, state.hyperparams)


def adam(lr: float = 5e-4, grad_clip: Optional[float] = None) -> Adam:
    return Adam(lr, grad_clip=grad_clip)


def set_learning_rate(opt_state: AdamState, lr: float) -> AdamState:
    """Mirror of the reference's set_lr (utils/tools.py:4)."""
    opt_state.hyperparams["learning_rate"] = lr
    return opt_state


def step_lr(base_lr: float, epoch: int, step_size: int = 3,
            gamma: float = 0.8) -> float:
    """torch StepLR schedule (ref train.py:78)."""
    return base_lr * (gamma ** (epoch // step_size))


def planner_lr(base_lr: float, epoch: int, decay_every: int = 3,
               decay_rate: float = 0.6) -> float:
    """The SSP scripts' manual decay (ref train_region_sort.py:117-120)."""
    if epoch >= 3:
        return base_lr * (decay_rate ** int((epoch - 3) // decay_every + 1))
    return base_lr


def init_train_state(params, tx: Adam) -> TrainState:
    return TrainState(params, tx.init(params), 0)


@torch.no_grad()
def apply_grads(tx: Adam, state: TrainState, grads, mesh=None) -> TrainState:
    """One Adam update; under a mesh the gradients are first summed over
    the ranks."""
    with obs.span("train.adam"):
        if mesh is not None:
            grads = all_reduce_tree(grads, mesh)
        updates, opt_state = tx.update(grads, state.opt_state)
        params = tree_map(lambda p, u: p + u, state.params, updates)
        return TrainState(params, opt_state, state.step + 1)


def value_and_grad(loss_fn, params, *args, has_aux: bool = False, **kw):
    """(loss_fn(params, ...), d loss / d params) with the gradients as a
    dict like params; with has_aux, loss_fn returns (loss, aux) and so does
    this, as jax.value_and_grad."""
    with obs.span("train.forward"):
        leaves = flatten(tree_map(
            lambda p: p.detach().requires_grad_(True), params))
        out = loss_fn(unflatten(leaves), *args, **kw)
        loss = out[0] if has_aux else out
    # the engine runs the backward of CUDA tensors on a thread of its own
    with obs.span("train.backward", shared=True):
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = unflatten({k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)})
    if has_aux:
        return (loss.detach(), tuple(a.detach() for a in out[1])), grads
    return loss.detach(), grads


def nll_loss(log_probs, targets, ignore_index: Optional[int] = None,
             mesh=None):
    """Mean NLL over (optionally masked) targets — torch NLLLoss parity.

    log_probs: (..., C) log-probabilities; targets: (...) int. Under a
    mesh: this rank's share of the mean over every rank's targets (the
    ranks' shares sum to it); each rank holds the same number of them."""
    flat_lp = log_probs.reshape(-1, log_probs.shape[-1])
    flat_t = targets.reshape(-1).long()
    picked = torch.gather(
        flat_lp, 1, flat_t.clamp(0, flat_lp.shape[-1] - 1)[:, None])[:, 0]
    if ignore_index is None:
        if mesh is None:
            return -picked.mean()
        return -picked.sum() / (picked.numel() * mesh.size)
    mask = (flat_t != ignore_index).to(log_probs.dtype)
    count = mask.sum()
    if mesh is not None:
        count = all_reduce_sum(count, mesh)
    return -(picked * mask).sum() / count.clamp_min(1.0)
