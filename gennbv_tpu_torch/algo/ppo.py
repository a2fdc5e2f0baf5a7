"""PPO learner: clipped surrogate + clipped value loss + entropy bonus
(port of ``gennbv_tpu/algo/ppo.py``).

The reference semantics (ppo_grid_obs.py:176-297), as the JAX learner keeps
them:
- loss = policy_loss * 10 + ent_coef * entropy_loss + vf_coef * value_loss
  (the x10 multiplier is ``policy_loss_mult``);
- per-minibatch advantage normalisation, with the population std;
- value clipping around the old values;
- target-KL early stop at 1.5x: the minibatch that breaches it is *not*
  applied (not its parameters, not its Adam state, not its BatchNorm
  running stats) and every later minibatch and epoch is skipped;
- grad-norm clip, then Adam(lr, eps=1e-5) with a constant or linear lr.

The clip and Adam are written here as functions over the parameter list
that compute what optax's ``clip_by_global_norm`` and ``adam`` compute:
the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``,
with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6); Adam's
bias correction counts from 1 and its denominator is ``sqrt(v_hat) +
eps``; the schedule reads the count of *applied* updates.

The update runs on the device from end to end, as the JAX learner's
``lax.scan`` does (``gennbv_tpu/algo/ppo.py:197-253``).  Each minibatch's
step tests its KL against 1.5 x target_kl in float32 and applies its
clipped Adam step, its BatchNorm running stats and its metrics only where
that test holds and no earlier minibatch failed it: ``where(cont & keep,
new, old)``, the count of applied updates advanced by ``cont & keep``, then
``cont &= keep``.  The learning rate and Adam's bias corrections come from
device tables indexed by that count (``ScheduleTables``), built on the host
with the float32 formulas of ``Optimizer.lr`` and ``apply_``; the metrics
are float32 sums on the device.  No minibatch reads the host, and
``ppo.apply_mode`` "select" and "cond" take the same path (both compute and
select: a CUDA graph cannot branch), so they give the same bits.

On a CUDA device the step (~400 small kernels, whose launches from Python
would set the pace) is captured once per ``Learner`` as a CUDA graph and
replayed for each minibatch.  On the CPU the step runs eagerly.  Either
way it is the same PyTorch code, and every minibatch runs: where JAX's
``lax.cond(cont, ...)`` skips the work after a KL stop, the port computes
each later minibatch and discards it by the selects (a stop is rare and
late on the flagship, and no path reads the flag on the host).

Under a mesh (``parallel/mesh.py``) each rank holds a slice of the envs
and takes its share of every minibatch, and every statistic of the whole
minibatch is a sum over the env axis divided by the global count: the
loss means, advantage normalisation, approx KL, clip fraction, the
gradient norm (after the gradients are summed, in one flat bucket a
minibatch) and the explained variance; BatchNorm sums its statistics
itself (``models/encoder.py``).  Every rank reads the same summed KL, so
all gate the same minibatch.  Where
the rank count divides the minibatch shards, a rank's share is its own
rollout rows and no rollout row crosses ranks; otherwise the rollout is
all-gathered once an update.  The CUDA graph is captured with nccl (its
collectives, the gradient bucket's too, are captured with the step);
ranks over gloo, which cannot be captured, and tensor-parallel ranks run
the step eagerly.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.modules.batchnorm import _BatchNorm

from gennbv_tpu_torch.config import PPOConfig
from gennbv_tpu_torch.models import distributions
from gennbv_tpu_torch.ops import fp32
from gennbv_tpu_torch.parallel import mesh as mesh_lib
from gennbv_tpu_torch.utils import profiling


# float32 bias corrections past their first 1.0 checked to stay there
SETTLED_STEPS = 1000


class AdamState(NamedTuple):
    """Adam's moments, keyed by parameter name as ``named_parameters``
    gives them, and the count of applied updates (optax's
    ``ScaleByAdamState``; its schedule count is the same number): a host
    int, or as ``update`` returns it a 0-d int64 tensor on the device."""
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int | torch.Tensor


@dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps))``."""
    learning_rate: float
    # length of the linear anneal in applied updates; None: constant lr
    total_updates: Optional[int]
    max_grad_norm: float
    eps: float
    b1: float = 0.9
    b2: float = 0.999

    def lr(self, count: int) -> float:
        """The learning rate after `count` applied updates, in float32 as
        optax's ``linear_schedule`` computes it."""
        lr = np.float32(self.learning_rate)
        if self.total_updates is None:
            return float(lr)
        total = np.float32(self.total_updates)
        frac = np.float32(1) - np.float32(min(max(count, 0), self.total_updates)) / total
        return float(lr * frac)

    def init(self, policy: torch.nn.Module) -> AdamState:
        def zeros():
            return {n: torch.zeros_like(p) for n, p in policy.named_parameters()}
        return AdamState(zeros(), zeros(), 0)

    def bias_corrections(self, step: int) -> tuple[np.float32, np.float32]:
        """``1 - b1^step`` and ``1 - b2^step`` in float32, as optax's Adam
        computes them."""
        return (np.float32(1) - np.float32(self.b1) ** np.float32(step),
                np.float32(1) - np.float32(self.b2) ** np.float32(step))

    @torch.no_grad()
    def apply_(self, params: list, grads: list, mu: list, nu: list,
               count: int, grad_norm: float | torch.Tensor | None) -> int:
        """One clipped Adam step, in place on params, grads, mu and nu;
        `grad_norm` is the global norm of `grads` (``global_norm``): a
        host float, or a device scalar, which clips by a select on the
        device and never waits for it; None steps without the clip (a
        plain ``optax.adam``).  Returns the new count."""
        if isinstance(grad_norm, torch.Tensor):
            keep = grad_norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / grad_norm * self.max_grad_norm))
        elif grad_norm is not None and not (
                np.float32(grad_norm) < np.float32(self.max_grad_norm)):
            torch._foreach_div_(grads, float(grad_norm))
            torch._foreach_mul_(grads, self.max_grad_norm)
        bc1, bc2 = self.bias_corrections(count + 1)
        self._adam_(params, grads, mu, nu, float(bc1), float(bc2),
                    -self.lr(count))
        return count + 1

    @torch.no_grad()
    def gated_apply_(self, params: list, grads: list, mu: list, nu: list,
                     count: torch.Tensor, grad_norm: torch.Tensor,
                     tables: "ScheduleTables",
                     go: Optional[torch.Tensor] = None) -> None:
        """``apply_`` without the host: `count` is a 0-d int64 device
        tensor, advanced in place; the learning rate and bias corrections
        are read from `tables` at it; the clip divides by the norm and
        multiplies by the bound, or by 1 and 1, which leave a gradient's
        bits as they are.  With `go` (a 0-d bool) the new parameters and
        moments replace the old, and the count advances, only where it is
        true.  Where they are applied they are ``apply_``'s bits, on
        either device (``_divided``)."""
        keep = grad_norm < self.max_grad_norm
        grads = _divided(grads, torch.where(keep, 1.0, grad_norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.max_grad_norm))
        lr, bc1, bc2 = tables.at(count)
        self._adam_(params, grads, mu, nu, bc1, bc2, lr.neg(), go)
        count.add_(1 if go is None else go)

    def _adam_(self, params: list, grads: list, mu: list, nu: list, bc1, bc2,
               neg_lr, go: Optional[torch.Tensor] = None) -> None:
        """Adam's moments and step from the clipped `grads`, given the bias
        corrections and the negated learning rate (floats, or 0-d device
        tensors); written into params, mu and nu where `go` holds (always
        without it)."""
        new_mu = torch._foreach_mul(mu, self.b1)
        torch._foreach_add_(new_mu, torch._foreach_mul(grads, 1 - self.b1))
        new_nu = torch._foreach_mul(nu, self.b2)
        torch._foreach_add_(new_nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - self.b2))
        upd = _divided(new_mu, bc1)
        den = _divided(new_nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, neg_lr)
        new_params = torch._foreach_add(params, upd)
        for old, new in ((params, new_params), (mu, new_mu), (nu, new_nu)):
            if go is None:
                torch._foreach_copy_(old, new)
            else:
                for o, n in zip(old, new):
                    torch.where(go, n, o, out=o)


def _divided(tensors: list, s: float | torch.Tensor) -> list:
    """`tensors` / `s`, a host float or a 0-d tensor, rounded as PyTorch
    divides by a host float: on a card that is a product with the
    float32 reciprocal of s (``div_true_kernel_cuda``; the foreach
    division by a float alike), on the CPU a true quotient.  So the
    device-side step keeps the bits of the host-side one."""
    if isinstance(s, torch.Tensor) and s.is_cuda:
        return torch._foreach_mul(tensors, torch.reciprocal(s))
    return torch._foreach_div(tensors, s)


class ScheduleTables(NamedTuple):
    """The learning rate and Adam's bias corrections of every count of
    applied updates, on the device: entry c of `lr` is ``Optimizer.lr(c)``
    and row c of `bias` the corrections of step c + 1
    (``Optimizer.bias_corrections``).  Each table ends where its values
    stop changing (the linear anneal's end; the corrections' float32 1.0),
    and a later count reads its last entry.  Built on the host with the
    optimizer's own float32 formulas: ``torch.pow`` on a card may round
    the powers an ulp away from numpy's."""
    lr: torch.Tensor      # [L] float32
    bias: torch.Tensor    # [B, 2] float32

    def at(self, count: torch.Tensor):
        """(lr, 1 - b1^(count+1), 1 - b2^(count+1)) as 0-d tensors, for a
        0-d int64 `count`, read on the device."""
        c = count.reshape(1)
        lr = self.lr.index_select(0, c.clamp(max=self.lr.shape[0] - 1))
        bias = self.bias.index_select(0, c.clamp(max=self.bias.shape[0] - 1))
        return lr[0], bias[0, 0], bias[0, 1]


@functools.lru_cache(maxsize=16)
def _schedule_arrays(opt: Optimizer) -> tuple[np.ndarray, np.ndarray]:
    """``ScheduleTables``' entries, in numpy."""
    if opt.total_updates is None:
        lr = np.array([opt.lr(0)], np.float32)
    else:
        # Optimizer.lr's float32 operations over the whole anneal: each is
        # correctly rounded elementwise, as on a scalar
        counts = np.arange(opt.total_updates + 1).astype(np.float32)
        lr = np.float32(opt.learning_rate) * (
            np.float32(1) - counts / np.float32(opt.total_updates))
    rows = [opt.bias_corrections(1)]
    while rows[-1] != (1, 1):
        if len(rows) > 10 ** 6:
            raise ValueError(f"Adam's bias corrections of b1={opt.b1}, "
                             f"b2={opt.b2} do not reach 1.0 in float32")
        rows.append(opt.bias_corrections(len(rows) + 1))
    settled = range(len(rows) + 1, len(rows) + 1 + SETTLED_STEPS)
    if any(opt.bias_corrections(s) != (1, 1) for s in settled):
        raise ValueError("Adam's float32 bias corrections leave 1.0 again")
    return lr, np.array(rows, np.float32)


def schedule_tables(opt: Optimizer, device) -> ScheduleTables:
    lr, bias = _schedule_arrays(opt)
    return ScheduleTables(torch.from_numpy(lr).to(device),
                          torch.from_numpy(bias).to(device))


def make_optimizer(cfg: PPOConfig, num_envs: int = 256) -> Optimizer:
    """Adam behind grad-norm clipping, with SB3-style lr schedules
    (stable_baselines3/common/utils.py get_schedule_fn): "constant" or
    "linear" anneal to 0 over the run's total gradient steps."""
    if cfg.lr_schedule == "linear":
        total = cfg.n_epochs * max(cfg.total_iters, 1) * max(
            (cfg.n_steps * num_envs) // max(cfg.batch_size, 1), 1)
    elif cfg.lr_schedule == "constant":
        total = None
    else:
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; one of constant|linear")
    return Optimizer(cfg.learning_rate, total, cfg.max_grad_norm, cfg.adam_eps)


def global_norm(grads, mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element of `grads`; the shards
    of a tensor split over the mesh's model axis count together."""
    norms = torch.stack(torch._foreach_norm(mesh_lib.local(grads)))
    if mesh is not None and mesh.model_axis > 1:
        sharded = torch.tensor([mesh_lib.is_sharded(g) for g in grads],
                               device=norms.device)
        sq = norms * norms
        norms = torch.sqrt(torch.where(
            sharded, mesh.model_all_reduce_(torch.where(sharded, sq, 0.0)),
            sq))
    return torch.linalg.vector_norm(norms)


class UpdateMetrics(NamedTuple):
    """The update's means over its applied minibatches, as 0-d float32
    device tensors (``float`` of each is the JAX learner's value)."""
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy_loss: torch.Tensor
    approx_kl: torch.Tensor
    clip_fraction: torch.Tensor
    n_minibatches_done: torch.Tensor
    explained_variance: torch.Tensor


def _minibatch_shards(cfg: PPOConfig, num_envs: int) -> int:
    """Effective logical shard count S for minibatch sampling: minibatches
    are drawn balanced across S fixed env groups, with an independent
    permutation per group.  S is a config constant (never a device
    count), adapted downward to the largest divisor of both num_envs and
    batch_size."""
    s = max(1, cfg.minibatch_shards)
    while num_envs % s or cfg.batch_size % s:
        s -= 1
    return s


def minibatch_indices(cfg: PPOConfig, m: int, num_envs: Optional[int],
                      generator: torch.Generator) -> torch.Tensor:
    """[E * n_mb, S, BL] int64: one fresh permutation of each shard's ML =
    m / S transitions per (epoch, shard), cut into n_mb minibatches of BL =
    batch_size / S rows a shard.  Positions index the shard-major layout
    of ``update``; drawn on the generator's device."""
    n_mb = m // cfg.batch_size
    s = _minibatch_shards(cfg, num_envs) if num_envs else 1
    ml, bl = m // s, cfg.batch_size // s
    perms = torch.stack([
        torch.randperm(ml, generator=generator, device=generator.device)
        for _ in range(cfg.n_epochs * s)]).reshape(cfg.n_epochs, s, ml)
    return (perms.reshape(cfg.n_epochs, s, n_mb, bl).transpose(1, 2)
            .reshape(cfg.n_epochs * n_mb, s, bl))


def flat_rows(indices: torch.Tensor, m: int,
              num_envs: Optional[int]) -> torch.Tensor:
    """Minibatch positions [K, S, BL] -> rows [K, S * BL] of the flat
    [M = T * N] rollout.  Shard s holds, in shard-major order, the
    transitions of envs [s * N/S, (s+1) * N/S) over all T steps (the JAX
    learner's relayout, ``ppo.py:103-129``); mapping the positions back
    gathers the same rows without copying the rollout into that layout."""
    k, s, bl = indices.shape
    if s == 1:
        return indices.reshape(k, bl)
    nl = num_envs // s
    shard = torch.arange(s, device=indices.device)[None, :, None]
    rows = (indices // nl) * num_envs + shard * nl + indices % nl
    return rows.reshape(k, s * bl)


def _loss(policy, cfg: PPOConfig, obs, actions, old_log_probs, old_values,
          advantages, returns, mesh: Optional[mesh_lib.Mesh] = None):
    """The loss of one minibatch and its detached (policy, value, entropy
    loss, approx KL, clip fraction).  Under a mesh the rows are this
    rank's share of the minibatch, and so are the loss and the five
    values: summed over the env axis they are the whole minibatch's."""
    out = policy(obs.float())
    logp = distributions.log_prob(out.logits, actions)
    ent = distributions.entropy(out.logits)
    values = out.value

    def mean(x):
        return x.mean() if mesh is None else x.sum() / cfg.batch_size

    adv = advantages
    if cfg.normalize_advantage:
        if mesh is None:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        else:
            mu = mesh.all_reduce_(adv.sum()) / cfg.batch_size
            var = mesh.all_reduce_(((adv - mu) ** 2).sum()) / cfg.batch_size
            adv = (adv - mu) / (torch.sqrt(var) + 1e-8)

    log_ratio = logp - old_log_probs
    ratio = torch.exp(log_ratio)
    pg1 = adv * ratio
    pg2 = adv * torch.clamp(ratio, 1.0 - cfg.clip_range, 1.0 + cfg.clip_range)
    policy_loss = -mean(torch.minimum(pg1, pg2))

    if cfg.clip_range_vf is None:
        values_pred = values
    else:
        values_pred = old_values + torch.clamp(
            values - old_values, -cfg.clip_range_vf, cfg.clip_range_vf)
    value_loss = mean((returns - values_pred) ** 2)

    entropy_loss = -mean(ent)
    loss = (policy_loss * cfg.policy_loss_mult + cfg.ent_coef * entropy_loss
            + cfg.vf_coef * value_loss)
    if cfg.ent_floor is not None:
        # hinge bonus once the batch-mean entropy drops below the floor;
        # under a mesh each rank adds 1/W of it, whose gradient the
        # all-reduce's backward sums over the W ranks
        if mesh is None:
            loss = loss + cfg.ent_floor_coef * torch.relu(
                cfg.ent_floor - ent.mean())
        else:
            ent_mean = mesh.all_reduce_grad(ent.sum()) / cfg.batch_size
            loss = loss + cfg.ent_floor_coef * torch.relu(
                cfg.ent_floor - ent_mean) / mesh.env_width
    with torch.no_grad():
        approx_kl = mean(torch.expm1(log_ratio) - log_ratio)
        clip_frac = mean((torch.abs(ratio - 1.0) > cfg.clip_range).float())
    return loss, (policy_loss.detach(), value_loss.detach(),
                  entropy_loss.detach(), approx_kl, clip_frac)


def _minibatch_step(policy, cfg: PPOConfig, params: list, data: tuple,
                    rows: torch.Tensor, mesh: Optional[mesh_lib.Mesh] = None):
    """The gradients of the loss of the minibatch at `rows` of the flat
    rollout `data`, and one [6] tensor of its (policy, value, entropy
    loss, approx KL, clip fraction, gradient norm).  Under a mesh: this
    rank's shares of the gradients and of the five (``reduce_step`` sums
    them and adds the norm)."""
    loss, metrics = _loss(policy, cfg, *(x[rows] for x in data), mesh)
    grads = list(torch.autograd.grad(loss, params))
    if mesh is not None:
        return grads, torch.stack(metrics)
    return grads, torch.stack([*metrics, global_norm(grads)])


def reduce_step(grads: list, out: torch.Tensor, mesh: mesh_lib.Mesh):
    """Sums a rank's gradient and metric shares (``_minibatch_step``) over
    the env axis in one flat bucket, writing the sums into `grads`;
    returns them and the [6] metrics with the gradient norm."""
    parts = mesh_lib.local(grads)
    bucket = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in parts] + [out]))
    sizes = [g.numel() for g in parts]
    flat = bucket[:-out.numel()].split(sizes)
    torch._foreach_copy_(parts, [f.view_as(g) for f, g in zip(flat, parts)])
    return grads, torch.cat([bucket[-out.numel():],
                             global_norm(grads, mesh)[None]])


class Learner:
    """What ``update`` keeps from one call to the next for one policy,
    optimizer, config and mesh: the schedule tables, the device scalars of
    the gated step (the count of applied updates, the stop flag ``cont``,
    the metric sums), BatchNorm's running stats saved before each
    minibatch, and on a card the step captured as a CUDA graph at the
    first call.

    The graph reads the rollout, the parameters, the moments and the
    BatchNorm stats at the addresses of that first call, so every later
    call must pass the same tensors (the Runner keeps its rollout in
    buffers for this: ``rollout.collect(out=...)``); a call with another
    raises.  A rollout all-gathered over the mesh is the learner's own
    and is copied into the first one's place."""

    def __init__(self, policy: torch.nn.Module, opt: Optimizer,
                 cfg: PPOConfig, mesh: Optional[mesh_lib.Mesh] = None):
        self.policy, self.opt, self.cfg, self.mesh = policy, opt, cfg, mesh
        self.names, params = zip(*policy.named_parameters())
        self.params = list(params)
        self.local_params = mesh_lib.local(self.params)
        self.stats = [b for mod in policy.modules() if isinstance(mod, _BatchNorm)
                      for b in (mod.running_mean, mod.running_var)]
        device = self.local_params[0].device
        self.tables = schedule_tables(opt, device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.cont = torch.ones((), dtype=torch.bool, device=device)
        # float32 sums of (policy, value, entropy loss, KL, clip fraction, 1)
        self.sums = torch.zeros(6, device=device)
        self.one = torch.ones(1, device=device)
        self.threshold = (None if cfg.target_kl is None
                          else fp32.const(1.5 * cfg.target_kl, device))
        self.saved = ([torch.empty_like(b) for b in self.stats]
                      if self.threshold is not None else [])
        self.captures = device.type == "cuda" and (mesh is None or (
            dist.get_backend() == "nccl" and mesh.model_axis == 1))
        self.graph = None

    def matches(self, policy, opt, cfg, mesh) -> bool:
        return (policy is self.policy and opt == self.opt and cfg == self.cfg
                and mesh is self.mesh)

    def begin(self, count: int | torch.Tensor) -> None:
        """Sets the count, raises the stop flag's ``cont`` and zeroes the
        sums: the carry of a new update."""
        if isinstance(count, torch.Tensor):
            self.count.copy_(count)
        else:
            self.count.fill_(count)
        self.cont.fill_(True)
        self.sums.zero_()

    def step(self, data: tuple, rows: torch.Tensor, mu: list, nu: list):
        """One minibatch, ``mb_step``'s ``lax.cond(cont, live, skipped)``
        with the KL's ``keep`` as selects: its gradients and metrics, then
        the clipped Adam step, its BatchNorm stats and its metrics kept
        where ``cont & keep``."""
        gate = self.threshold is not None
        if gate and self.saved:
            torch._foreach_copy_(self.saved, self.stats)
        grads, out = _minibatch_step(self.policy, self.cfg, self.params, data,
                                     rows, self.mesh)
        if self.mesh is not None:
            grads, out = reduce_step(grads, out, self.mesh)
        metrics = torch.cat([out[:5], self.one])
        go = None
        if gate:
            go = self.cont & (out[3] <= self.threshold)
            self.cont.copy_(go)
            metrics = torch.where(go, metrics, 0.0)
            for b, s in zip(self.stats, self.saved):
                torch.where(go, b, s, out=b)
        self.sums.add_(metrics)
        self.opt.gated_apply_(self.local_params, mesh_lib.local(grads), mu, nu,
                              self.count, out[5], self.tables, go)

    def run(self, data: tuple, rows: torch.Tensor, mu: list, nu: list,
            gathered: bool = False) -> None:
        """Every minibatch of `rows` ([K, B]): eagerly, or as replays of
        the captured step, counted in ``update/replays``."""
        profiling.count("update/replays", len(rows))
        if not self.captures:
            for r in rows:
                self.step(data, r, mu, nu)
            return
        if self.graph is None:
            self._capture(data, rows[0], mu, nu)
        else:
            self._bind(data, mu, nu, gathered)
        for r in rows:
            self.rows.copy_(r)
            self.graph.replay()

    def _inputs(self, data: tuple, mu: list, nu: list) -> list:
        return [*data, *self.local_params, *mu, *nu, *self.stats]

    @staticmethod
    def _places(tensors: list) -> list:
        return [(t.data_ptr(), t.shape, t.stride(), t.dtype) for t in tensors]

    def _capture(self, data: tuple, rows: torch.Tensor, mu: list, nu: list):
        """Captures ``step`` after two warm-up minibatch steps on a side
        stream (cuDNN, cuBLAS, autograd and nccl set themselves up outside
        the capture), whose BatchNorm updates are undone."""
        self.data, self.rows = data, rows.clone()
        saved = [b.clone() for b in self.stats]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                grads, out = _minibatch_step(self.policy, self.cfg,
                                             self.params, data, self.rows,
                                             self.mesh)
                if self.mesh is not None:
                    reduce_step(grads, out, self.mesh)
        torch.cuda.current_stream().wait_stream(side)
        if self.stats:
            torch._foreach_copy_(self.stats, saved)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.step(data, self.rows, mu, nu)
        self.places = self._places(self._inputs(data, mu, nu))

    def _bind(self, data: tuple, mu: list, nu: list, gathered: bool) -> None:
        if gathered:
            torch._foreach_copy_(list(self.data), list(data))
            data = self.data
        if self._places(self._inputs(data, mu, nu)) != self.places:
            raise RuntimeError(
                "ppo.update: the captured step reads the rollout, parameters, "
                "Adam moments and BatchNorm stats of its first call, and "
                "this call passes a tensor at another address; keep them in "
                "place (Runner: rollout.collect(out=...)) or use a new "
                "Learner")


def update(
    policy: torch.nn.Module,
    opt: Optimizer,
    cfg: PPOConfig,
    state: AdamState,
    obs: torch.Tensor,            # [M, D] flattened rollout (t-major)
    actions: torch.Tensor,        # [M, 6]
    old_log_probs: torch.Tensor,  # [M]
    old_values: torch.Tensor,     # [M]
    advantages: torch.Tensor,     # [M]
    returns: torch.Tensor,        # [M]
    generator: Optional[torch.Generator] = None,
    num_envs: Optional[int] = None,
    indices: Optional[torch.Tensor] = None,
    mesh: Optional[mesh_lib.Mesh] = None,
    learner: Optional[Learner] = None,
) -> tuple[AdamState, UpdateMetrics]:
    """n_epochs passes of minibatched PPO over one rollout, enqueued on the
    device without reading the host.  Changes the policy's parameters and
    BatchNorm running stats and the moments of `state` in place, and
    returns the state with its new count (a 0-d int64 device tensor) and
    the metrics as device scalars.  `indices` ([E * n_mb, S, BL],
    ``minibatch_indices``) fixes the minibatches; without it they are
    drawn from `generator`.  Under `mesh` the rollout is this rank's envs'
    ([T * N / W] rows, t-major; `num_envs` is the global N) and the
    metrics are the whole update's.  `learner` carries the captured step
    and the tables from call to call (``Learner``); without one the call
    makes its own."""
    width = 1 if mesh is None else mesh.env_width
    m = obs.shape[0] * width
    n_mb = m // cfg.batch_size
    if n_mb * cfg.batch_size != m:
        raise ValueError(f"batch_size {cfg.batch_size} must divide the "
                         f"{m} rollout transitions")
    if cfg.batch_size % width:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by "
                         f"the env axis ({width} ranks)")
    if cfg.apply_mode not in ("select", "cond"):
        raise ValueError(f"ppo.apply_mode={cfg.apply_mode!r}: "
                         "expected 'select' or 'cond'")
    fp32.deterministic_fp32()
    if learner is None:
        learner = Learner(policy, opt, cfg, mesh)
    elif not learner.matches(policy, opt, cfg, mesh):
        raise ValueError("ppo.update: the Learner was made for another "
                         "policy, optimizer, config or mesh")
    if indices is None:
        indices = minibatch_indices(cfg, m, num_envs, generator)
    rows = flat_rows(indices.to(obs.device), m, num_envs)
    data = (obs, actions, old_log_probs, old_values, advantages, returns)
    gathered = False
    if mesh is not None:
        rollout_data = data
        data, rows = _rank_share(data, rows, mesh, num_envs, indices.shape[1])
        gathered = data is not rollout_data
    mu = mesh_lib.local([state.mu[n] for n in learner.names])
    nu = mesh_lib.local([state.nu[n] for n in learner.names])

    learner.begin(state.count)
    was_training = policy.training
    policy.train()
    try:
        learner.run(data, rows, mu, nu, gathered)
    finally:
        policy.train(was_training)

    sums = learner.sums
    means = sums[:5] / torch.clamp(sums[5], min=1.0)
    metrics = UpdateMetrics(
        *means.unbind(), n_minibatches_done=sums[5].clone(),
        explained_variance=_explained_variance(returns, old_values, mesh))
    return AdamState(state.mu, state.nu, learner.count.clone()), metrics


def _rank_share(data: tuple, rows: torch.Tensor, mesh: mesh_lib.Mesh,
                num_envs: int, shards: int):
    """This rank's share of every minibatch: columns [i * B / W, (i + 1) *
    B / W) of `rows` ([K, B] rows of the global flat rollout), the rows of
    its S / W minibatch shards.  Where W divides S those rows are this
    rank's own envs and are mapped into its local rollout; otherwise the
    rollout is all-gathered (once) and the global rows index it."""
    width, i = mesh.env_width, mesh.env_index
    b = rows.shape[1] // width
    share = rows[:, i * b:(i + 1) * b]
    nl = num_envs // width
    if shards % width == 0:
        env = share % num_envs
        return data, (share // num_envs) * nl + env - i * nl
    gathered = tuple(
        mesh.all_gather(x.reshape(-1, nl, *x.shape[1:]), 1)
        .reshape(-1, *x.shape[1:]) for x in data)
    return gathered, share


@torch.no_grad()
def _explained_variance(returns: torch.Tensor, values: torch.Tensor,
                        mesh: Optional[mesh_lib.Mesh]) -> torch.Tensor:
    """1 - Var(returns - values) / Var(returns) over the whole rollout
    (0 where Var(returns) is 0)."""
    if mesh is None:
        var_ret = returns.var(correction=0)
        var_res = (returns - values).var(correction=0)
    else:
        m = returns.numel() * mesh.env_width
        res = returns - values
        mean = mesh.all_reduce_(torch.stack([returns.sum(), res.sum()])) / m
        var_ret, var_res = mesh.all_reduce_(torch.stack([
            ((returns - mean[0]) ** 2).sum(),
            ((res - mean[1]) ** 2).sum()])) / m
    return torch.where(var_ret > 0, 1.0 - var_res / var_ret,
                       torch.zeros_like(var_ret))
