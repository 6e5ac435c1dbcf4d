"""Actor-critic trained on imagined rollouts (GAE advantage, target critic).

Counterpart of ``pydreamer_tpu/models/a2c.py``: ``gae_advantage`` (40-76),
the critic half with ``reality_weight`` and the frozen ``critic_target``
(``_critic_losses``, 136-171), ``critic_training_step`` (173-186),
``forward_actor`` with its four heads (188-198) and the reinforce and
dynamics actor losses (203-256). :class:`Critic` holds the critic and its
frozen target (the auxiliary critic of the world model has no actor, as
``init_critic``, 124-134); :class:`ActorCritic` adds the actor. The caller
owns the optimizer and the periodic target copy (``training/train_step.py``).

The critic target's parameters never take a gradient (``requires_grad`` is
off), but the features it reads may: under ``actor_grad: dynamics`` the
value target carries the gradient back through the imagined states into the
actor, the world model being frozen by the caller. The critic regression
sees detached features unless ``critic_features_grad`` (the auxiliary critic,
whose loss shapes the world model's features).

With ``dreamerv3`` (Hafner et al. 2023, arXiv:2301.04104; no JAX
counterpart) the same classes take DreamerV3's objective: the critic and its
slow copy (``critic_target``) are two-hot symlog heads over ``twohot_bins``
bins; the targets are lambda-returns bootstrapped from the online critic;
the advantage is scaled by the return range that ``ReturnNormalizer`` keeps
on the device from step to step; the weights are the discounted products of
the continue flags; the critic's loss adds the log-probability of the slow
critic's mean; the actor mixes 1% uniform into its probabilities
(``unimix``). The caller updates the slow critic by ``SlowCriticEMA`` after
each optimizer step.

Sequence convention:
    features[0] -> actions[0] -> rewards[1], terminals[1], features[1] -> ...
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..tracing import span
from .distributions import (OneHotCategorical, TwoHotSymlog, normal_tanh, tanh_normal,
                            trunc_normal)
from .functions import batch_var
from .modules import MLP

__all__ = ["ActorCritic", "Critic", "gae_advantage", "lambda_return", "ReturnNormalizer",
           "SlowCriticEMA", "percentile", "ACTOR_DISTS"]

GAE_IMPLS = ("scan", "unrolled")
ACTOR_DISTS = {"onehot": OneHotCategorical, "normal_tanh": normal_tanh,
               "tanh_normal": tanh_normal, "trunc_normal": trunc_normal}
ACTOR_GRADS = ("reinforce", "dynamics")


def gae_advantage(advantage: torch.Tensor, terminal1: torch.Tensor,
                  gamma: float, lambda_: float) -> torch.Tensor:
    """Generalized advantage estimation, one reverse loop over H.

    advantage_gae[t] = adv[t] + (gamma*lambda)*(1-terminal1[t])*advantage_gae[t+1]

    Both JAX ``gae_impl`` values (scan / unrolled) are this same loop.
    """
    agae_next = torch.zeros_like(advantage[-1])
    out = [None] * advantage.shape[0]
    for t in range(advantage.shape[0] - 1, -1, -1):
        agae_next = advantage[t] + lambda_ * gamma * (1.0 - terminal1[t]) * agae_next
        out[t] = agae_next
    return torch.stack(out)


def lambda_return(reward1: torch.Tensor, value: torch.Tensor, cont1: torch.Tensor,
                  gamma: float, lambda_: float) -> torch.Tensor:
    """DreamerV3's lambda-returns, one reverse loop over H: R_H = v_H and
    R_t = r_{t+1} + gamma c_{t+1} ((1 - lambda) v_{t+1} + lambda R_{t+1}).
    reward1, cont1: (H, M); value: (H+1, M) -> (H, M)."""
    disc = gamma * cont1
    interm = reward1 + disc * value[1:] * (1.0 - lambda_)
    nxt = value[-1]
    out = [None] * reward1.shape[0]
    for t in range(reward1.shape[0] - 1, -1, -1):
        nxt = interm[t] + disc[t] * lambda_ * nxt
        out[t] = nxt
    return torch.stack(out)


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of all of ``x`` (0 <= q <= 1), interpolated
    linearly between the order statistics (numpy's default), by a sort and
    two fixed indices: no value goes to the host, so a CUDA graph holds it."""
    flat = x.reshape(-1).sort().values
    pos = q * (flat.shape[0] - 1)
    lo = int(pos)
    hi = min(lo + 1, flat.shape[0] - 1)
    return flat[lo] + (pos - lo) * (flat[hi] - flat[lo])


class ReturnNormalizer(nn.Module):
    """DreamerV3's return scale: EMAs (``DECAY``) of the 5th and 95th
    percentiles of the returns, kept on the device in the buffer ``stats`` =
    (low, high), which starts at 0 and is updated in place (a replayed CUDA
    graph updates it too) -> max(1, high - low), the divisor of the advantage."""

    DECAY, LOW, HIGH = 0.99, 0.05, 0.95

    def __init__(self):
        super().__init__()
        self.register_buffer("stats", torch.zeros(2))

    @torch.no_grad()
    def update(self, ret: torch.Tensor) -> None:
        ret = ret.float()
        now = torch.stack([percentile(ret, self.LOW), percentile(ret, self.HIGH)])
        self.stats.mul_(self.DECAY).add_((1.0 - self.DECAY) * now)

    def scale(self) -> torch.Tensor:
        return torch.clamp(self.stats[1] - self.stats[0], min=1.0)


class SlowCriticEMA:
    """DreamerV3's slow critic: after each update, target <- (1 - FRACTION)
    target + FRACTION critic, in place, over all the parameters at once."""

    FRACTION = 0.02

    @torch.no_grad()
    def __call__(self, critic: nn.Module, target: nn.Module) -> None:
        dst, src = list(target.parameters()), list(critic.parameters())
        torch._foreach_mul_(dst, 1.0 - self.FRACTION)
        torch._foreach_add_(dst, src, alpha=self.FRACTION)


class Critic(nn.Module):
    """Critic and frozen critic target (4-layer 400-wide MLPs). With
    ``twohot_bins`` both are DreamerV3's two-hot symlog heads, and the value
    is the head's mean. ``act`` and ``hidden_bias``: as ``MLP``'s."""

    def __init__(self, in_dim: int, hidden_dim: int = 400, hidden_layers: int = 4,
                 layer_norm: bool = True, gamma: float = 0.999, lambda_gae: float = 0.95,
                 critic_features_grad: bool = False, gae_impl: str = "scan",
                 dtype=torch.float32, act: str = "elu", hidden_bias: bool = True,
                 twohot_bins: int = 0):
        super().__init__()
        if gae_impl not in GAE_IMPLS:
            raise ValueError(f"unknown gae_impl {gae_impl!r}; options: {GAE_IMPLS}")
        self.gamma = gamma
        self.lambda_ = lambda_gae
        self.critic_features_grad = critic_features_grad
        self.twohot_bins = twohot_bins
        mlp = dict(act=act, hidden_bias=hidden_bias)
        out = twohot_bins or 1
        self.critic = MLP(in_dim, out, hidden_dim, hidden_layers, layer_norm, dtype, **mlp)
        self.critic_target = MLP(in_dim, out, hidden_dim, hidden_layers, layer_norm, dtype, **mlp)
        self.critic_target.load_state_dict(self.critic.state_dict())
        self.critic_target.requires_grad_(False)
        if twohot_bins:
            self.register_buffer("bins", TwoHotSymlog.make_bins(twohot_bins), persistent=False)

    @torch.no_grad()
    def update_critic_target(self) -> None:
        """Hard copy critic -> critic_target."""
        for tgt, src in zip(self.critic_target.parameters(), self.critic.parameters()):
            tgt.copy_(src)

    def forward_value(self, features: torch.Tensor) -> torch.Tensor:
        if self.twohot_bins:
            return TwoHotSymlog(self.critic(features), self.bins).mean
        return self.critic(features)

    def _critic_losses(self, features, rewards, terminals):
        """GAE targets from the frozen target net + reality-weighted MSE."""
        reward1 = rewards[1:]        # (H,M)
        terminal0 = terminals[:-1]
        terminal1 = terminals[1:]
        value_t = self.critic_target(features)
        value0t = value_t[:-1]
        value1t = value_t[1:]
        advantage = -value0t + reward1 + self.gamma * (1.0 - terminal1) * value1t
        advantage_gae = gae_advantage(advantage, terminal1, self.gamma, self.lambda_)
        value_target = advantage_gae + value0t

        # reality_weight[i] = prod_{j<=i} (1-terminal[j]) — masks imagination
        # that continued past a predicted episode end.
        reality_weight = torch.cumprod(1.0 - terminal0, 0).detach()

        value = self.critic(features if self.critic_features_grad else features.detach())
        loss_critic = 0.5 * (value_target.detach() - value[:-1]).square()
        loss_critic = (loss_critic * reality_weight).mean()
        return loss_critic, value, value_target, advantage, advantage_gae, reality_weight

    def critic_training_step(self, features, rewards, terminals):
        """Critic-only step (the auxiliary critic on real data): returns
        (loss_critic, metrics, tensors)."""
        loss_critic, value, *_ = self._critic_losses(features, rewards, terminals)
        metrics = dict(loss_critic=loss_critic.detach(),
                       policy_value_im=value[:-1].mean().detach())
        return loss_critic, metrics, dict(value=value.detach())


class ActorCritic(Critic):
    """Actor, critic and frozen critic target. ``batch_reduce``: as
    ``decoders.MultiDecoder``'s, for ``policy_reward_std``."""

    batch_reduce = None

    def __init__(self, in_dim: int, out_actions: int, hidden_dim: int = 400,
                 hidden_layers: int = 4, layer_norm: bool = True, gamma: float = 0.999,
                 lambda_gae: float = 0.95, entropy_weight: float = 1e-3,
                 actor_grad: str = "reinforce", actor_dist: str = "onehot",
                 gae_impl: str = "scan", dtype=torch.float32, act: str = "elu",
                 hidden_bias: bool = True, twohot_bins: int = 0, unimix: float = 0.0,
                 dreamerv3: bool = False):
        super().__init__(in_dim, hidden_dim, hidden_layers, layer_norm, gamma, lambda_gae,
                         gae_impl=gae_impl, dtype=dtype, act=act, hidden_bias=hidden_bias,
                         twohot_bins=twohot_bins)
        if actor_grad not in ACTOR_GRADS:
            raise ValueError(f"unknown actor_grad {actor_grad!r}; options: {ACTOR_GRADS}")
        if actor_dist not in ACTOR_DISTS:
            raise ValueError(f"unknown actor_dist {actor_dist!r}; options: {sorted(ACTOR_DISTS)}")
        if dreamerv3 and (not twohot_bins or actor_grad != "reinforce" or actor_dist != "onehot"):
            raise ValueError("the DreamerV3 objective takes a two-hot critic and the reinforce "
                             "gradient of a one-hot actor")
        self.entropy_weight = entropy_weight
        self.actor_grad = actor_grad
        self.actor_dist = actor_dist
        self.dreamerv3 = dreamerv3
        self.make_dist = (functools.partial(OneHotCategorical, unimix=unimix) if unimix
                          else ACTOR_DISTS[actor_dist])
        actor_out = out_actions if actor_dist == "onehot" else 2 * out_actions
        self.actor = MLP(in_dim, actor_out, hidden_dim, hidden_layers, layer_norm, dtype,
                         act=act, hidden_bias=hidden_bias)
        self.retnorm = ReturnNormalizer() if dreamerv3 else None
        self.slow_critic = SlowCriticEMA() if dreamerv3 else None

    def forward_actor(self, features: torch.Tensor):
        return self.make_dist(self.actor(features).float())

    def update_slow_critic(self) -> None:
        self.slow_critic(self.critic, self.critic_target)

    def training_step(self,
                      features: torch.Tensor,   # (J,M,F) J=H+1
                      actions: torch.Tensor,    # (H,M,A)
                      rewards: torch.Tensor,    # (J,M)
                      terminals: torch.Tensor,  # (J,M)
                      update_stats: bool = True,
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Dict, Dict]:
        """The losses. ``update_stats`` False leaves DreamerV3's return
        statistics as they are (the log step's rollout)."""
        if self.dreamerv3:
            return self._training_step_v3(features, actions, rewards, terminals, update_stats)
        reward1 = rewards[1:]
        (loss_critic, value, value_target, advantage, advantage_gae,
         reality_weight) = self._critic_losses(features, rewards, terminals)
        value0 = value[:-1]

        if self.actor_grad == "reinforce":
            policy_distr = self.forward_actor(features[:-1].detach())
            action_logprob = policy_distr.log_prob(actions.detach())
            loss_policy = -action_logprob * advantage_gae.detach()
        else:
            # dynamics: the entropy and value terms reach the actor through
            # the imagined states.
            policy_distr = self.forward_actor(features[:-1])
            loss_policy = -value_target
        policy_entropy = policy_distr.entropy()
        loss_actor = loss_policy - self.entropy_weight * policy_entropy
        loss_actor = (loss_actor * reality_weight).mean()

        metrics = dict(
            loss_critic=loss_critic.detach(),
            loss_actor=loss_actor.detach(),
            policy_entropy=policy_entropy.mean().detach(),
            policy_value=value0[0].mean().detach(),
            policy_value_im=value0.mean().detach(),
            policy_reward=reward1.mean().detach(),
            policy_reward_std=batch_var(reward1, reduce=self.batch_reduce).sqrt().detach(),
        )
        tensors = dict(
            value=value.detach(),
            value_target=value_target.detach(),
            value_advantage=advantage.detach(),
            value_advantage_gae=advantage_gae.detach(),
            value_weight=reality_weight,
        )
        return (loss_actor, loss_critic), metrics, tensors

    def _training_step_v3(self, features, actions, rewards, terminals, update_stats: bool):
        """DreamerV3's actor and critic losses (the module docstring); the
        terminals are 1 - the continue flags, the first the data's."""
        gamma, H = self.gamma, actions.shape[0]
        cont = 1.0 - terminals
        features = features.detach()
        logits = self.critic(features).float()
        slow_logits = self.critic_target(features[:-1]).float()
        with span("pd.twohot"):
            critic = TwoHotSymlog(logits, self.bins)
            value = critic.mean.detach()
            slow_value = TwoHotSymlog(slow_logits, self.bins).mean
        ret = lambda_return(rewards[1:], value, cont[1:], gamma, self.lambda_)
        weight = (torch.cumprod(gamma * cont, 0) / gamma).detach()
        with span("pd.retnorm"):
            if update_stats:
                self.retnorm.update(ret)
            advantage = (ret - value[:-1]) / self.retnorm.scale()

        policy_distr = self.forward_actor(features[:-1])
        action_logprob = policy_distr.log_prob(actions.detach())
        policy_entropy = policy_distr.entropy()
        loss_actor = -action_logprob * advantage.detach() - self.entropy_weight * policy_entropy
        loss_actor = (loss_actor * weight[:-1]).mean()
        with span("pd.twohot"):
            head = TwoHotSymlog(logits[:-1], self.bins)
            loss_critic = -head.log_prob(ret.detach()) - head.log_prob(slow_value.detach())
        loss_critic = (loss_critic * weight[:-1]).mean()

        reward1 = rewards[1:]
        metrics = dict(
            loss_critic=loss_critic.detach(),
            loss_actor=loss_actor.detach(),
            policy_entropy=policy_entropy.mean().detach(),
            policy_value=value[0].mean(),
            policy_value_im=value[:H].mean(),
            policy_reward=reward1.mean().detach(),
            policy_reward_std=batch_var(reward1, reduce=self.batch_reduce).sqrt().detach(),
            return_low=self.retnorm.stats[0].clone(),
            return_high=self.retnorm.stats[1].clone(),
        )
        tensors = dict(value=value, value_target=ret.detach(), value_advantage=advantage.detach(),
                       value_advantage_gae=advantage.detach(), value_weight=weight[:-1])
        return (loss_actor, loss_critic), metrics, tensors
