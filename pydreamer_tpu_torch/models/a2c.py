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

Sequence convention:
    features[0] -> actions[0] -> rewards[1], terminals[1], features[1] -> ...
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from .distributions import OneHotCategorical, normal_tanh, tanh_normal, trunc_normal
from .functions import batch_var
from .modules import MLP

__all__ = ["ActorCritic", "Critic", "gae_advantage", "ACTOR_DISTS"]

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


class Critic(nn.Module):
    """Critic and frozen critic target (4-layer 400-wide MLPs)."""

    def __init__(self, in_dim: int, hidden_dim: int = 400, hidden_layers: int = 4,
                 layer_norm: bool = True, gamma: float = 0.999, lambda_gae: float = 0.95,
                 critic_features_grad: bool = False, gae_impl: str = "scan",
                 dtype=torch.float32):
        super().__init__()
        if gae_impl not in GAE_IMPLS:
            raise ValueError(f"unknown gae_impl {gae_impl!r}; options: {GAE_IMPLS}")
        self.gamma = gamma
        self.lambda_ = lambda_gae
        self.critic_features_grad = critic_features_grad
        self.critic = MLP(in_dim, 1, hidden_dim, hidden_layers, layer_norm, dtype)
        self.critic_target = MLP(in_dim, 1, hidden_dim, hidden_layers, layer_norm, dtype)
        self.critic_target.load_state_dict(self.critic.state_dict())
        self.critic_target.requires_grad_(False)

    @torch.no_grad()
    def update_critic_target(self) -> None:
        """Hard copy critic -> critic_target."""
        for tgt, src in zip(self.critic_target.parameters(), self.critic.parameters()):
            tgt.copy_(src)

    def forward_value(self, features: torch.Tensor) -> torch.Tensor:
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
                 gae_impl: str = "scan", dtype=torch.float32):
        super().__init__(in_dim, hidden_dim, hidden_layers, layer_norm, gamma, lambda_gae,
                         gae_impl=gae_impl, dtype=dtype)
        if actor_grad not in ACTOR_GRADS:
            raise ValueError(f"unknown actor_grad {actor_grad!r}; options: {ACTOR_GRADS}")
        if actor_dist not in ACTOR_DISTS:
            raise ValueError(f"unknown actor_dist {actor_dist!r}; options: {sorted(ACTOR_DISTS)}")
        self.entropy_weight = entropy_weight
        self.actor_grad = actor_grad
        self.actor_dist = actor_dist
        actor_out = out_actions if actor_dist == "onehot" else 2 * out_actions
        self.actor = MLP(in_dim, actor_out, hidden_dim, hidden_layers, layer_norm, dtype)

    def forward_actor(self, features: torch.Tensor):
        return ACTOR_DISTS[self.actor_dist](self.actor(features).float())

    def training_step(self,
                      features: torch.Tensor,   # (J,M,F) J=H+1
                      actions: torch.Tensor,    # (H,M,A)
                      rewards: torch.Tensor,    # (J,M)
                      terminals: torch.Tensor,  # (J,M)
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Dict, Dict]:
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
