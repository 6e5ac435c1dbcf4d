"""Dreamer agent: world model + actor-critic trained in imagination.

Counterpart of ``pydreamer_tpu/models/dreamer.py``: ``prepare_obs`` (50-59),
``WorldModel.training_step`` (189-264), ``Dreamer.dream`` (328-376) and
``Dreamer.training_step`` (380-447). ``Dreamer`` is one ``nn.Module`` whose
submodules are ``wm`` (encoder, core, decoder), ``probe`` and ``ac`` (actor,
critic, critic_target), the JAX params tree's top-level keys.

Gradient routing: each loss touches only its own parameters, so one
``backward()`` over the summed losses yields the partitioned gradients:
  * loss_model:  wm only
  * loss_probe:  probe only (features detached unless probe_gradients)
  * loss_actor:  actor only (with ``actor_grad: reinforce`` the whole dream
    is detached, so it runs under ``torch.no_grad()``; K1 still runs there,
    at M = T*B*I rows)
  * loss_critic: critic only

Out of scope so far (``NotImplementedError``): ``actor_grad: dynamics``,
``do_image_pred``, ``do_dream_tensors``, ``aux_critic``, ``iwae_samples > 1``
and ``inference``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..device import compute_dtype, resolve_device
from .a2c import ActorCritic
from .decoders import MultiDecoder
from .encoders import MultiEncoder
from .functions import logavgexp, unflatten_batch
from .probes import make_probe
from .rssm import RSSMCore, init_state, to_feature, z_noise_shape

__all__ = ["Dreamer", "WorldModel", "prepare_obs"]


def prepare_obs(obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """On-device obs normalization: uint8 image -> float32 in [-0.5, 0.5]."""
    if "image" in obs and obs["image"].dtype == torch.uint8:
        obs = dict(obs)
        obs["image"] = obs["image"].float() / 255.0 - 0.5
    return obs


class WorldModel(nn.Module):
    """Encoder -> RSSM -> multi-head decoder with KL-balanced ELBO."""

    def __init__(self, conf, dtype: torch.dtype):
        super().__init__()
        if conf.aux_critic:
            raise NotImplementedError("aux_critic is not ported yet")
        self.deter_dim = conf.deter_dim
        self.stoch_dim = conf.stoch_dim
        self.stoch_discrete = conf.stoch_discrete
        self.kl_weight = conf.kl_weight
        self.kl_balance = None if conf.kl_balance == 0.5 else conf.kl_balance
        self.features_dim = conf.deter_dim + conf.stoch_dim * (conf.stoch_discrete or 1)

        self.encoder = MultiEncoder(
            conf.image_encoder, conf.image_size, conf.image_channels, conf.cnn_depth,
            conf.image_encoder_layers, conf.vecobs_size, conf.reward_input,
            conv_impl=conf.get("conv_impl", "auto"), layer_norm=conf.layer_norm, dtype=dtype)
        self.decoder = MultiDecoder(
            self.features_dim, conf.image_decoder, conf.image_size, conf.image_channels,
            conf.cnn_depth, conf.image_decoder_layers, conf.image_decoder_min_prob,
            conf.reward_decoder_layers, conf.terminal_decoder_layers,
            conf.reward_decoder_categorical, conf.vecobs_size,
            image_weight=conf.image_weight, vecobs_weight=conf.vecobs_weight,
            reward_weight=conf.reward_weight, terminal_weight=conf.terminal_weight,
            transpose_impl=conf.get("conv_transpose_impl", "auto"),
            layer_norm=conf.layer_norm, dtype=dtype)
        self.core = RSSMCore(
            self.encoder.out_dim, conf.action_dim, conf.deter_dim, conf.stoch_dim,
            conf.stoch_discrete, conf.hidden_dim, conf.gru_layers, conf.gru_type,
            conf.layer_norm, dtype)

    def training_step(self, obs, in_state, z_noise, iwae_samples: int = 1,
                      do_open_loop: bool = False):
        """Returns (loss, features, states, out_state, metrics, tensors)."""
        if iwae_samples != 1:
            raise NotImplementedError("iwae_samples > 1 is not ported yet")
        embed = self.encoder(obs)
        prior, post, _, features, states, out_state = self.core(
            embed, obs["action"], obs["reset"], in_state, z_noise, iwae_samples, do_open_loop)

        loss_reconstr, metrics, tensors = self.decoder(features, obs)

        # KL loss with balancing.
        zdistr = self.core.zdistr
        dprior = zdistr(prior)
        dpost = zdistr(post)
        loss_kl_exact = dpost.kl_to(dprior)  # (T,B,I)
        if not self.kl_balance:
            loss_kl = loss_kl_exact
        else:
            loss_kl_postgrad = dpost.kl_to(zdistr(prior.detach()))
            loss_kl_priograd = zdistr(post.detach()).kl_to(dprior)
            loss_kl = ((1 - self.kl_balance) * loss_kl_postgrad
                       + self.kl_balance * loss_kl_priograd)

        loss_model_tbi = self.kl_weight * loss_kl + loss_reconstr
        loss_model_tb = -logavgexp(-loss_model_tbi, 2)
        loss = loss_model_tb.mean()

        loss_kl_metric = -logavgexp(-loss_kl_exact.detach(), 2)
        entropy_prior = dprior.entropy().detach().mean(2)
        entropy_post = dpost.entropy().detach().mean(2)
        tensors.update(loss_kl=loss_kl_metric, entropy_prior=entropy_prior,
                       entropy_post=entropy_post)
        metrics.update(loss_model=loss_model_tb.mean().detach(),
                       loss_kl=loss_kl_metric.mean(),
                       entropy_prior=entropy_prior.mean(),
                       entropy_post=entropy_post.mean())
        return loss, features, states, out_state, metrics, tensors


class Dreamer(nn.Module):
    """Top-level agent: ``wm``, ``probe`` and ``ac`` on one device.

    ``device`` defaults to ``"cuda"`` and raises without a card unless the
    caller passes ``"cpu"``. Parameters are float32; the compute dtype comes
    from ``conf.precision``.
    """

    def __init__(self, conf, device: str | torch.device = "cuda"):
        super().__init__()
        if conf.action_dim <= 0:
            raise ValueError("Need to set action_dim to match environment")
        if conf.iwae_samples != 1:
            raise NotImplementedError("iwae_samples > 1 is not ported yet")
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = compute_dtype(conf)
        self.imag_horizon = conf.imag_horizon
        self.probe_gradients = conf.probe_gradients
        self.features_dim = conf.deter_dim + conf.stoch_dim * (conf.stoch_discrete or 1)

        self.wm = WorldModel(conf, self.dtype)
        self.ac = ActorCritic(
            self.features_dim, conf.action_dim, layer_norm=conf.layer_norm,
            gamma=conf.gamma, lambda_gae=conf.lambda_gae, entropy_weight=conf.entropy,
            actor_grad=conf.actor_grad, actor_dist=conf.actor_dist,
            gae_impl=conf.get("gae_impl", "scan"), dtype=self.dtype)
        self.probe = make_probe(conf, self.features_dim, self.dtype)
        self.to(self.device)

    def init_state(self, batch_size: int):
        return init_state(batch_size, self.conf.deter_dim, self.conf.stoch_dim,
                          self.conf.stoch_discrete, device=self.device)

    # -- imagination ------------------------------------------------------

    def dream(self, in_state, imag_horizon: int, noise):
        """H-step open-loop rollout through the prior with the policy.

        Returns (features (H+1,M,F), actions (H,M,A), rewards (H+1,M),
        terminals (H+1,M)). The caller runs it under ``torch.no_grad()`` for
        ``actor_grad: reinforce``.
        """
        M = in_state[0].shape[0]
        zshape = z_noise_shape((M,), self.wm.stoch_dim, self.wm.stoch_discrete)
        state = in_state
        features, actions = [], []
        for t in range(imag_horizon):
            feature = to_feature(*state)
            action_dist = self.ac.forward_actor(feature)
            action = action_dist.sample_noise(
                noise.dream_action(t, tuple(action_dist.logits.shape)))
            _, state = self.wm.core.prior_step(state, action, None, noise.dream_z(t, zshape))
            features.append(feature)
            actions.append(action)
        features.append(to_feature(*state))
        features = torch.stack(features)
        actions = torch.stack(actions)
        rewards, terminals = self.wm.decoder.reward_terminal(features)
        return features, actions, rewards, terminals

    # -- training ---------------------------------------------------------

    def training_step(self, obs, in_state, noise,
                      iwae_samples: Optional[int] = None,
                      imag_horizon: Optional[int] = None,
                      do_open_loop: bool = False,
                      do_image_pred: bool = False,
                      do_dream_tensors: bool = False):
        """One forward over the batch.

        Returns (losses, out_state, metrics, tensors, dream_tensors) where
        losses = {loss_model, loss_probe, loss_actor, loss_critic}.
        """
        if do_image_pred:
            raise NotImplementedError("do_image_pred is not ported yet")
        if do_dream_tensors:
            raise NotImplementedError("do_dream_tensors is not ported yet")
        obs = prepare_obs(obs)
        I = int(iwae_samples or self.conf.iwae_samples)
        H = int(imag_horizon or self.imag_horizon)
        T, B = obs["action"].shape[:2]

        # World model; the posterior noise for the whole loop is drawn up front.
        z_noise = noise.posterior_z(z_noise_shape((T, B * I), self.wm.stoch_dim,
                                                  self.wm.stoch_discrete))
        loss_model, features, states, out_state, metrics, tensors = \
            self.wm.training_step(obs, in_state, z_noise, iwae_samples=I,
                                  do_open_loop=do_open_loop)

        # Probe (detached features unless probe_gradients).
        features_probe = features if self.probe_gradients else features.detach()
        loss_probe, metrics_probe, tensors_probe = self.probe.training_step(features_probe, obs)
        metrics.update(metrics_probe)
        tensors.update(tensors_probe)

        # Imagination + actor-critic. reinforce: the dream is detached whole.
        in_state_dream = tuple(s.detach().reshape((-1,) + tuple(s.shape[3:])) for s in states)
        with torch.no_grad():
            features_dream, actions_dream, rewards_dream, terminals_dream = \
                self.dream(in_state_dream, H, noise)
        (loss_actor, loss_critic), metrics_ac, tensors_ac = self.ac.training_step(
            features_dream, actions_dream, rewards_dream, terminals_dream)
        metrics.update(metrics_ac)
        tensors.update(policy_value=unflatten_batch(tensors_ac["value"][0], (T, B, I)).mean(-1))

        losses = dict(loss_model=loss_model, loss_probe=loss_probe,
                      loss_actor=loss_actor, loss_critic=loss_critic)
        return losses, out_state, metrics, tensors, {}
