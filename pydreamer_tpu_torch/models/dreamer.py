"""Dreamer agent: world model + actor-critic trained in imagination.

Counterpart of ``pydreamer_tpu/models/dreamer.py``: ``prepare_obs`` (50-59),
``WorldModel.forward`` and ``training_step`` with the IWAE sampled KL, the
auxiliary critic and ``do_image_pred`` (182-264), ``Dreamer.inference``
(307-324), ``Dreamer.dream`` (328-376) and ``Dreamer.training_step`` with the
``do_dream_tensors`` rollout (380-447). ``Dreamer`` is one ``nn.Module`` whose
submodules are ``wm`` (encoder, core, decoder and, with ``aux_critic``,
``ac_aux``), ``probe`` and ``ac`` (actor, critic, critic_target), the JAX
params tree's top-level keys.

Gradient routing: each loss touches only its own parameters, so one
``backward()`` over the summed losses yields the partitioned gradients:
  * loss_model:  wm only (the auxiliary critic's loss is part of it)
  * loss_probe:  probe only (features detached unless probe_gradients)
  * loss_actor:  actor only. The dream starts from detached states and runs
    with the world model frozen (``requires_grad`` off on its parameters
    while the dream runs, the counterpart of JAX's ``stop_gradient`` on the
    wm params). With ``actor_grad: reinforce`` the whole dream is detached,
    so it runs under ``torch.no_grad()``; with ``dynamics`` it carries the
    gradient through the frozen world model (K1 included) into the actor.
  * loss_critic: critic only

``model: dreamerv3`` builds DreamerV3 (Hafner et al. 2023, arXiv:2301.04104)
from the same classes, with the options fixed here at construction
(``dreamerv3_options``): SiLU, no bias before a LayerNorm, the 1% uniform mix
of the latents and the actor, the learned initial state, the LayerNorm conv
encoder and decoder, the two-hot symlog reward head and critic, the continue
head, the KL of each side clipped below at ``KL_FREE`` nats, and the
actor-critic's DreamerV3 objective (``models/a2c.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..device import compute_dtype, resolve_device
from ..tracing import span
from .a2c import ActorCritic, Critic
from .decoders import MultiDecoder
from .distributions import TwoHotSymlog
from .encoders import MultiEncoder
from .functions import expand_iwae, logavgexp, unflatten_batch
from .probes import make_probe
from .rssm import (RSSMCore, feature_replace_z, init_state, to_feature, z_noise_kind,
                   z_noise_shape)

__all__ = ["Dreamer", "WorldModel", "prepare_obs", "frozen", "dreamerv3_options",
           "free_bits_kl", "UNIMIX", "KL_FREE", "KL_DYN", "KL_REP"]

# DreamerV3's published constants (configs.yaml of its code's first release):
# the uniform share mixed into the latents' and the actor's probabilities, the
# free nats of each KL side and the weights of the two sides.
UNIMIX = 0.01
KL_FREE, KL_DYN, KL_REP = 1.0, 0.5, 0.1


def dreamerv3_options(conf) -> Dict:
    """The construction-time options that set a module to DreamerV3's
    (``model: dreamerv3``) or leave it DreamerV2's (``model: dreamer``)."""
    if conf.model == "dreamerv3":
        return dict(v3=True, act="silu", hidden_bias=False, unimix=UNIMIX,
                    twohot_bins=TwoHotSymlog.BINS, initial="learned")
    return dict(v3=False, act="elu", hidden_bias=True, unimix=0.0, twohot_bins=0,
                initial="zeros")


def prepare_obs(obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """On-device obs normalization: uint8 image -> float32 in [-0.5, 0.5]."""
    if "image" in obs and obs["image"].dtype == torch.uint8:
        obs = dict(obs)
        obs["image"] = obs["image"].float() / 255.0 - 0.5
    return obs


@contextlib.contextmanager
def frozen(module: nn.Module):
    """Turn ``requires_grad`` off on the module's parameters for the block and
    restore each parameter's own flag after it. Autograd records the flag
    when an op runs, so ops run inside the block take no gradient to these
    parameters, whenever the backward comes."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def free_bits_kl(zdistr, post, prior):
    """DreamerV3's KL loss from the posterior's and the prior's statistics:
    dyn = max(KL_FREE, KL[sg(post) || prior]) trains the prior, rep =
    max(KL_FREE, KL[post || sg(prior)]) the posterior; -> (KL_DYN dyn + KL_REP
    rep, dyn, rep). Below ``KL_FREE`` nats a side takes no gradient."""
    dyn = zdistr(post.detach()).kl_to(zdistr(prior)).clamp(min=KL_FREE)
    rep = zdistr(post).kl_to(zdistr(prior.detach())).clamp(min=KL_FREE)
    return KL_DYN * dyn + KL_REP * rep, dyn, rep


class WorldModel(nn.Module):
    """Encoder -> RSSM -> multi-head decoder with KL-balanced ELBO."""

    def __init__(self, conf, dtype: torch.dtype):
        super().__init__()
        v3 = dreamerv3_options(conf)
        self.deter_dim = conf.deter_dim
        self.stoch_dim = conf.stoch_dim
        self.stoch_discrete = conf.stoch_discrete
        self.kl_weight = 1.0 if v3["v3"] else conf.kl_weight
        self.kl_balance = None if conf.kl_balance == 0.5 else conf.kl_balance
        self.free_bits = v3["v3"]  # DreamerV3's KL (free_bits_kl)
        self.aux_critic_weight = conf.aux_critic_weight
        self.features_dim = conf.deter_dim + conf.stoch_dim * (conf.stoch_discrete or 1)
        if v3["v3"] and conf.aux_critic:
            raise ValueError("model: dreamerv3 has no auxiliary critic")

        self.encoder = MultiEncoder(
            conf.image_encoder, conf.image_size, conf.image_channels, conf.cnn_depth,
            conf.image_encoder_layers, conf.vecobs_size, conf.reward_input,
            conv_impl=conf.get("conv_impl", "auto"), layer_norm=conf.layer_norm, dtype=dtype,
            cnn_norm=v3["v3"])
        self.decoder = MultiDecoder(
            self.features_dim, conf.image_decoder, conf.image_size, conf.image_channels,
            conf.cnn_depth, conf.image_decoder_layers, conf.image_decoder_min_prob,
            conf.reward_decoder_layers, conf.terminal_decoder_layers,
            conf.reward_decoder_categorical, conf.vecobs_size,
            image_weight=conf.image_weight, vecobs_weight=conf.vecobs_weight,
            reward_weight=conf.reward_weight, terminal_weight=conf.terminal_weight,
            transpose_impl=conf.get("conv_transpose_impl", "auto"),
            layer_norm=conf.layer_norm, dtype=dtype, cnn_norm=v3["v3"],
            twohot_bins=v3["twohot_bins"], predict_continue=v3["v3"],
            mlp_units=conf.get("mlp_units", 400), act=v3["act"], hidden_bias=v3["hidden_bias"])
        self.core = RSSMCore(
            self.encoder.out_dim, conf.action_dim, conf.deter_dim, conf.stoch_dim,
            conf.stoch_discrete, conf.hidden_dim, conf.gru_layers, conf.gru_type,
            conf.layer_norm, dtype, act=v3["act"], unimix=v3["unimix"],
            norm_bias=v3["hidden_bias"], initial=v3["initial"])
        if v3["twohot_bins"]:  # DreamerV3 starts the reward head's output at zero
            nn.init.zeros_(self.decoder.reward.model.get_submodule(
                f"Dense_{conf.reward_decoder_layers}").weight)
        # The auxiliary critic on real data: critic only, its loss reaches the
        # world model's features (critic_features_grad).
        self.ac_aux = (Critic(self.features_dim, layer_norm=conf.layer_norm, gamma=conf.gamma_aux,
                              lambda_gae=conf.lambda_gae_aux, critic_features_grad=True,
                              gae_impl=conf.get("gae_impl", "scan"), dtype=dtype)
                       if conf.aux_critic else None)

    def z_noise(self, noise, name: str, prefix) -> torch.Tensor:
        """Latent noise for ``prefix`` states, of the latent's kind."""
        return noise.draw(name, z_noise_shape(prefix, self.stoch_dim, self.stoch_discrete),
                          z_noise_kind(self.stoch_discrete))

    def forward(self, obs, in_state, noise):
        """Features + new state only (the acting path)."""
        T, B = obs["action"].shape[:2]
        embed = self.encoder(obs)
        _, _, _, features, _, out_state = self.core(
            embed, obs["action"], obs["reset"], in_state,
            self.z_noise(noise, "posterior_z", (T, B)), 1, False)
        return features, out_state

    def training_step(self, obs, in_state, noise, iwae_samples: int = 1,
                      do_open_loop: bool = False, do_image_pred: bool = False):
        """Returns (loss, features, states, out_state, metrics, tensors)."""
        I = iwae_samples
        T, B = obs["action"].shape[:2]
        with span("pd.encoder"):
            embed = self.encoder(obs)
        with span("pd.posterior"):
            prior, post, post_samples, features, states, out_state = self.core(
                embed, obs["action"], obs["reset"], in_state,
                self.z_noise(noise, "posterior_z", (T, B * I)), I, do_open_loop)
        with span("pd.heads"):
            loss, metrics, tensors = self._heads(obs, noise, prior, post, post_samples,
                                                 features, I, do_image_pred)
        return loss, features, states, out_state, metrics, tensors

    def _heads(self, obs, noise, prior, post, post_samples, features, I: int,
               do_image_pred: bool):
        """The decoders, the KL loss and the auxiliary critic -> (loss, metrics, tensors)."""
        T, B = obs["action"].shape[:2]
        loss_reconstr, metrics, tensors = self.decoder(features, obs)

        # KL loss with balancing; the sampled KL for the IWAE bound.
        zdistr = self.core.zdistr
        dprior = zdistr(prior)
        dpost = zdistr(post)
        loss_kl_exact = dpost.kl_to(dprior)  # (T,B,I)
        if self.free_bits:
            if I > 1:
                raise ValueError("model: dreamerv3 takes iwae_samples 1")
            loss_kl, loss_dyn, loss_rep = free_bits_kl(zdistr, post, prior)
            metrics.update(loss_dyn=loss_dyn.detach().mean(), loss_rep=loss_rep.detach().mean())
        elif I > 1:
            z = (post_samples.reshape(post.shape[:-1] + (self.stoch_dim, self.stoch_discrete))
                 if self.stoch_discrete else post_samples)
            loss_kl = dpost.log_prob(z) - dprior.log_prob(z)
        elif not self.kl_balance:
            loss_kl = loss_kl_exact
        else:
            loss_kl_postgrad = dpost.kl_to(zdistr(prior.detach()))
            loss_kl_priograd = zdistr(post.detach()).kl_to(dprior)
            loss_kl = ((1 - self.kl_balance) * loss_kl_postgrad
                       + self.kl_balance * loss_kl_priograd)

        loss_critic_aux = 0.0
        if self.ac_aux is not None:
            loss_critic_aux, metrics_ac, tensors_ac = self.ac_aux.critic_training_step(
                features[:, :, 0], obs["reward"], obs["terminal"])
            metrics.update(loss_critic_aux=metrics_ac["loss_critic"],
                           policy_value_aux=metrics_ac["policy_value_im"])
            tensors.update(policy_value_aux=tensors_ac["value"])

        loss_model_tbi = self.kl_weight * loss_kl + loss_reconstr
        loss_model_tb = -logavgexp(-loss_model_tbi, 2)
        loss = loss_model_tb.mean() + self.aux_critic_weight * loss_critic_aux

        loss_kl_metric = -logavgexp(-loss_kl_exact.detach(), 2)
        entropy_prior = dprior.entropy().detach().mean(2)
        entropy_post = dpost.entropy().detach().mean(2)
        tensors.update(loss_kl=loss_kl_metric, entropy_prior=entropy_prior,
                       entropy_post=entropy_post)
        metrics.update(loss_model=loss_model_tb.mean().detach(),
                       loss_kl=loss_kl_metric.mean(),
                       entropy_prior=entropy_prior.mean(),
                       entropy_post=entropy_post.mean())

        if do_image_pred:
            # Decode from prior samples: open-loop quality metrics only.
            with torch.no_grad():
                dprior_sg = zdistr(prior.detach())
                pz = self.z_noise(noise, "pred_z", (T, B, I))
                prior_samples = dprior_sg.sample_noise(pz).reshape(post_samples.shape)
                features_prior = feature_replace_z(features.detach(), prior_samples)
                _, mets, tens = self.decoder(features_prior, obs, extra_metrics=True)
            metrics.update({k.replace("loss_", "logprob_"): v
                            for k, v in mets.items() if k.startswith("loss_")})
            tensors.update({k.replace("loss_", "logprob_"): v
                            for k, v in tens.items() if k.startswith("loss_")})
            tensors.update({k.replace("_rec", "_pred"): v
                            for k, v in tens.items() if k.endswith("_rec")})
        return loss, metrics, tensors


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
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = compute_dtype(conf)
        self.imag_horizon = conf.imag_horizon
        self.probe_gradients = conf.probe_gradients
        self.features_dim = conf.deter_dim + conf.stoch_dim * (conf.stoch_discrete or 1)
        v3 = dreamerv3_options(conf)
        self.v3 = v3["v3"]

        self.wm = WorldModel(conf, self.dtype)
        self.ac = ActorCritic(
            self.features_dim, conf.action_dim, hidden_dim=conf.get("mlp_units", 400),
            hidden_layers=conf.get("actor_critic_layers", 4), layer_norm=conf.layer_norm,
            gamma=conf.gamma, lambda_gae=conf.lambda_gae, entropy_weight=conf.entropy,
            actor_grad=conf.actor_grad, actor_dist=conf.actor_dist,
            gae_impl=conf.get("gae_impl", "scan"), dtype=self.dtype, act=v3["act"],
            hidden_bias=v3["hidden_bias"], twohot_bins=v3["twohot_bins"], unimix=v3["unimix"],
            dreamerv3=self.v3)
        if self.v3:  # DreamerV3 starts the critic's output at zero, the slow critic a copy
            nn.init.zeros_(self.ac.critic.get_submodule(f"Dense_{self.ac.critic.hidden_layers}")
                           .weight)
            self.ac.critic_target.load_state_dict(self.ac.critic.state_dict())
        self.probe = make_probe(conf, self.features_dim, self.dtype)
        self.to(self.device)

    def init_state(self, batch_size: int):
        """The TBTT state a run starts from: zeros, or the learned initial
        state (``initial: learned``), without a gradient."""
        if self.wm.core.cell.initial is not None:
            with torch.no_grad():
                return tuple(s.contiguous() for s in self.wm.core.cell.initial_state(batch_size))
        return init_state(batch_size, self.conf.deter_dim, self.conf.stoch_dim,
                          self.conf.stoch_discrete, device=self.device)

    # -- inference (acting) ----------------------------------------------

    @torch.no_grad()
    def inference(self, obs, in_state, noise):
        """One acting step: obs (T=1,B,...) -> (action (1,B,A), out_state,
        metrics). The metrics are per slot, (B,): the batched generator
        attributes them to each env's episode."""
        obs = prepare_obs(obs)
        features, out_state = self.wm(obs, in_state, noise)
        feature = features[:, :, 0]  # (1,B,F)
        action_distr = self.ac.forward_actor(feature)
        value = self.ac.forward_value(feature)
        action = action_distr.sample_noise(noise.draw(
            "action", tuple(feature.shape[:2]) + (self.conf.action_dim,), action_distr.NOISE))
        metrics = dict(policy_value=value[0],
                       policy_entropy=action_distr.entropy()[0],
                       action_prob=action_distr.log_prob(action).exp()[0])
        return action, out_state, metrics

    # -- imagination ------------------------------------------------------

    def dream(self, in_state, imag_horizon: int, noise, dynamics_gradients: bool = False,
              prefix: str = "dream"):
        """H-step open-loop rollout through the prior with the policy, the
        world model frozen. Draws ``<prefix>_action`` and ``<prefix>_z`` noise.

        Returns (features (H+1,M,F), actions (H,M,A), rewards (H+1,M),
        terminals (H+1,M)). With ``dynamics_gradients`` the actions are
        reparameterized samples (straight-through for one-hot); the caller
        runs it under ``torch.no_grad()`` otherwise.
        """
        M = in_state[0].shape[0]
        action_shape = (M, self.conf.action_dim)
        state = in_state
        features, actions = [], []
        with frozen(self.wm):
            for t in range(imag_horizon):
                feature = to_feature(*state)
                action_dist = self.ac.forward_actor(feature)
                eps = noise.draw(f"{prefix}_action", action_shape, action_dist.NOISE, t)
                action = (action_dist.rsample_noise(eps) if dynamics_gradients
                          else action_dist.sample_noise(eps))
                zn = noise.draw(f"{prefix}_z", z_noise_shape((M,), self.wm.stoch_dim,
                                                             self.wm.stoch_discrete),
                                z_noise_kind(self.wm.stoch_discrete), t)
                _, state = self.wm.core.prior_step(state, action, None, zn)
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
        with span("pd.encoder"):
            obs = prepare_obs(obs)
        I = int(iwae_samples or self.conf.iwae_samples)
        H = int(imag_horizon or self.imag_horizon)
        T, B = obs["action"].shape[:2]

        loss_model, features, states, out_state, metrics, tensors = self.wm.training_step(
            obs, in_state, noise, iwae_samples=I, do_open_loop=do_open_loop,
            do_image_pred=do_image_pred)

        # Probe (detached features unless probe_gradients).
        with span("pd.heads"):
            features_probe = features if self.probe_gradients else features.detach()
            loss_probe, metrics_probe, tensors_probe = self.probe.training_step(features_probe,
                                                                                obs)
            metrics.update(metrics_probe)
            tensors.update(tensors_probe)

        # Imagination + actor-critic; reinforce detaches the dream whole.
        with span("pd.dream"):
            in_state_dream = tuple(s.detach().reshape((-1,) + tuple(s.shape[3:])) for s in states)
            dynamics = self.ac.actor_grad == "dynamics"
            with torch.set_grad_enabled(dynamics and torch.is_grad_enabled()):
                dream = self.dream(in_state_dream, H, noise, dynamics)
                if self.v3:  # the first continue flag is the data's
                    start = expand_iwae(obs["terminal"], I).reshape(1, -1).float()
                    dream = (*dream[:3], torch.cat([start, dream[3][1:]]))
        with span("pd.actor_critic"):
            (loss_actor, loss_critic), metrics_ac, tensors_ac = self.ac.training_step(*dream)
            metrics.update(metrics_ac)
            tensors.update(policy_value=unflatten_batch(tensors_ac["value"][0],
                                                        (T, B, I)).mean(-1))

        # Dream log sample: a T-1 step rollout from the first state, aligned
        # with the real batch for side-by-side logging.
        dream_tensors = {}
        if do_dream_tensors and self.conf.image_decoder:
            with span("pd.dream"), torch.no_grad():
                in_state_log = tuple(s.detach()[0, :, 0] for s in states)
                f_d, a_d, r_d, t_d = self.dream(in_state_log, T - 1, noise, prefix="log")
                image_dream = self.wm.decoder.image_forward(f_d)
                _, _, tens_ac = self.ac.training_step(f_d, a_d, r_d, t_d, update_stats=False)
            dream_tensors = dict(action_pred=torch.cat([obs["action"][:1].float(), a_d]),
                                 reward_pred=r_d, terminal_pred=t_d, image_pred=image_dream,
                                 **tens_ac)

        losses = dict(loss_model=loss_model, loss_probe=loss_probe,
                      loss_actor=loss_actor, loss_critic=loss_critic)
        return losses, out_state, metrics, tensors, dream_tensors
