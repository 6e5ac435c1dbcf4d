"""The plain reference of the DreamerV2 train step, in float32.

What the benchmark holds the program's ``TrainStep`` against. It follows
DreamerV2 (Hafner et al. 2021, arXiv:2010.02193) as jurgisp/pydreamer
configures it: a CNN encoder (4x conv k4 s2 + ELU), the RSSM with discrete
latents (straight-through samples) and the late-reset GRU (one LayerNorm
over the 3H gates, update bias -1, reset applied to the candidate after the
norm), the CNN decoder and the reward and terminal heads, the KL balanced at
``kl_balance``, a dream of ``imag_horizon`` steps through the prior from
every posterior state, and the actor-critic (GAE targets from a frozen
critic target, a reinforce or a dynamics actor loss, an entropy bonus),
each loss's parameters clipped by their global norm and updated by AdamW.

It is plain ``torch``: no kernel, no cache, no batching trick, no mixed
precision. It imports nothing of the program; the parameter names are the
program's ``state_dict`` names, so one weight dict loads into both. Run it
with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False): the caller sets them.

The benchmark finds this module by the configuration's ``model`` key and
uses ``Model(conf, cast)`` with its ``init_state`` and ``TrainStep(model,
conf)``. ``cast`` is applied to both operands of every matrix product and
convolution. The identity gives the reference; a rounding to a lower
precision gives the control that the comparison has to fail.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Model", "TrainStep", "GROUPS", "identity"]

LN_EPS = 1e-3
GROUPS = ("wm", "probe", "actor", "critic")


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Linear(nn.Module):
    """y = cast(x) @ cast(W).T + b."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True, cast: Callable = identity):
        super().__init__()
        self.cast = cast
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x):
        return F.linear(self.cast(x), self.cast(self.weight), self.bias)


class Norm(nn.Module):
    """LayerNorm over the last axis, eps 1e-3."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, LN_EPS)


class MLP(nn.Module):
    """[Linear -> LayerNorm -> ELU] x layers -> Linear; a width-1 output is squeezed."""

    def __init__(self, n_in: int, n_out: int, hidden: int, layers: int, cast: Callable):
        super().__init__()
        self.layers, self.n_out = layers, n_out
        dims = [n_in] + [hidden] * layers
        for i in range(layers):
            self.add_module(f"Dense_{i}", Linear(dims[i], hidden, cast=cast))
            self.add_module(f"Norm_{i}", Norm(hidden))
        self.add_module(f"Dense_{layers}", Linear(dims[-1], n_out, cast=cast))

    def forward(self, x):
        for i in range(self.layers):
            x = F.elu(getattr(self, f"Norm_{i}")(getattr(self, f"Dense_{i}")(x)))
        x = getattr(self, f"Dense_{self.layers}")(x)
        return x.squeeze(-1) if self.n_out == 1 else x


# -- distributions --------------------------------------------------------

def _normalize(logits):
    return logits - torch.logsumexp(logits, -1, keepdim=True)


def onehot_sample(logits, gumbel):
    return F.one_hot(torch.argmax(logits + gumbel, -1), logits.shape[-1]).float()


def onehot_rsample(logits, gumbel):
    """Straight-through: the one-hot sample forward, the softmax's gradient."""
    probs = logits.exp()
    return onehot_sample(logits, gumbel) + (probs - probs.detach())


def onehot_entropy(logits):
    return -(logits.exp() * logits).sum(-1)


def onehot_kl(logits_p, logits_q):
    return (logits_p.exp() * (logits_p - logits_q)).sum(-1)


_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_SQRT2 = math.sqrt(2.0)


def _phi(t):
    return torch.exp(-0.5 * t * t - _HALF_LOG_2PI)


class TruncNormal:
    """Normal(tanh(m), 2 sigmoid(s/2) + 0.1) truncated to [-1, 1] per action.

    A sample turns a uniform draw into the truncated standard normal by the
    inverse CDF between the bounds (the bounds and the draw carry no
    gradient), then ``clip(loc + scale * eps, -1, 1)``."""

    def __init__(self, x):
        mean, std = x.chunk(2, -1)
        self.loc = torch.tanh(mean)
        self.scale = 2.0 * torch.sigmoid(std / 2.0) + 0.1

    def _bounds(self):
        return (-1.0 - self.loc) / self.scale, (1.0 - self.loc) / self.scale

    def _logz(self):
        a, b = self._bounds()
        lb, la = torch.special.log_ndtr(b), torch.special.log_ndtr(a)
        return lb + torch.log1p(-torch.exp(la - lb))

    def sample(self, u):
        with torch.no_grad():
            a, b = self._bounds()
            alpha, beta = torch.erf(a / _SQRT2), torch.erf(b / _SQRT2)
            p = torch.maximum(alpha, u * (beta - alpha) + alpha)
            eps = _SQRT2 * torch.erfinv(p)
            eps = torch.clamp(eps, torch.nextafter(a, torch.full_like(a, math.inf)),
                              torch.nextafter(b, torch.full_like(b, -math.inf)))
        return torch.clamp(self.loc + self.scale * eps, -1.0, 1.0)

    def log_prob(self, y):
        lp = (-0.5 * ((y - self.loc) / self.scale).square() - self.scale.log()
              - _HALF_LOG_2PI - self._logz())
        return lp.sum(-1)

    def entropy(self):
        a, b = self._bounds()
        logz = self._logz()
        h = (_HALF_LOG_2PI + 0.5 + self.scale.log() + logz
             + (a * _phi(a) - b * _phi(b)) / (2.0 * torch.exp(logz)))
        return h.sum(-1)


class Categorical:
    """The one-hot action distribution."""

    def __init__(self, x):
        self.logits = _normalize(x)

    def sample(self, gumbel):
        return onehot_sample(self.logits, gumbel)

    def rsample(self, gumbel):
        return onehot_rsample(self.logits, gumbel)

    def log_prob(self, onehot):
        return (self.logits * onehot).sum(-1)

    def entropy(self):
        return onehot_entropy(self.logits)


# Each actor head with the kind of standard noise its sample takes.
ACTOR_HEADS = {"onehot": (Categorical, "gumbel"), "trunc_normal": (TruncNormal, "uniform")}


# -- the world model --------------------------------------------------------

class ConvEncoder(nn.Module):
    def __init__(self, channels: int, depth: int, cast: Callable):
        super().__init__()
        self.cast = cast
        chans = (channels, depth, 2 * depth, 4 * depth, 8 * depth)
        for i in range(4):
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.empty(chans[i + 1], chans[i], 4, 4))
            conv.bias = nn.Parameter(torch.empty(chans[i + 1]))
            self.add_module(f"conv_{i}", conv)

    def forward(self, image):  # (N, H, W, C) -> (N, 32 d), flattened in (H, W, C) order
        x = image.permute(0, 3, 1, 2)
        for i in range(4):
            conv = getattr(self, f"conv_{i}")
            x = F.elu(F.conv2d(self.cast(x), self.cast(conv.weight), conv.bias, stride=2))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ConvDecoder(nn.Module):
    KERNELS = (5, 5, 6, 6)

    def __init__(self, n_in: int, channels: int, depth: int, cast: Callable):
        super().__init__()
        self.cast, self.depth = cast, depth
        self.Dense_0 = Linear(n_in, 32 * depth, cast=cast)
        chans = (32 * depth, 4 * depth, 2 * depth, depth, channels)
        for i, k in enumerate(self.KERNELS):
            deconv = nn.Module()
            deconv.weight = nn.Parameter(torch.empty(chans[i], chans[i + 1], k, k))
            deconv.bias = nn.Parameter(torch.empty(chans[i + 1]))
            self.add_module(f"deconv_{i}", deconv)

    def forward(self, features):  # (N, F) -> (N, 64, 64, C)
        x = self.Dense_0(features).reshape(features.shape[0], 32 * self.depth, 1, 1)
        for i in range(4):
            deconv = getattr(self, f"deconv_{i}")
            x = F.conv_transpose2d(self.cast(x), self.cast(deconv.weight), deconv.bias, stride=2)
            if i < 3:
                x = F.elu(x)
        return x.permute(0, 2, 3, 1)


class Head(nn.Module):
    def __init__(self, n_in: int, layers: int, cast: Callable):
        super().__init__()
        self.model = MLP(n_in, 1, 400, layers, cast)


class Decoder(nn.Module):
    def __init__(self, c, features: int, cast: Callable):
        super().__init__()
        self.image = ConvDecoder(features, c["image_channels"], c["cnn_depth"], cast)
        self.reward = Head(features, c["reward_decoder_layers"], cast)
        self.terminal = Head(features, c["terminal_decoder_layers"], cast)


class Encoder(nn.Module):
    def __init__(self, c, cast: Callable):
        super().__init__()
        self.ConvEncoder_0 = ConvEncoder(c["image_channels"], c["cnn_depth"], cast)


class GRUCell(nn.Module):
    """The DreamerV2 late-reset GRU cell, unfused."""

    def __init__(self, n_in: int, hidden: int, cast: Callable):
        super().__init__()
        self.cast = cast
        self.weight_ih = nn.Parameter(torch.empty(n_in, 3 * hidden))
        self.weight_hh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.ln_scale = nn.Parameter(torch.empty(3 * hidden))
        self.ln_bias = nn.Parameter(torch.empty(3 * hidden))

    def forward(self, x, h):
        c = self.cast
        gates = c(x) @ c(self.weight_ih) + c(h) @ c(self.weight_hh)
        gates = F.layer_norm(gates, (gates.shape[-1],), self.ln_scale, self.ln_bias, LN_EPS)
        r, u, n = gates.chunk(3, -1)
        update = torch.sigmoid(u - 1.0)
        return update * torch.tanh(torch.sigmoid(r) * n) + (1.0 - update) * h


class GRUStack(nn.Module):
    def __init__(self, n_in: int, hidden: int, cast: Callable):
        super().__init__()
        self.cell_0 = GRUCell(n_in, hidden, cast)


class RSSMCell(nn.Module):
    def __init__(self, c, embed: int, cast: Callable):
        super().__init__()
        D, hid = c["deter_dim"], c["hidden_dim"]
        self.S, self.K = c["stoch_dim"], c["stoch_discrete"]
        Z = self.S * self.K
        self.z_mlp = Linear(Z, hid, cast=cast)
        self.a_mlp = Linear(c["action_dim"], hid, bias=False, cast=cast)
        self.in_norm = Norm(hid)
        self.gru = GRUStack(hid, D, cast)
        self.prior_mlp_h = Linear(D, hid, cast=cast)
        self.prior_norm = Norm(hid)
        self.prior_mlp = Linear(hid, Z, cast=cast)
        self.post_mlp_h = Linear(D, hid, cast=cast)
        self.post_mlp_e = Linear(embed, hid, bias=False, cast=cast)
        self.post_norm = Norm(hid)
        self.post_mlp = Linear(hid, Z, cast=cast)

    def logits(self, x):  # (..., S*K) -> normalized (..., S, K)
        return _normalize(x.reshape(x.shape[:-1] + (self.S, self.K)))

    def gru_step(self, h, z, action):
        za = F.elu(self.in_norm(self.z_mlp(z) + self.a_mlp(action)))
        return self.gru.cell_0(za, h)

    def prior(self, h):
        return self.prior_mlp(F.elu(self.prior_norm(self.prior_mlp_h(h))))

    def post(self, h, embed):
        return self.post_mlp(F.elu(self.post_norm(self.post_mlp_h(h) + self.post_mlp_e(embed))))

    def sample(self, stats, gumbel):
        return onehot_rsample(self.logits(stats), gumbel).reshape(stats.shape[0], -1)


class Core(nn.Module):
    def __init__(self, c, embed: int, cast: Callable):
        super().__init__()
        self.cell = RSSMCell(c, embed, cast)


class WorldModel(nn.Module):
    def __init__(self, c, cast: Callable):
        super().__init__()
        features = c["deter_dim"] + c["stoch_dim"] * c["stoch_discrete"]
        self.encoder = Encoder(c, cast)
        self.decoder = Decoder(c, features, cast)
        self.core = Core(c, 32 * c["cnn_depth"], cast)


class ActorCritic(nn.Module):
    def __init__(self, c, features: int, cast: Callable):
        super().__init__()
        head = ACTOR_HEADS[c["actor_dist"]][0]
        n_out = c["action_dim"] * (1 if head is Categorical else 2)
        self.critic = MLP(features, 1, 400, 4, cast)
        self.critic_target = MLP(features, 1, 400, 4, cast)
        self.actor = MLP(features, n_out, 400, 4, cast)


class Probe(nn.Module):
    """The ``none`` probe: one parameter, loss = its square."""

    def __init__(self):
        super().__init__()
        self.dummy = nn.Parameter(torch.empty(1))


def gae(advantage, terminal1, gamma: float, lam: float):
    out, nxt = [None] * advantage.shape[0], torch.zeros_like(advantage[-1])
    for t in range(advantage.shape[0] - 1, -1, -1):
        nxt = advantage[t] + lam * gamma * (1.0 - terminal1[t]) * nxt
        out[t] = nxt
    return torch.stack(out)


class Model(nn.Module):
    """World model, actor-critic and the ``none`` probe, as plain modules."""

    def __init__(self, c: Dict, cast: Callable = identity):
        super().__init__()
        if c["iwae_samples"] != 1 or c["gru_layers"] != 1 or c["image_encoder"] != "cnn":
            raise NotImplementedError("the reference covers iwae_samples 1, one GRU layer, "
                                      "the CNN encoder and decoder")
        self.c = c
        features = c["deter_dim"] + c["stoch_dim"] * c["stoch_discrete"]
        self.wm = WorldModel(c, cast)
        self.ac = ActorCritic(c, features, cast)
        self.probe = Probe()
        self.ac.critic_target.requires_grad_(False)

    def init_state(self, batch_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The zero TBTT state (h, z) of ``batch_size`` columns."""
        c = self.c
        return (torch.zeros(batch_size, c["deter_dim"], device=device),
                torch.zeros(batch_size, c["stoch_dim"] * c["stoch_discrete"], device=device))

    def losses(self, obs, state, noise) -> Tuple[Dict[str, torch.Tensor], Tuple, Dict]:
        """One forward: the four losses, the TBTT state to carry, the
        world model's loss terms (detached)."""
        c, wm, cell = self.c, self.wm, self.wm.core.cell
        image = obs["image"].float() / 255.0 - 0.5
        T, B = obs["action"].shape[:2]
        S, K = c["stoch_dim"], c["stoch_discrete"]

        embed = wm.encoder.ConvEncoder_0(image.reshape((T * B,) + image.shape[2:]))
        embed = embed.reshape(T, B, -1)
        gumbel = noise.draw("posterior_z", (T, B, S, K), "gumbel")
        keep = (~obs["reset"].bool()).float().unsqueeze(-1)
        h, z = state
        posts, hs, zs = [], [], []
        for t in range(T):
            h, z = h * keep[t], z * keep[t]
            h = cell.gru_step(h, z, obs["action"][t])
            post = cell.post(h, embed[t])
            z = cell.sample(post, gumbel[t])
            posts.append(post)
            hs.append(h)
            zs.append(z)
        posts, hs, zs = torch.stack(posts), torch.stack(hs), torch.stack(zs)
        priors = cell.prior(hs)
        features = torch.cat([hs, zs], -1)  # (T, B, F)
        flat = features.reshape(T * B, -1)

        decoder = wm.decoder
        decoded = decoder.image(flat).reshape(image.shape)
        loss_image = 0.5 * (decoded - image).square().sum((-1, -2, -3))
        std = 0.3989422804  # the fixed sigma that makes the reward term 0.5 * MSE
        reward_mean = decoder.reward.model(features)
        z_r = (obs["reward"] - reward_mean) / std
        loss_reward = (0.5 * z_r.square() + math.log(std) + _HALF_LOG_2PI) * std ** 2
        logit_t = decoder.terminal.model(features)
        loss_terminal = -(obs["terminal"] * logit_t - F.softplus(logit_t))

        lpost, lprior = cell.logits(posts), cell.logits(priors)
        kl_exact = onehot_kl(lpost, lprior).sum(-1)
        bal = c["kl_balance"]
        loss_kl = ((1 - bal) * onehot_kl(lpost, lprior.detach()).sum(-1)
                   + bal * onehot_kl(lpost.detach(), lprior).sum(-1))
        loss_model = (c["kl_weight"] * loss_kl + c["image_weight"] * loss_image
                      + c["reward_weight"] * loss_reward
                      + c["terminal_weight"] * loss_terminal).mean()
        terms = dict(loss_image=loss_image.mean(), loss_reward=loss_reward.mean(),
                     loss_terminal=loss_terminal.mean(), loss_kl=kl_exact.mean())

        dynamics = c["actor_grad"] == "dynamics"
        start = (hs.detach().reshape(T * B, -1), zs.detach().reshape(T * B, -1))
        with torch.set_grad_enabled(dynamics):
            dream = self.dream(start, noise, dynamics)
        loss_actor, loss_critic = self.actor_critic(*dream)
        losses = dict(loss_model=loss_model, loss_probe=self.probe.dummy.square().sum(),
                      loss_actor=loss_actor, loss_critic=loss_critic)
        return losses, (h.detach(), z.detach()), {k: v.detach() for k, v in terms.items()}

    def dream(self, state, noise, dynamics: bool):
        """H steps through the prior under the policy, the world model frozen."""
        c, wm, cell = self.c, self.wm, self.wm.core.cell
        head, kind = ACTOR_HEADS[c["actor_dist"]]
        h, z = state
        M, A = h.shape[0], c["action_dim"]
        features, actions = [], []
        flags = [(p, p.requires_grad) for p in wm.parameters()]
        wm.requires_grad_(False)
        try:
            for t in range(c["imag_horizon"]):
                feature = torch.cat([h, z], -1)
                policy = head(self.ac.actor(feature))
                eps = noise.draw("dream_action", (M, A), kind, t)
                action = policy.rsample(eps) if (dynamics and head is Categorical) else policy.sample(eps)
                gumbel = noise.draw("dream_z", (M, c["stoch_dim"], c["stoch_discrete"]), "gumbel", t)
                h = cell.gru_step(h, z, action)
                z = cell.sample(cell.prior(h), gumbel)
                features.append(feature)
                actions.append(action)
            features.append(torch.cat([h, z], -1))
            features, actions = torch.stack(features), torch.stack(actions)
            rewards = wm.decoder.reward.model(features)
            terminals = torch.sigmoid(wm.decoder.terminal.model(features))
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)
        return features, actions, rewards, terminals

    def actor_critic(self, features, actions, rewards, terminals):
        c, ac = self.c, self.ac
        gamma = c["gamma"]
        value_t = ac.critic_target(features)
        terminal0, terminal1 = terminals[:-1], terminals[1:]
        advantage = -value_t[:-1] + rewards[1:] + gamma * (1.0 - terminal1) * value_t[1:]
        advantage_gae = gae(advantage, terminal1, gamma, c["lambda_gae"])
        value_target = advantage_gae + value_t[:-1]
        weight = torch.cumprod(1.0 - terminal0, 0).detach()
        value = ac.critic(features.detach())
        loss_critic = (0.5 * (value_target.detach() - value[:-1]).square() * weight).mean()

        head = ACTOR_HEADS[c["actor_dist"]][0]
        if c["actor_grad"] == "reinforce":
            policy = head(ac.actor(features[:-1].detach()))
            loss_policy = -policy.log_prob(actions.detach()) * advantage_gae.detach()
        else:
            policy = head(ac.actor(features[:-1]))
            loss_policy = -value_target
        loss_actor = ((loss_policy - c["entropy"] * policy.entropy()) * weight).mean()
        return loss_actor, loss_critic


def param_groups(model: Model) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
    """The trainable parameters, named, by the loss that trains them."""
    groups: Dict[str, List] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        top = name.split(".")[0]
        group = top if top in ("wm", "probe") else name.split(".")[1]
        groups[group].append((name, p))
    return groups


class TrainStep:
    """One gradient step: the critic-target copy every ``target_interval``
    steps before the update, one backward over the summed losses, each
    group's gradients clipped by their global norm (scaled by max/norm where
    the norm exceeds max), AdamW with weight decay 0."""

    def __init__(self, model: Model, c: Dict):
        self.model, self.c = model, c
        self.groups = param_groups(model)
        lr = {"wm": c["adam_lr"], "probe": c["adam_lr"], "actor": c["adam_lr_actor"],
              "critic": c["adam_lr_critic"]}
        self.clip = {"wm": c["grad_clip"], "probe": c["grad_clip"],
                     "actor": c["grad_clip_ac"], "critic": c["grad_clip_ac"]}
        self.optimizer = torch.optim.AdamW(
            [{"params": [p for _, p in self.groups[g]], "lr": lr[g]} for g in GROUPS],
            eps=c["adam_eps"], weight_decay=0.0, foreach=False)

    def __call__(self, obs, state, step: int, noise):
        """-> (state, losses and terms as floats, the clipped gradients by name)."""
        model = self.model
        if step % self.c["target_interval"] == 0:
            with torch.no_grad():
                for tgt, src in zip(model.ac.critic_target.parameters(),
                                    model.ac.critic.parameters()):
                    tgt.copy_(src)
        losses, state, terms = model.losses(obs, state, noise)
        self.optimizer.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        grads = {}
        for g in GROUPS:
            gs = []
            for name, p in self.groups[g]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                gs.append(p.grad)
            norm = torch.stack([x.square().sum() for x in gs]).sum().sqrt()
            if norm > self.clip[g]:
                for x in gs:
                    x.mul_(self.clip[g] / norm)
            grads.update({name: p.grad.detach().clone() for name, p in self.groups[g]})
        self.optimizer.step()
        readings = {k: float(v.detach()) for k, v in losses.items()}
        readings.update({k: float(v) for k, v in terms.items()})
        return state, readings, grads
