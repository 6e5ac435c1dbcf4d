"""The plain reference of the DreamerV3 train step, in float32.

What the benchmark holds the program's ``TrainStep`` against under
``model: dreamerv3``. It follows DreamerV3 (Hafner et al. 2023, *Mastering
Diverse Domains through World Models*, arXiv:2301.04104 v1) and the
``configs.yaml`` of its code's first release (github.com/danijar/dreamerv3),
with N = T*B rows and feat = [h; z]:

* encoder: x = image/255 - 0.5, then 4 x [Conv k4 s2 SAME (no bias) ->
  LayerNorm over the channels -> SiLU], channels d, 2d, 4d, 8d, down to 4x4,
  flattened in (H, W, C) order;
* RSSM: at a reset the carried (h, z) become the initial state, h0 =
  tanh(w0) and z0 = the mode of the prior at h0, and the action is zeroed;
  x = SiLU(LN(W [z; a])), h' = GRU(x, h) (one LayerNorm over the 3H gates,
  update bias -1, the reset applied to the candidate after the norm),
  prior = W SiLU(LN(W h')), posterior = W SiLU(LN(W [h'; e])); each latent's
  probabilities 0.99 softmax + 0.01 / K, sampled straight-through from
  argmax(log p + gumbel);
* heads on feat: the decoder, Dense(8d*4*4) reshaped (4, 4, 8d), then
  transposed convs k4 s2 SAME with LN and SiLU on all but the last, plus
  0.5, its loss the squared error summed over the pixels against image/255;
  the reward head, 5 x [Linear -> LN -> SiLU] -> 255 logits of a two-hot
  symlog distribution on linspace(-20, 20, 255); the continue head, a
  Bernoulli on 1 - terminal;
* KL: 0.5 max(1, KL[sg(post) || prior]) + 0.1 max(1, KL[post || sg(prior)]),
  each summed over the latents; the world model's loss is the mean over N of
  image + reward + continue + KL;
* the dream: H steps through the prior from all N posterior states (sg),
  the world model frozen, the actor on sg(feat) with 1% uniform mix;
  r = the reward head's mean, c = the continue head's mode with c_0 = 1 -
  the start's terminal, weights w_t = prod_{i<=t}(gamma c_i) / gamma;
* critic (two-hot, 255 bins) and returns: R_H = v_H, R_t = r_{t+1} + gamma
  c_{t+1} ((1 - lambda) v_{t+1} + lambda R_{t+1}) with v the online critic's
  mean; the 5th and 95th percentiles of R (linear interpolation) feed EMAs
  (decay 0.99) kept from step to step; adv = (R - v) / max(1, hi - lo);
  actor loss mean_t<H w_t (-log pi(a_t) sg(adv_t) - entropy H[pi]); critic
  loss mean_t<H w_t (-log p(sg R_t) - log p(sg slow_t)), slow_t the slow
  critic's mean; after each update slow <- 0.98 slow + 0.02 critic;
* Adam without weight decay, each group clipped by its global norm: the
  world model at ``adam_lr``, ``adam_eps``, ``grad_clip``; the actor and the
  critic at their rates, ``adam_eps_ac``, ``grad_clip_ac``.

Departures from the published description, and what the source leaves open:

* the GRU's gate columns are in (reset, update, candidate) order, K1's; the
  source's are (reset, candidate, update): a permutation of the same
  parameters, taken so that one weight dict loads into both sides;
* the input layer of the RSSM is two Linear maps summed (``z_mlp`` on z,
  ``a_mlp`` on a), which is one Linear on [z; a]; likewise the posterior's
  ``post_mlp_h`` and ``post_mlp_e`` on [h; e];
* the source starts its slow critic from an init of its own and copies it
  whole at its first update; here it starts as a copy of the critic
  (``critic_target``), so every update, the first too, is the EMA;
* the return statistics start from the weights handed in (the buffer
  ``ac.retnorm.stats`` = (lo, hi)), not from zeros, so that both sides take
  the benchmark's seeded draw alike;
* the carried action of the source (the last action of the previous batch)
  is not kept: the batch's own action of step t enters with its frame, as
  pydreamer feeds them;
* the initial state's mode is taken in float32 in every precision: the
  two products of the prior at h0 (one row) take no ``cast``, as the
  program computes them in float32. At a random init the prior's logits
  there lie within 1e-3 of each other, so rounding them to bfloat16 picks
  another mode on about a quarter of the seeds, and the comparison of
  gradients would then hold two different initial states against each
  other, not two roundings of one (the feed's margin on the gumbel noise
  keeps the samples from flipping likewise);
* the ``none`` probe's one parameter (loss = its square) rides along, as
  the program has it;
* precision: the source computes in 16-bit floats; this reference in
  float32 with TF32 off, the program in bfloat16 over float32 weights.

It is plain ``torch``: no kernel, no cache, no batching trick, no mixed
precision. It imports nothing of the program; the parameter names are the
program's ``state_dict`` names, so one weight dict loads into both. Run it
with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False): the caller sets them.

The benchmark finds this module by the configuration's ``model`` key and
uses ``Model(conf, cast)`` with its ``init_state`` and ``TrainStep(model,
conf)``. ``cast`` is applied to both operands of every matrix product and
convolution but the initial state's two (above). The identity gives the
reference; a rounding to a lower precision gives the control that the
comparison has to fail.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Model", "TrainStep", "GROUPS", "identity", "twohot", "symlog", "symexp"]

LN_EPS = 1e-3
GROUPS = ("wm", "probe", "actor", "critic")
BINS, BINS_LOW, BINS_HIGH = 255, -20.0, 20.0
UNIMIX = 0.01
KL_FREE, KL_DYN, KL_REP = 1.0, 0.5, 0.1
RETNORM_DECAY, RETNORM_LOW, RETNORM_HIGH = 0.99, 0.05, 0.95
SLOW_FRACTION = 0.02


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Linear(nn.Module):
    """y = cast(x) @ cast(W).T (+ b)."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True, cast: Callable = identity):
        super().__init__()
        self.cast = cast
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x):
        return F.linear(self.cast(x), self.cast(self.weight), self.bias)


class Norm(nn.Module):
    """LayerNorm over the last axis, eps 1e-3, with a scale and an offset."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, LN_EPS)


def channel_norm(norm: Norm, x):
    """``norm`` over the channels of an NCHW tensor."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MLP(nn.Module):
    """[Linear (no bias) -> LayerNorm -> SiLU] x layers -> Linear; a width-1
    output is squeezed."""

    def __init__(self, n_in: int, n_out: int, hidden: int, layers: int, cast: Callable):
        super().__init__()
        self.layers, self.n_out = layers, n_out
        dims = [n_in] + [hidden] * layers
        for i in range(layers):
            self.add_module(f"Dense_{i}", Linear(dims[i], hidden, bias=False, cast=cast))
            self.add_module(f"Norm_{i}", Norm(hidden))
        self.add_module(f"Dense_{layers}", Linear(dims[-1], n_out, cast=cast))

    def forward(self, x):
        for i in range(self.layers):
            x = F.silu(getattr(self, f"Norm_{i}")(getattr(self, f"Dense_{i}")(x)))
        x = getattr(self, f"Dense_{self.layers}")(x)
        return x.squeeze(-1) if self.n_out == 1 else x


# -- distributions --------------------------------------------------------

def symlog(x):
    return torch.sign(x) * torch.log(1.0 + x.abs())


def symexp(x):
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


def make_bins(n: int, device=None):
    return torch.linspace(BINS_LOW, BINS_HIGH, n, device=device)


def twohot(x, n: int):
    """(..., n) weights of x (in symlog space) on the two bins around it, by
    its fractional position; clipped to the end bins."""
    step = (BINS_HIGH - BINS_LOW) / (n - 1)
    pos = (x.clamp(BINS_LOW, BINS_HIGH) - BINS_LOW) / step
    lo = pos.floor().clamp(0, n - 2)
    frac = (pos - lo).unsqueeze(-1)
    lo = lo.long()
    return F.one_hot(lo, n) * (1.0 - frac) + F.one_hot(lo + 1, n) * frac


def twohot_mean(logits):
    bins = make_bins(logits.shape[-1], logits.device)
    return symexp((torch.softmax(logits, -1) * bins).sum(-1))


def twohot_log_prob(logits, x):
    """log p(x) of the two-hot symlog head: the cross-entropy of its
    log-softmax against twohot(symlog(x))."""
    return (twohot(symlog(x), logits.shape[-1]) * torch.log_softmax(logits, -1)).sum(-1)


def unimix_log_probs(logits, unimix: float):
    probs = (1.0 - unimix) * torch.softmax(logits, -1) + unimix / logits.shape[-1]
    return torch.log(probs)


def onehot_sample(logp, gumbel):
    return F.one_hot(torch.argmax(logp + gumbel, -1), logp.shape[-1]).float()


def onehot_rsample(logp, gumbel):
    """Straight-through: the one-hot sample forward, the probabilities' gradient."""
    probs = logp.exp()
    return onehot_sample(logp, gumbel) + (probs - probs.detach())


def kl(logp, logq):
    return (logp.exp() * (logp - logq)).sum(-1)


# -- the world model --------------------------------------------------------

class ConvEncoder(nn.Module):
    def __init__(self, channels: int, depth: int, cast: Callable):
        super().__init__()
        self.cast = cast
        chans = (channels, depth, 2 * depth, 4 * depth, 8 * depth)
        for i in range(4):
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.empty(chans[i + 1], chans[i], 4, 4))
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"Norm_{i}", Norm(chans[i + 1]))

    def forward(self, image):  # (N, H, W, C) -> (N, (H/16)(W/16) 8d), in (H, W, C) order
        x = image.permute(0, 3, 1, 2)
        for i in range(4):
            conv = getattr(self, f"conv_{i}")
            x = F.conv2d(self.cast(x), self.cast(conv.weight), None, stride=2, padding=1)
            x = F.silu(channel_norm(getattr(self, f"Norm_{i}"), x))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ConvDecoder(nn.Module):
    def __init__(self, n_in: int, channels: int, depth: int, size: int, cast: Callable):
        super().__init__()
        self.cast, self.depth, self.minres = cast, depth, size // 16
        self.Dense_0 = Linear(n_in, self.minres ** 2 * 8 * depth, cast=cast)
        chans = (8 * depth, 4 * depth, 2 * depth, depth, channels)
        for i in range(4):
            deconv = nn.Module()
            deconv.weight = nn.Parameter(torch.empty(chans[i], chans[i + 1], 4, 4))
            if i == 3:
                deconv.bias = nn.Parameter(torch.empty(chans[i + 1]))
            else:
                deconv.bias = None
                self.add_module(f"Norm_{i}", Norm(chans[i + 1]))
            self.add_module(f"deconv_{i}", deconv)

    def forward(self, features):  # (N, F) -> (N, H, W, C), the mean image in [0, 1] space
        N = features.shape[0]
        x = self.Dense_0(features).reshape(N, self.minres, self.minres, 8 * self.depth)
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            deconv = getattr(self, f"deconv_{i}")
            x = F.conv_transpose2d(self.cast(x), self.cast(deconv.weight), deconv.bias, stride=2,
                                   padding=1)
            if i < 3:
                x = F.silu(channel_norm(getattr(self, f"Norm_{i}"), x))
        return x.permute(0, 2, 3, 1) + 0.5


class Head(nn.Module):
    def __init__(self, n_in: int, n_out: int, c, layers: int, cast: Callable):
        super().__init__()
        self.model = MLP(n_in, n_out, c["mlp_units"], layers, cast)


class Decoder(nn.Module):
    def __init__(self, c, features: int, cast: Callable):
        super().__init__()
        self.image = ConvDecoder(features, c["image_channels"], c["cnn_depth"], c["image_size"],
                                 cast)
        self.reward = Head(features, BINS, c, c["reward_decoder_layers"], cast)
        self.terminal = Head(features, 1, c, c["terminal_decoder_layers"], cast)


class Encoder(nn.Module):
    def __init__(self, c, cast: Callable):
        super().__init__()
        self.ConvEncoder_0 = ConvEncoder(c["image_channels"], c["cnn_depth"], cast)


class GRUCell(nn.Module):
    """The late-reset GRU cell with one LayerNorm over the 3H gates, unfused."""

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
        reset, update, cand = gates.chunk(3, -1)
        cand = torch.tanh(torch.sigmoid(reset) * cand)
        update = torch.sigmoid(update - 1.0)
        return update * cand + (1.0 - update) * h


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
        self.initial = nn.Parameter(torch.empty(D))
        self.z_mlp = Linear(Z, hid, bias=False, cast=cast)
        self.a_mlp = Linear(c["action_dim"], hid, bias=False, cast=cast)
        self.in_norm = Norm(hid)
        self.gru = GRUStack(hid, D, cast)
        self.prior_mlp_h = Linear(D, hid, bias=False, cast=cast)
        self.prior_norm = Norm(hid)
        self.prior_mlp = Linear(hid, Z, cast=cast)
        self.post_mlp_h = Linear(D, hid, bias=False, cast=cast)
        self.post_mlp_e = Linear(embed, hid, bias=False, cast=cast)
        self.post_norm = Norm(hid)
        self.post_mlp = Linear(hid, Z, cast=cast)

    def logp(self, x):  # (..., S*K) -> the latents' unimixed log-probabilities (..., S, K)
        return unimix_log_probs(x.reshape(x.shape[:-1] + (self.S, self.K)), UNIMIX)

    def img_step(self, h, z, action):
        x = F.silu(self.in_norm(self.z_mlp(z) + self.a_mlp(action)))
        return self.gru.cell_0(x, h)

    def prior(self, h):
        return self.prior_mlp(F.silu(self.prior_norm(self.prior_mlp_h(h))))

    def post(self, h, embed):
        return self.post_mlp(F.silu(self.post_norm(self.post_mlp_h(h) + self.post_mlp_e(embed))))

    def sample(self, stats, gumbel):
        return onehot_rsample(self.logp(stats), gumbel).reshape(stats.shape[0], -1)

    def initial_state(self):
        """(h0, z0) of one row: tanh(w0) and the prior's mode at it, whose two
        products take no ``cast`` (the module docstring)."""
        h0 = torch.tanh(self.initial).unsqueeze(0)
        hid, out = self.prior_mlp_h, self.prior_mlp
        x = F.silu(self.prior_norm(F.linear(h0, hid.weight, hid.bias)))
        logits = F.linear(x, out.weight, out.bias)
        z0 = F.one_hot(self.logp(logits).argmax(-1), self.K).float().reshape(1, -1)
        return h0, z0


class Core(nn.Module):
    def __init__(self, c, embed: int, cast: Callable):
        super().__init__()
        self.cell = RSSMCell(c, embed, cast)


class WorldModel(nn.Module):
    def __init__(self, c, cast: Callable):
        super().__init__()
        features = c["deter_dim"] + c["stoch_dim"] * c["stoch_discrete"]
        embed = (c["image_size"] // 16) ** 2 * 8 * c["cnn_depth"]
        self.encoder = Encoder(c, cast)
        self.decoder = Decoder(c, features, cast)
        self.core = Core(c, embed, cast)


class ReturnStats(nn.Module):
    """The EMAs (lo, hi) of the returns' percentiles, carried from step to step."""

    def __init__(self):
        super().__init__()
        self.register_buffer("stats", torch.empty(2))


class ActorCritic(nn.Module):
    def __init__(self, c, features: int, cast: Callable):
        super().__init__()
        units, layers, bins = c["mlp_units"], c["actor_critic_layers"], BINS
        self.critic = MLP(features, bins, units, layers, cast)
        self.critic_target = MLP(features, bins, units, layers, cast)
        self.actor = MLP(features, c["action_dim"], units, layers, cast)
        self.retnorm = ReturnStats()


class Probe(nn.Module):
    """The ``none`` probe: one parameter, loss = its square."""

    def __init__(self):
        super().__init__()
        self.dummy = nn.Parameter(torch.empty(1))


def lambda_returns(reward1, value, cont1, gamma: float, lam: float):
    """R_H = v_H; R_t = r_{t+1} + gamma c_{t+1} ((1 - lam) v_{t+1} + lam R_{t+1})."""
    out, nxt = [None] * reward1.shape[0], value[-1]
    for t in range(reward1.shape[0] - 1, -1, -1):
        nxt = reward1[t] + gamma * cont1[t] * ((1.0 - lam) * value[t + 1] + lam * nxt)
        out[t] = nxt
    return torch.stack(out)


class Model(nn.Module):
    """World model, actor-critic and the ``none`` probe, as plain modules."""

    def __init__(self, c: Dict, cast: Callable = identity):
        super().__init__()
        if c["iwae_samples"] != 1 or c["gru_layers"] != 1 or c["image_encoder"] != "cnn" \
                or c["actor_grad"] != "reinforce" or c["actor_dist"] != "onehot":
            raise NotImplementedError("the reference covers iwae_samples 1, one GRU layer, "
                                      "the CNN encoder and decoder, a one-hot reinforce actor")
        self.c = c
        features = c["deter_dim"] + c["stoch_dim"] * c["stoch_discrete"]
        self.wm = WorldModel(c, cast)
        self.ac = ActorCritic(c, features, cast)
        self.probe = Probe()
        self.ac.critic_target.requires_grad_(False)

    def init_state(self, batch_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The learned initial state (h0, z0) of ``batch_size`` columns."""
        with torch.no_grad():
            h0, z0 = self.wm.core.cell.initial_state()
        return (h0.to(device).repeat(batch_size, 1), z0.to(device).repeat(batch_size, 1))

    def losses(self, obs, state, noise) -> Tuple[Dict[str, torch.Tensor], Tuple, Dict]:
        """One forward: the four losses, the TBTT state to carry, the
        world model's loss terms (detached)."""
        c, wm, cell = self.c, self.wm, self.wm.core.cell
        image = obs["image"].float() / 255.0
        T, B = obs["action"].shape[:2]
        S, K = c["stoch_dim"], c["stoch_discrete"]

        embed = wm.encoder.ConvEncoder_0((image - 0.5).reshape((T * B,) + image.shape[2:]))
        embed = embed.reshape(T, B, -1)
        gumbel = noise.draw("posterior_z", (T, B, S, K), "gumbel")
        keep = (~obs["reset"].bool()).float().unsqueeze(-1)
        h0, z0 = cell.initial_state()
        h, z = state
        posts, hs, zs = [], [], []
        for t in range(T):
            h = h * keep[t] + h0 * (1.0 - keep[t])
            z = z * keep[t] + z0 * (1.0 - keep[t])
            h = cell.img_step(h, z, obs["action"][t] * keep[t])
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
        loss_image = (decoded - image).square().sum((-1, -2, -3))
        loss_reward = -twohot_log_prob(decoder.reward.model(features), obs["reward"])
        logit_c = decoder.terminal.model(features)
        cont = 1.0 - obs["terminal"]
        loss_cont = -(cont * logit_c - F.softplus(logit_c))

        lpost, lprior = cell.logp(posts), cell.logp(priors)
        dyn = kl(lpost.detach(), lprior).sum(-1).clamp(min=KL_FREE)
        rep = kl(lpost, lprior.detach()).sum(-1).clamp(min=KL_FREE)
        loss_kl = KL_DYN * dyn + KL_REP * rep
        loss_model = (loss_image + loss_reward + loss_cont + loss_kl).mean()
        terms = dict(loss_image=loss_image.mean(), loss_reward=loss_reward.mean(),
                     loss_terminal=loss_cont.mean(), loss_kl=loss_kl.mean())

        start = (hs.detach().reshape(T * B, -1), zs.detach().reshape(T * B, -1))
        with torch.no_grad():
            dream = self.dream(start, noise, obs["terminal"].reshape(T * B))
        loss_actor, loss_critic = self.actor_critic(*dream)
        losses = dict(loss_model=loss_model, loss_probe=self.probe.dummy.square().sum(),
                      loss_actor=loss_actor, loss_critic=loss_critic)
        return losses, (h.detach(), z.detach()), {k: v.detach() for k, v in terms.items()}

    def actor_logp(self, features):
        return unimix_log_probs(self.ac.actor(features), UNIMIX)

    def dream(self, state, noise, start_terminal):
        """H steps through the prior under the policy, without a gradient."""
        c, wm, cell = self.c, self.wm, self.wm.core.cell
        h, z = state
        M, A = h.shape[0], c["action_dim"]
        features, actions = [], []
        for t in range(c["imag_horizon"]):
            feature = torch.cat([h, z], -1)
            eps = noise.draw("dream_action", (M, A), "gumbel", t)
            action = onehot_sample(self.actor_logp(feature), eps)
            gumbel = noise.draw("dream_z", (M, c["stoch_dim"], c["stoch_discrete"]), "gumbel", t)
            h = cell.img_step(h, z, action)
            z = onehot_sample(cell.logp(cell.prior(h)), gumbel).reshape(M, -1)
            features.append(feature)
            actions.append(action)
        features.append(torch.cat([h, z], -1))
        features, actions = torch.stack(features), torch.stack(actions)
        rewards = twohot_mean(wm.decoder.reward.model(features))
        cont = (wm.decoder.terminal.model(features) > 0).float()
        cont = torch.cat([1.0 - start_terminal.float()[None], cont[1:]])
        return features, actions, rewards, cont

    def actor_critic(self, features, actions, rewards, cont):
        c, ac = self.c, self.ac
        gamma = c["gamma"]
        logits = ac.critic(features)
        value = twohot_mean(logits).detach()
        slow = twohot_mean(ac.critic_target(features[:-1])).detach()
        ret = lambda_returns(rewards[1:], value, cont[1:], gamma, c["lambda_gae"])
        weight = torch.cumprod(gamma * cont, 0) / gamma
        stats = ac.retnorm.stats
        now = torch.stack([torch.quantile(ret, RETNORM_LOW), torch.quantile(ret, RETNORM_HIGH)])
        stats.copy_(RETNORM_DECAY * stats + (1.0 - RETNORM_DECAY) * now)
        advantage = (ret - value[:-1]) / torch.clamp(stats[1] - stats[0], min=1.0)

        logp = self.actor_logp(features[:-1])
        logpi = (logp * actions).sum(-1)
        entropy = -(logp.exp() * logp).sum(-1)
        loss_actor = (weight[:-1] * (-logpi * advantage.detach() - c["entropy"] * entropy)).mean()
        loss_critic = -twohot_log_prob(logits[:-1], ret) - twohot_log_prob(logits[:-1], slow)
        loss_critic = (weight[:-1] * loss_critic).mean()
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
    """One gradient step: one backward over the summed losses, each group's
    gradients clipped by their global norm (scaled by max/norm where the
    norm exceeds max), Adam with each group's rate and eps, then the slow
    critic's EMA."""

    def __init__(self, model: Model, c: Dict):
        self.model, self.c = model, c
        self.groups = param_groups(model)
        lr = {"wm": c["adam_lr"], "probe": c["adam_lr"], "actor": c["adam_lr_actor"],
              "critic": c["adam_lr_critic"]}
        eps_ac = c["adam_eps_ac"] or c["adam_eps"]
        eps = {"wm": c["adam_eps"], "probe": c["adam_eps"], "actor": eps_ac, "critic": eps_ac}
        self.clip = {"wm": c["grad_clip"], "probe": c["grad_clip"],
                     "actor": c["grad_clip_ac"], "critic": c["grad_clip_ac"]}
        self.optimizer = torch.optim.Adam(
            [{"params": [p for _, p in self.groups[g]], "lr": lr[g], "eps": eps[g]}
             for g in GROUPS], foreach=False)

    def __call__(self, obs, state, step: int, noise):
        """-> (state, losses and terms as floats, the clipped gradients by name)."""
        model = self.model
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
        with torch.no_grad():
            for slow, p in zip(model.ac.critic_target.parameters(), model.ac.critic.parameters()):
                slow.copy_((1.0 - SLOW_FRACTION) * slow + SLOW_FRACTION * p)
        readings = {k: float(v.detach()) for k, v in losses.items()}
        readings.update({k: float(v) for k, v in terms.items()})
        return state, readings, grads
