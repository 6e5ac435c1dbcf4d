"""RSSM (Recurrent State-Space Model) core.

Counterpart of ``pydreamer_tpu/models/rssm.py``. The JAX package runs the
time axis as one ``lax.scan``; here it is a Python loop over T that calls the
GRU cell (kernel K1 for ``gru_layernorm_dv2``) once per step. Priors are
computed batched over all T states after the loop (``batch_prior``).

Latent layout: state ``(h, z)`` with h = deterministic GRU state (B,D) and
z = stochastic sample (B, S*K). Features = concat(h, z).

Reset handling: ``reset[t]`` zeroes the *incoming* state at step t
(rssm.py:108-116). With ``initial: learned`` (DreamerV3) it replaces the
incoming state by the learned initial state, h0 = tanh(w0) and z0 the mode
of the prior at h0, and zeroes the incoming action.

DreamerV3's options, all fixed at construction (``act``, ``unimix``,
``norm_bias``, ``initial``): SiLU for ELU, the latents' probabilities mixed
1% with the uniform, no bias on the Dense layers that a LayerNorm follows,
the learned initial state.

``BlockRSSMCell`` is the cell of DreamerV3's second release (``model:
dreamerv3_blocks``; github.com/danijar/dreamerv3, 2024, ``RSSM``): three
input layers, a block-diagonal GRU core of ``blocks`` blocks with a hidden
layer inside (kernel K2, ``ops/block_gru.py``), the posterior and prior
layers, RMSNorm, and a zero initial state: a reset zeroes h, z and the
action.

The T loop runs inside ``ops.gru_dv2.dw_batches()``: a K1 cell whose weights
take a gradient sums its weight gradient once over the loop (``DWBatch``).

Sampling noise comes in as a tensor (standard gumbel for discrete latents,
standard normal otherwise), never as a key: the posterior loop takes the
whole (T, B*I, S, K) block, drawn up front by the caller.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .distributions import DiagNormal, OneHotCategorical, diag_normal
from .functions import expand_iwae
from ..ops.block_gru import block_gru
from ..ops.gru_dv2 import dw_batches
from .modules import ACTIVATIONS, Dense, Norm, cast_param, layer_norm
from .rnn import GRUCellStack

__all__ = ["RSSMCell", "BlockRSSMCell", "BlockLinear", "RSSMCore", "init_state", "to_feature",
           "feature_replace_z", "z_noise_shape", "z_noise_kind", "INITIAL_STATES"]

INITIAL_STATES = ("zeros", "learned")

State = Tuple[torch.Tensor, torch.Tensor]  # (h: (B,D), z: (B,S*K))


def init_state(batch_size: int, deter_dim: int, stoch_dim: int, stoch_discrete: int,
               *, device: torch.device | str) -> State:
    """Zero (h, z) state on ``device`` (no default: a state silently made on
    the CPU would send the model's next step there)."""
    return (
        torch.zeros((batch_size, deter_dim), dtype=torch.float32, device=device),
        torch.zeros((batch_size, stoch_dim * (stoch_discrete or 1)), dtype=torch.float32,
                    device=device),
    )


def to_feature(h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.cat([h, z], -1)


def feature_replace_z(features: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Swap the stochastic part of features (decoding from prior samples)."""
    h = features[..., : features.shape[-1] - z.shape[-1]]
    return torch.cat([h, z], -1)


def z_noise_kind(stoch_discrete: int) -> str:
    """The noise the latent distribution samples from (``NOISE`` of its class)."""
    return OneHotCategorical.NOISE if stoch_discrete else DiagNormal.NOISE


def z_noise_shape(prefix: Tuple[int, ...], stoch_dim: int, stoch_discrete: int) -> Tuple[int, ...]:
    """Shape of the latent noise for ``prefix`` states (rssm.py:52-65)."""
    return tuple(prefix) + ((stoch_dim, stoch_discrete) if stoch_discrete else (stoch_dim,))


class RSSMCell(nn.Module):
    """One RSSM step: (h,z) + action [+ embed] -> new (h,z) and post/prior stats."""

    def __init__(self, embed_dim: int, action_dim: int, deter_dim: int, stoch_dim: int,
                 stoch_discrete: int, hidden_dim: int, gru_layers: int = 1,
                 gru_type: str = "gru", layer_norm: bool = True, dtype=torch.float32,
                 act: str = "elu", unimix: float = 0.0, norm_bias: bool = True,
                 initial: str = "zeros"):
        super().__init__()
        if initial not in INITIAL_STATES:
            raise ValueError(f"unknown initial state {initial!r}; options: {INITIAL_STATES}")
        if initial == "learned" and not stoch_discrete:
            raise ValueError("the learned initial state takes discrete latents")
        self.stoch_dim = stoch_dim
        self.stoch_discrete = stoch_discrete
        self.compute_dtype = dtype
        self.act = ACTIVATIONS[act]
        self.unimix = unimix
        z_dim = stoch_dim * (stoch_discrete or 1)
        out_stoch = stoch_dim * (stoch_discrete or 2)
        self.z_mlp = Dense(z_dim, hidden_dim, bias=norm_bias, dtype=dtype)
        self.a_mlp = Dense(action_dim, hidden_dim, bias=False, dtype=dtype)
        self.in_norm = Norm(hidden_dim, layer_norm, dtype=dtype)
        self.gru = GRUCellStack(hidden_dim, deter_dim, gru_layers, gru_type, dtype=dtype)
        self.prior_mlp_h = Dense(deter_dim, hidden_dim, bias=norm_bias, dtype=dtype)
        self.prior_norm = Norm(hidden_dim, layer_norm, dtype=dtype)
        self.prior_mlp = Dense(hidden_dim, out_stoch, dtype=dtype)
        self.post_mlp_h = Dense(deter_dim, hidden_dim, bias=norm_bias, dtype=dtype)
        self.post_mlp_e = Dense(embed_dim, hidden_dim, bias=False, dtype=dtype)
        self.post_norm = Norm(hidden_dim, layer_norm, dtype=dtype)
        self.post_mlp = Dense(hidden_dim, out_stoch, dtype=dtype)
        self.initial = nn.Parameter(torch.zeros(deter_dim)) if initial == "learned" else None

    # -- pieces -----------------------------------------------------------

    def initial_state(self, batch_size: int) -> State:
        """The learned initial state of ``batch_size`` rows: h0 = tanh(w0) and
        z0 the mode of the prior at h0 (no gradient through the mode). The
        mode's one row is computed in float32 whatever the compute dtype:
        the prior's logits at h0 can lie closer together than bfloat16
        resolves (within 1e-3 at a random init), and rounding would pick the
        mode."""
        h0 = torch.tanh(self.initial).unsqueeze(0)
        with torch.no_grad():
            x = F.linear(h0, self.prior_mlp_h.weight, self.prior_mlp_h.bias)
            if self.prior_norm.enabled:
                x = layer_norm(x, self.prior_norm.weight, self.prior_norm.bias, torch.float32,
                               self.prior_norm.eps)
            x = F.linear(self.act(x), self.prior_mlp.weight, self.prior_mlp.bias)
            logits = self.zdistr(x).logits
        z0 = F.one_hot(logits.argmax(-1), self.stoch_discrete).float().reshape(1, -1)
        return h0.expand(batch_size, -1), z0.expand(batch_size, -1)

    def _gru_step(self, action, in_state: State, reset_mask, initial=None) -> torch.Tensor:
        h, z = in_state
        if reset_mask is not None:
            h = h * reset_mask
            z = z * reset_mask
            if initial is not None:
                h = h + initial[0] * (1.0 - reset_mask)
                z = z + initial[1] * (1.0 - reset_mask)
                action = action * reset_mask
        x = self.z_mlp(z) + self.a_mlp(action.to(self.compute_dtype))
        za = self.act(self.in_norm(x))
        return self.gru(za, h.to(self.compute_dtype)).float()

    def _post_stats(self, h, embed) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.post_mlp_h(h.to(dt)) + self.post_mlp_e(embed.to(dt))
        return self.post_mlp(self.act(self.post_norm(x))).float()

    def _prior_stats(self, h) -> torch.Tensor:
        x = self.prior_mlp_h(h.to(self.compute_dtype))
        return self.prior_mlp(self.act(self.prior_norm(x))).float()

    def zdistr(self, pp: torch.Tensor):
        if self.stoch_discrete:
            logits = pp.reshape(pp.shape[:-1] + (self.stoch_dim, self.stoch_discrete))
            return OneHotCategorical(logits, event_dims=1, unimix=self.unimix)
        return diag_normal(pp)

    # -- steps ------------------------------------------------------------

    def post_step(self, in_state: State, embed, action, reset_mask, z_noise, initial=None):
        h = self._gru_step(action, in_state, reset_mask, initial)
        post = self._post_stats(h, embed)
        z = self.zdistr(post).rsample_noise(z_noise).reshape(h.shape[0], -1)
        return post, (h, z)

    def prior_step(self, in_state: State, action, reset_mask, z_noise, initial=None):
        h = self._gru_step(action, in_state, reset_mask, initial)
        prior = self._prior_stats(h)
        z = self.zdistr(prior).rsample_noise(z_noise).reshape(h.shape[0], -1)
        return prior, (h, z)

    def batch_prior(self, h: torch.Tensor) -> torch.Tensor:
        return self._prior_stats(h)


class BlockLinear(nn.Module):
    """``blocks`` Linear maps side by side, stored as the products read them:
    ``weight`` (in, blocks * out), block g's map in columns [g out, (g+1)
    out), each Xavier-uniform over its own fan-in and fan-out; ``bias``
    (blocks * out), zero. The source's ``BlockLinear`` kernel (blocks, in,
    out) holds the same numbers, permuted."""

    def __init__(self, in_features: int, out_features: int, blocks: int):
        super().__init__()
        per_block = out_features // blocks
        bound = math.sqrt(6.0 / (in_features + per_block))
        self.weight = nn.Parameter(torch.empty(in_features, out_features).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(out_features))


class BlockRSSMCell(nn.Module):
    """One step of DreamerV3's second-release RSSM, with D = ``deter_dim``
    units in ``blocks`` blocks of Hb and ``hidden_dim`` = hid:

      x_i = act(norm(dynin_i(v_i)))  for v = (h, z, a / max(1, |a|))    (hid each)
      h'  = K2(h, [x_0; x_1; x_2])   (``ops/block_gru.py``: dynhid, its RMSNorm
                                      and act, dyngru, the gates)
      post  = obslogit(act(norm(obs0([h'; embed]))))
      prior = imglogit(act(norm(img_{L-1}(... act(norm(img_0(h'))) ...))))

    Every norm is RMSNorm; the latents are 1% uniform-mixed (``unimix``). The
    initial state is zeros (``initial`` is None) and a reset zeroes h, z and
    the action. The source's one hidden layer in the core (dynlayers) is K2's
    structure, and its prior's ``IMG_LAYERS`` (imglayers) are fixed here."""

    IMG_LAYERS = 2

    def __init__(self, embed_dim: int, action_dim: int, deter_dim: int, stoch_dim: int,
                 stoch_discrete: int, hidden_dim: int, blocks: int, dtype=torch.float32,
                 act: str = "silu", unimix: float = 0.0):
        super().__init__()
        if not stoch_discrete or deter_dim % blocks:
            raise ValueError("the block cell takes discrete latents and deter_dim divisible by "
                             "rssm_blocks")
        self.stoch_dim = stoch_dim
        self.stoch_discrete = stoch_discrete
        self.compute_dtype = dtype
        self.act = ACTIVATIONS[act]
        self.unimix = unimix
        self.blocks = blocks
        self.initial = None
        z_dim = stoch_dim * stoch_discrete
        for i, n_in in enumerate((deter_dim, z_dim, action_dim)):
            self.add_module(f"dynin{i}", Dense(n_in, hidden_dim, dtype=dtype))
            self.add_module(f"dynin{i}_norm", Norm(hidden_dim, dtype=dtype, kind="rms"))
        self.dynhid = BlockLinear(deter_dim // blocks + 3 * hidden_dim, deter_dim, blocks)
        self.dynhid_norm = Norm(deter_dim, dtype=dtype, kind="rms")
        self.dyngru = BlockLinear(deter_dim // blocks, 3 * deter_dim, blocks)
        self.obs0 = Dense(deter_dim + embed_dim, hidden_dim, dtype=dtype)
        self.obs0_norm = Norm(hidden_dim, dtype=dtype, kind="rms")
        self.obslogit = Dense(hidden_dim, z_dim, dtype=dtype)
        for i in range(self.IMG_LAYERS):
            self.add_module(f"img{i}", Dense(deter_dim if i == 0 else hidden_dim, hidden_dim,
                                             dtype=dtype))
            self.add_module(f"img{i}_norm", Norm(hidden_dim, dtype=dtype, kind="rms"))
        self.imglogit = Dense(hidden_dim, z_dim, dtype=dtype)

    def _layer(self, name: str, x):
        return self.act(getattr(self, f"{name}_norm")(getattr(self, name)(x)))

    def _gru_step(self, action, in_state: State, reset_mask, initial=None) -> torch.Tensor:
        h, z = in_state
        if reset_mask is not None:
            h, z, action = h * reset_mask, z * reset_mask, action * reset_mask
        dt = self.compute_dtype
        action = action / action.abs().clamp(min=1.0).detach()
        x = torch.cat([self._layer(f"dynin{i}", v.to(dt)) for i, v in enumerate((h, z, action))],
                      -1)
        return block_gru(h.to(dt), x, cast_param(self.dynhid.weight, dt), self.dynhid.bias,
                         self.dynhid_norm.weight, cast_param(self.dyngru.weight, dt),
                         self.dyngru.bias, self.blocks, self.dynhid_norm.eps)

    def _post_stats(self, h, embed) -> torch.Tensor:
        dt = self.compute_dtype
        return self.obslogit(self._layer("obs0", torch.cat([h.to(dt), embed.to(dt)], -1))).float()

    def _prior_stats(self, h) -> torch.Tensor:
        x = h.to(self.compute_dtype)
        for i in range(self.IMG_LAYERS):
            x = self._layer(f"img{i}", x)
        return self.imglogit(x).float()

    zdistr = RSSMCell.zdistr
    post_step = RSSMCell.post_step
    prior_step = RSSMCell.prior_step
    batch_prior = RSSMCell.batch_prior


class RSSMCore(nn.Module):
    """T-step RSSM unroll (rssm.py:159-233). ``blocks`` > 0 takes
    ``BlockRSSMCell``, else ``RSSMCell`` (with ``options``)."""

    def __init__(self, embed_dim: int, action_dim: int, deter_dim: int, stoch_dim: int,
                 stoch_discrete: int, hidden_dim: int, gru_layers: int = 1,
                 gru_type: str = "gru", layer_norm: bool = True, dtype=torch.float32,
                 blocks: int = 0, **options):
        super().__init__()
        self.stoch_dim = stoch_dim
        self.stoch_discrete = stoch_discrete
        if blocks:
            self.cell = BlockRSSMCell(embed_dim, action_dim, deter_dim, stoch_dim, stoch_discrete,
                                      hidden_dim, blocks, dtype, act=options.get("act", "silu"),
                                      unimix=options.get("unimix", 0.0))
        else:
            self.cell = RSSMCell(embed_dim, action_dim, deter_dim, stoch_dim, stoch_discrete,
                                 hidden_dim, gru_layers, gru_type, layer_norm, dtype, **options)

    def forward(self,
                embed: torch.Tensor,     # (T,B,E)
                action: torch.Tensor,    # (T,B,A)
                reset: torch.Tensor,     # (T,B) bool
                in_state: State,         # ((B*I,D), (B*I,S*K))
                z_noise: torch.Tensor,   # (T,B*I,S,K) standard gumbel / (T,B*I,S) normal
                iwae_samples: int = 1,
                do_open_loop: bool = False):
        T, B = embed.shape[:2]
        I = iwae_samples
        embeds = expand_iwae(embed, I)
        actions = expand_iwae(action, I)
        reset_masks = expand_iwae((~reset.bool()).unsqueeze(-1).float(), I)

        posts, states_h, samples = [], [], []
        state = in_state
        initial = self.cell.initial_state(1) if self.cell.initial is not None else None
        with dw_batches():  # K1's dW summed once over the loop
            for t in range(T):
                if do_open_loop:
                    post, state = self.cell.prior_step(state, actions[t], reset_masks[t],
                                                       z_noise[t], initial)
                else:
                    post, state = self.cell.post_step(state, embeds[t], actions[t],
                                                      reset_masks[t], z_noise[t], initial)
                posts.append(post)
                states_h.append(state[0])
                samples.append(state[1])
        posts = torch.stack(posts)            # (T,BI,2S)
        states_h = torch.stack(states_h)      # (T,BI,D)
        samples = torch.stack(samples)        # (T,BI,S*K)

        priors = self.cell.batch_prior(states_h)
        features = to_feature(states_h, samples)

        fold = lambda x: x.reshape((T, B, I) + tuple(x.shape[2:]))
        states = (fold(states_h), fold(samples))
        out_state = (state[0].detach(), state[1].detach())
        return fold(priors), fold(posts), fold(samples), fold(features), states, out_state

    def prior_step(self, in_state: State, action, reset_mask, z_noise):
        return self.cell.prior_step(in_state, action, reset_mask, z_noise)

    def zdistr(self, pp):
        return self.cell.zdistr(pp)
