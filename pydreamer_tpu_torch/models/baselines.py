"""Baseline world models for probe evaluation (no actor-critic).

Counterparts of ``pydreamer_tpu/models/baselines.py``: ``GRUSequence``
(41-55), ``VAEWorldModel`` (58-140), ``GRUVAEWorldModel`` (143-216),
``TransformerVAEWorldModel`` (219-308), ``GRUEncoderOnly`` (311-355) and
``WorldModelProbe`` (366-404), which ``trainer.make_model`` builds for
``model != dreamer``. Submodule names follow the JAX params tree
(``wm/embedding/core/encoder/...``, ``wm/transformer/attn_0/query/...``), so
``convert.py`` maps them.

Noise (``models/noise.py``): the VAE draws ``embed_z``, the standard normal
of its posterior sample (T, B, I, S), and under ``do_image_pred``
``embed_pred_z``, that of its prior sample; the GRU and transformer models
draw the same two through their VAE and nothing else; ``gru_probe`` draws
none. Every baseline detaches the state it returns, as JAX does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import compute_dtype, resolve_device
from .decoders import DenseNormalDecoder, MultiDecoder
from .distributions import diag_normal
from .dreamer import prepare_obs
from .encoders import MultiEncoder
from .functions import insert_dim, logavgexp
from .modules import Dense, Norm
from .probes import make_probe
from .rnn import GRUCell

__all__ = ["WorldModelProbe", "VAEWorldModel", "GRUVAEWorldModel",
           "TransformerVAEWorldModel", "GRUEncoderOnly", "GRUSequence"]

TRANSFORMER_LN_EPS = 1e-5  # flax nn.LayerNorm's default, not the 1e-3 of Norm


def _multi_encoder(conf, dtype):
    return MultiEncoder(conf.image_encoder, conf.image_size, conf.image_channels, conf.cnn_depth,
                        conf.image_encoder_layers, conf.vecobs_size, conf.reward_input,
                        conv_impl=conf.get("conv_impl", "auto"), layer_norm=conf.layer_norm,
                        dtype=dtype)


def _reset_first(in_state: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Zero the state of the streams whose batch starts an episode; a reset
    later in the batch is not honoured (baselines.py:177-182). ``in_state``
    is (B*I, D), each stream's I samples next to each other."""
    mask = (~reset[0].bool()).to(in_state.dtype)
    return in_state * mask.repeat_interleave(in_state.shape[0] // mask.shape[0])[:, None]


def _pred_tensors(tensors):
    """The decoders' ``*_rec`` tensors renamed ``*_pred``."""
    return {k.replace("_rec", "_pred"): v for k, v in tensors.items() if k.endswith("_rec")}


class GRUSequence(nn.Module):
    """Single-layer plain GRU over (T,B,X), one cell step per t."""

    def __init__(self, input_size: int, hidden_size: int, dtype=torch.float32):
        super().__init__()
        self.GRUCell_0 = GRUCell(input_size, hidden_size, dtype=dtype)

    def forward(self, xs: torch.Tensor, in_state: torch.Tensor):
        h = in_state
        features = []
        for x in xs:
            h = self.GRUCell_0(x, h)
            features.append(h)
        return torch.stack(features).float(), h.float()


class _VAECore(nn.Module):
    """Encoder -> gaussian posterior MLP (Dense 256, ELU, Dense 2S)."""

    def __init__(self, conf, dtype):
        super().__init__()
        self.encoder = _multi_encoder(conf, dtype)
        self.Dense_0 = Dense(self.encoder.out_dim, 256, dtype=dtype)
        self.Dense_1 = Dense(256, 2 * conf.stoch_dim, dtype=dtype)

    def forward(self, obs):
        return self.Dense_1(F.elu(self.Dense_0(self.encoder(obs)))).float()


class VAEWorldModel(nn.Module):
    """Per-frame VAE: a fixed diag-normal prior (mean 0, std 1.1, the
    ``diag_normal`` of zeros), diag-normal posterior, multi-head decoder."""

    def __init__(self, conf, dtype):
        super().__init__()
        self.kl_weight = conf.kl_weight
        self.out_dim = conf.stoch_dim
        self.core = _VAECore(conf, dtype)
        self.decoder = MultiDecoder(
            conf.stoch_dim, conf.image_decoder, conf.image_size, conf.image_channels,
            conf.cnn_depth, conf.image_decoder_layers, conf.image_decoder_min_prob,
            conf.reward_decoder_layers, conf.terminal_decoder_layers,
            conf.reward_decoder_categorical, conf.vecobs_size,
            image_weight=conf.image_weight, vecobs_weight=conf.vecobs_weight,
            reward_weight=conf.reward_weight, terminal_weight=conf.terminal_weight,
            transpose_impl=conf.get("conv_transpose_impl", "auto"),
            layer_norm=conf.layer_norm, dtype=dtype)

    def init_state(self, batch_size: int, device) -> torch.Tensor:
        return torch.zeros(0, device=device)  # stateless

    def training_step(self, obs, in_state, noise, iwae_samples: int = 1,
                      do_open_loop=False, do_image_pred=False):
        post = insert_dim(self.core(obs), 2, iwae_samples)         # (T,B,I,2S)
        post_distr = diag_normal(post)
        z = post_distr.rsample_noise(noise.draw("embed_z", post_distr.loc.shape, "normal"))
        loss_reconstr, metrics, tensors = self.decoder(z, obs)

        prior_distr = diag_normal(torch.zeros_like(post))
        loss_kl = post_distr.kl_to(prior_distr)                    # (T,B,I)
        loss_model = -logavgexp(-(self.kl_weight * loss_kl + loss_reconstr), 2)

        loss_kl_m = -logavgexp(-loss_kl.detach(), 2)
        entropy_post = post_distr.entropy().detach().mean(2)
        tensors.update(loss_kl=loss_kl_m, entropy_post=entropy_post)
        metrics.update(loss_model=loss_model.mean().detach(), loss_kl=loss_kl_m.mean(),
                       entropy_post=entropy_post.mean())

        if do_image_pred:
            with torch.no_grad():
                zprior = prior_distr.sample_noise(
                    noise.draw("embed_pred_z", prior_distr.loc.shape, "normal"))
                _, _, tens = self.decoder(zprior, obs, extra_metrics=True)
            tensors.update(_pred_tensors(tens))
        return loss_model.mean(), z, None, in_state, metrics, tensors


class _EmbedDynamics(nn.Module):
    """Shared part of the GRU-VAE and the transformer-VAE: the VAE's embedding
    (trained by its own loss), detached, with the next action, into a
    sequence model whose features predict each sample's own next embedding."""

    def _embed_act(self, obs, noise, iwae_samples, do_image_pred):
        loss, embed, _, _, metrics, tensors = self.embedding.training_step(
            obs, None, noise, iwae_samples=iwae_samples, do_image_pred=do_image_pred)
        T, B, I = embed.shape[:3]
        embed = embed.reshape(T, B * I, -1).detach()           # b-major: row b*I + i
        action_next = obs["action_next"].repeat_interleave(I, 1)
        return loss, embed, torch.cat([embed, action_next.to(embed.dtype)], -1), metrics, tensors

    def _dynamics_loss(self, obs, loss, embed, features, metrics, tensors, do_image_pred):
        T, B, I = features.shape[:3]
        embed_next = embed[1:].reshape(T - 1, B, I, -1)
        dyn_dist = self.dynamics(features[:-1])
        loss_dyn_tbi = -dyn_dist.log_prob(embed_next) * (self.dynamics.std ** 2)
        loss_dyn = -logavgexp(-loss_dyn_tbi, 2)                      # (T-1,B)
        metrics["loss_dyn"] = loss_dyn.mean().detach()
        tensors["loss_dyn"] = loss_dyn.detach()
        if do_image_pred:
            with torch.no_grad():
                z = dyn_dist.mean.mean(2)                            # (T-1,B,E)
                z = torch.cat([torch.zeros_like(z[:1]), z], 0)
                _, _, tens = self.embedding.decoder(z[:, :, None], obs, extra_metrics=True)
            tensors.update(_pred_tensors(tens))
        return loss + loss_dyn.mean()


class GRUVAEWorldModel(_EmbedDynamics):
    """VAE embed (detached) + next action -> GRU -> predict the next embed."""

    def __init__(self, conf, dtype):
        super().__init__()
        self.state_dim = self.out_dim = conf.deter_dim
        self.embedding = VAEWorldModel(conf, dtype)
        self.rnn = GRUSequence(self.embedding.out_dim + conf.action_dim, self.state_dim, dtype)
        self.dynamics = DenseNormalDecoder(self.state_dim, self.embedding.out_dim,
                                           hidden_layers=2, dtype=dtype)

    def init_state(self, batch_size: int, device) -> torch.Tensor:
        return torch.zeros(batch_size, self.state_dim, device=device)

    def training_step(self, obs, in_state, noise, iwae_samples: int = 1,
                      do_open_loop=False, do_image_pred=False):
        in_state = _reset_first(in_state, obs["reset"])
        loss, embed, embed_act, metrics, tensors = self._embed_act(
            obs, noise, iwae_samples, do_image_pred)
        T, B = obs["reset"].shape[:2]
        features, out_state = self.rnn(embed_act, in_state)
        features = features.reshape(T, B, iwae_samples, -1)
        loss = self._dynamics_loss(obs, loss, embed, features, metrics, tensors, do_image_pred)
        return loss, features, None, out_state.detach(), metrics, tensors


class _SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` of a sequence with itself:
    per-head query/key/value projections, softmax(q k^T / sqrt(head_dim)) v
    unmasked, then the output projection. The projections are stored as
    Linear layers over all heads (``convert.py`` reshapes the JAX kernels)."""

    def __init__(self, d_model: int, nhead: int, dtype):
        super().__init__()
        self.nhead = nhead
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(d_model, d_model, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B,T,D)
        B, T, D = x.shape
        q, k, v = (getattr(self, n)(x).reshape(B, T, self.nhead, -1).transpose(1, 2)
                   for n in ("query", "key", "value"))
        y = F.scaled_dot_product_attention(q, k, v)                  # (B,H,T,Dh)
        return self.out(y.transpose(1, 2).reshape(B, T, D))


class _TransformerEncoder(nn.Module):
    """Pre-input Dense + N post-norm encoder layers (unmasked over T) + a
    final LayerNorm. The Dense layers keep flax's auto-names: ``Dense_0`` is
    the input projection, layer i's feed-forward is ``Dense_{2i+1}`` and
    ``Dense_{2i+2}``."""

    def __init__(self, in_dim: int, d_model: int = 512, nhead: int = 8,
                 dim_feedforward: int = 2048, num_layers: int = 6, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.Dense_0 = Dense(in_dim, d_model, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"attn_{i}", _SelfAttention(d_model, nhead, dtype))
            self.add_module(f"ln1_{i}", Norm(d_model, dtype=dtype, eps=TRANSFORMER_LN_EPS))
            self.add_module(f"Dense_{2 * i + 1}", Dense(d_model, dim_feedforward, dtype=dtype))
            self.add_module(f"Dense_{2 * i + 2}", Dense(dim_feedforward, d_model, dtype=dtype))
            self.add_module(f"ln2_{i}", Norm(d_model, dtype=dtype, eps=TRANSFORMER_LN_EPS))
        self.ln_out = Norm(d_model, dtype=dtype, eps=TRANSFORMER_LN_EPS)

    def forward(self, x):  # (T,B,X)
        x = self.Dense_0(x).transpose(0, 1)                           # (B,T,D)
        for i in range(self.num_layers):
            x = getattr(self, f"ln1_{i}")(x + getattr(self, f"attn_{i}")(x))
            y = F.relu(getattr(self, f"Dense_{2 * i + 1}")(x))
            x = getattr(self, f"ln2_{i}")(x + getattr(self, f"Dense_{2 * i + 2}")(y))
        return self.ln_out(x).transpose(0, 1).float()


class TransformerVAEWorldModel(_EmbedDynamics):
    """Transformer dynamics over detached VAE embeds."""

    def __init__(self, conf, dtype):
        super().__init__()
        self.state_dim = self.out_dim = 512
        self.embedding = VAEWorldModel(conf, dtype)
        self.transformer = _TransformerEncoder(self.embedding.out_dim + conf.action_dim,
                                               d_model=self.state_dim, dtype=dtype)
        self.dynamics = DenseNormalDecoder(self.state_dim, self.embedding.out_dim,
                                           hidden_layers=2, dtype=dtype)

    def init_state(self, batch_size: int, device) -> torch.Tensor:
        return torch.zeros(0, device=device)

    def training_step(self, obs, in_state, noise, iwae_samples: int = 1,
                      do_open_loop=False, do_image_pred=False):
        loss, embed, embed_act, metrics, tensors = self._embed_act(
            obs, noise, iwae_samples, do_image_pred)
        T, B = obs["reset"].shape[:2]
        features = self.transformer(embed_act).reshape(T, B, iwae_samples, -1)
        loss = self._dynamics_loss(obs, loss, embed, features, metrics, tensors, do_image_pred)
        return loss, features, None, in_state, metrics, tensors


class _GRUEncoderCore(nn.Module):
    def __init__(self, conf, state_dim: int, dtype):
        super().__init__()
        self.encoder = _multi_encoder(conf, dtype)
        self.Dense_0 = Dense(self.encoder.out_dim, 32, dtype=dtype)  # squeeze vs action input
        self.GRUSequence_0 = GRUSequence(32 + conf.action_dim, state_dim, dtype)

    def forward(self, obs, in_state):
        embed = self.Dense_0(self.encoder(obs)).float()
        return self.GRUSequence_0(torch.cat([embed, obs["action_next"].float()], -1), in_state)


class GRUEncoderOnly(nn.Module):
    """Forward-only GRU probe baseline: loss 0, the probe is the only signal
    (with ``probe_gradients``, the only one that reaches the GRU)."""

    def __init__(self, conf, dtype):
        super().__init__()
        self.state_dim = self.out_dim = conf.deter_dim
        self.core = _GRUEncoderCore(conf, self.state_dim, dtype)

    def init_state(self, batch_size: int, device) -> torch.Tensor:
        return torch.zeros(batch_size, self.state_dim, device=device)

    def training_step(self, obs, in_state, noise, iwae_samples: int = 1,
                      do_open_loop=False, do_image_pred=False):
        if iwae_samples != 1:
            raise ValueError("gru_probe takes iwae_samples: 1")
        features, out_state = self.core(obs, _reset_first(in_state, obs["reset"]))
        zero = torch.zeros((), device=features.device)
        return zero, features[:, :, None], None, out_state.detach(), {}, {}


_BASELINES = {
    "vae": VAEWorldModel,
    "gru_vae": GRUVAEWorldModel,
    "transformer_vae": TransformerVAEWorldModel,
    "gru_probe": GRUEncoderOnly,
}


class WorldModelProbe(nn.Module):
    """A baseline world model and a probe, with ``Dreamer.training_step``'s
    contract minus the actor-critic: the submodules are ``wm`` and ``probe``,
    the JAX params tree's top-level keys.

    ``device`` defaults to ``"cuda"`` and raises without a card unless the
    caller passes ``"cpu"``.
    """

    def __init__(self, conf, device: str | torch.device = "cuda"):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.probe_gradients = conf.probe_gradients
        dtype = compute_dtype(conf)
        try:
            wm_cls = _BASELINES[conf.model]
        except KeyError:
            raise ValueError(f"unknown baseline model {conf.model!r}") from None
        self.wm = wm_cls(conf, dtype)
        self.probe = make_probe(conf, self.wm.out_dim, dtype)
        self.to(self.device)

    def init_state(self, batch_size: int) -> torch.Tensor:
        return self.wm.init_state(batch_size, self.device)

    def training_step(self, obs, in_state, noise,
                      iwae_samples: Optional[int] = None,
                      imag_horizon: Optional[int] = None,
                      do_open_loop: bool = False,
                      do_image_pred: bool = False,
                      do_dream_tensors: bool = False):
        """Returns (losses, out_state, metrics, tensors, {}) with losses =
        {loss_model, loss_probe}."""
        obs = prepare_obs(obs)
        I = int(iwae_samples or self.conf.iwae_samples)
        loss_model, features, _, out_state, metrics, tensors = self.wm.training_step(
            obs, in_state, noise, iwae_samples=I, do_open_loop=do_open_loop,
            do_image_pred=do_image_pred)
        features_probe = features if self.probe_gradients else features.detach()
        loss_probe, metrics_probe, tensors_probe = self.probe.training_step(features_probe, obs)
        metrics.update(metrics_probe)
        tensors.update(tensors_probe)
        return dict(loss_model=loss_model, loss_probe=loss_probe), out_state, metrics, tensors, {}
