"""The general generator of training traffic: batches as the learner gets them.

A mix (``traffic/<mix>.json``) is data: how many distinct batches the pool
holds, what images, rewards and terminals look like, where resets fall. The
configuration gives the shapes: T x B sequences of 64x64x3 uint8 frames (what
``data.Preprocessor`` hands the card for RGB episodes), actions one-hot for a
discrete actor and uniform in [-1, 1] for a continuous one, rewards squashed
by the configuration's ``clip_rewards``.

Everything is made on the device from the run's seed, in a few large calls.
Step ``s`` (counted from 1) takes pool batch ``(s - 1) % pool_batches``, so
the first steps, which the comparison follows, all see different rows. A
column's episode starts every ``env_time_limit`` agent steps, at an offset
drawn per column; ``reset[t, b]`` marks the first step of an episode, where
the model zeroes the carried state.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .noise import KeyedNoise

__all__ = ["Feed"]

MIX_KEYS = {"about", "loop", "pool_batches", "image", "reward_nonzero_share",
            "terminal_share", "resets", "sample_margin"}


class Feed:
    def __init__(self, conf: Dict, mix: Dict, seed: int, device, noise_seed: int = 0):
        unknown = set(mix) - MIX_KEYS
        if unknown or mix.get("loop") != "closed" or mix.get("image") != "uint8_uniform" \
                or mix.get("resets") != "env_time_limit":
            raise ValueError(f"this generator reads closed-loop training mixes with uint8 "
                             f"images and resets at env_time_limit; got {mix}")
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        P = int(mix["pool_batches"])
        T, B = conf["batch_length"], conf["batch_size"]
        size, C, A = conf["image_size"], conf["image_channels"], conf["action_dim"]
        self.T, self.P = T, P
        self.noise_seed, self.margin = noise_seed, float(mix.get("sample_margin", 0.0))
        self.generator = torch.Generator(device=device)
        self.image = torch.randint(0, 256, (P, T, B, size, size, C), generator=gen,
                                   device=device, dtype=torch.uint8)
        if conf["actor_dist"] == "onehot":
            index = torch.randint(0, A, (P, T, B), generator=gen, device=device)
            self.action = F.one_hot(index, A).float()
        else:
            self.action = torch.rand((P, T, B, A), generator=gen, device=device) * 2.0 - 1.0
        reward = torch.rand((P, T, B), generator=gen, device=device)
        keep = torch.rand((P, T, B), generator=gen, device=device) < mix["reward_nonzero_share"]
        reward = torch.where(keep, reward, torch.zeros_like(reward))
        if conf.get("clip_rewards") == "tanh":
            reward = torch.tanh(reward)
        elif conf.get("clip_rewards"):
            raise ValueError(f"clip_rewards {conf['clip_rewards']!r} is not generated")
        self.reward = reward
        self.terminal = (torch.rand((P, T, B), generator=gen, device=device)
                         < mix["terminal_share"]).float()
        self.episode = int(conf["env_time_limit"])
        offsets = torch.randint(0, self.episode, (B,), generator=gen, device=device)
        self.phase = torch.arange(T, device=device).unsqueeze(1) + offsets.unsqueeze(0)

    def noise(self, step: int) -> KeyedNoise:
        """The noise source of step ``step``."""
        return KeyedNoise(self.noise_seed, step, self.generator.device, self.generator, self.margin)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The inputs of step ``step`` (from 1)."""
        i = (step - 1) % self.P
        reset = (self.phase + (step - 1) * self.T) % self.episode == 0
        return {"image": self.image[i], "action": self.action[i], "reward": self.reward[i],
                "terminal": self.terminal[i], "reset": reset}
