"""Model FLOPs of one DreamerV2 train step, from the configuration's shapes.

Counts the multiply-adds (2 FLOPs each) of every matrix product and
convolution that the algorithm needs: the forward, and in the backward each
gradient that some parameter's update needs, a weight's gradient where the
weight trains and an input's gradient where something upstream trains. It
leaves out the elementwise work (norms, activations, distributions) and any
recomputation, such as K1's backward, which runs the cell's forward again.
Bias gradients are sums and not counted.

The terms, with N = T*B rows of the batch and M = N rows of the dream:

* the encoder's four convolutions over N frames; no gradient to the image;
* the posterior loop, T steps of B rows; the carried state enters without a
  gradient, so the first step has none to z or h;
* the prior over N states, the image decoder and the reward and terminal
  heads over N features;
* the dream, H steps of M rows through the actor and the prior, then the
  reward and terminal heads, the critic target, the critic and the actor over
  its features. Under ``reinforce`` it takes no gradient, and the actor and
  critic train on detached features. Under ``dynamics`` the gradient runs
  back through the frozen world model's products (inputs only) into the
  actor, whose in-loop products train too.
"""

from __future__ import annotations

from typing import Dict, Sequence

__all__ = ["count"]


def _mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def _mlp(rows: int, n_in: int, n_out: int, layers: int, train: bool, input_grad: bool) -> int:
    """Forward and backward FLOPs of an MLP of ``layers`` hidden layers of 400."""
    dims = [n_in] + [400] * layers + [n_out]
    total = 0
    for i in range(len(dims) - 1):
        f = _mm(rows, dims[i], dims[i + 1])
        grad_in = input_grad or (train and i > 0)
        total += f * (1 + int(train) + int(grad_in))
    return total


def _conv_chain(frames: int, sizes: Sequence[int], chans: Sequence[int], kernels: Sequence[int],
                transposed: bool, first_input_grad: bool) -> int:
    """A chain of stride-2 (transposed) convolutions, forward and backward,
    every weight training. FLOPs of a layer: 2 * frames * (the input's spatial
    size for a transposed one, the output's otherwise) * k^2 * Cin * Cout."""
    total = 0
    for i, k in enumerate(kernels):
        spatial = sizes[i] if transposed else sizes[i + 1]
        f = 2 * frames * spatial * spatial * k * k * chans[i] * chans[i + 1]
        total += f * (2 + int(i > 0 or first_input_grad))
    return total


def count(c: Dict) -> int:
    T, B, H = c["batch_length"], c["batch_size"], c["imag_horizon"]
    N = M = T * B
    D, hid, A = c["deter_dim"], c["hidden_dim"], c["action_dim"]
    Z = c["stoch_dim"] * c["stoch_discrete"]
    d, size, C = c["cnn_depth"], c["image_size"], c["image_channels"]
    F = D + Z
    E = 32 * d
    dynamics = c["actor_grad"] == "dynamics"
    a_out = A if c["actor_dist"] == "onehot" else 2 * A
    rew, term = c["reward_decoder_layers"], c["terminal_decoder_layers"]

    total = 0
    # Encoder: 64 -> 31 -> 14 -> 6 -> 2, channels C -> d -> 2d -> 4d -> 8d.
    enc_sizes = [size]
    for _ in range(4):
        enc_sizes.append((enc_sizes[-1] - 4) // 2 + 1)
    total += _conv_chain(N, enc_sizes, (C, d, 2 * d, 4 * d, 8 * d), (4, 4, 4, 4),
                         transposed=False, first_input_grad=False)

    # Posterior loop: T steps of B rows, every weight training.
    for t in range(T):
        first = t == 0
        total += _mm(B, Z, hid) * (2 + int(not first))    # z_mlp
        total += _mm(B, A, hid) * 2                        # a_mlp: the action has no gradient
        total += _mm(B, hid, 3 * D) * 3                    # GRU input product
        total += _mm(B, D, 3 * D) * (2 + int(not first))   # GRU state product
        total += _mm(B, D, hid) * 3                        # post_mlp_h
        total += _mm(B, E, hid) * 3                        # post_mlp_e
        total += _mm(B, hid, Z) * 3                        # post_mlp
    total += (_mm(N, D, hid) + _mm(N, hid, Z)) * 3          # the prior over all states

    # Image decoder: Dense, then 1 -> 5 -> 13 -> 30 -> 64.
    total += _mm(N, F, 32 * d) * 3
    dec_sizes = [1]
    for k in (5, 5, 6, 6):
        dec_sizes.append((dec_sizes[-1] - 1) * 2 + k)
    total += _conv_chain(N, dec_sizes, (32 * d, 4 * d, 2 * d, d, C), (5, 5, 6, 6),
                         transposed=True, first_input_grad=True)
    total += _mlp(N, F, 1, rew, train=True, input_grad=True)
    total += _mlp(N, F, 1, term, train=True, input_grad=True)

    # The dream: H steps of M rows, the world model frozen.
    frozen = 1 + int(dynamics)  # a frozen product: its forward, and its input's gradient under dynamics
    for t in range(H):
        first = t == 0
        total += _mlp(M, F, a_out, 4, train=dynamics, input_grad=dynamics and not first)
        total += _mm(M, Z, hid) * (1 + int(dynamics and not first))  # z_mlp
        total += _mm(M, A, hid) * frozen                            # a_mlp
        total += _mm(M, hid, 3 * D) * frozen                        # GRU input product
        total += _mm(M, D, 3 * D) * (1 + int(dynamics and not first))  # GRU state product
        total += (_mm(M, D, hid) + _mm(M, hid, Z)) * frozen          # prior
    J = (H + 1) * M
    for layers in (rew, term):  # reward and terminal of the dream's features
        total += _mlp(J, F, 1, layers, train=False, input_grad=dynamics)
    total += _mlp(J, F, 1, 4, train=False, input_grad=dynamics)    # critic target
    total += _mlp(J, F, 1, 4, train=True, input_grad=False)        # critic, detached features
    total += _mlp(H * M, F, a_out, 4, train=True, input_grad=dynamics)  # actor
    return total
