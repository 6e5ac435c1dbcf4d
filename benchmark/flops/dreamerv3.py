"""Model FLOPs of one DreamerV3 train step, from the configuration's shapes.

By the rules of ``flops/dreamer.py``: the multiply-adds (2 FLOPs each) of
every matrix product and convolution the algorithm needs, the forward and,
in the backward, each gradient that some parameter's update needs; no
elementwise work (norms, activations, the two-hot distributions), no
recomputation (K1's backward runs the cell's forward again). With N = T*B
rows of the batch and M = N rows of the dream:

* the encoder's four SAME convolutions over N frames (64 -> 4); no gradient
  to the image;
* the posterior loop, T steps of B rows. The learned initial state enters
  every step's state (h = keep h + (1 - keep) tanh(w0)), so the GRU's state
  product takes an input gradient at the first step too; z0, a mode, takes
  none, so the first step's ``z_mlp`` has none. The loop runs the prior's
  two products once on the one row of h0 (forward: the mode has no
  gradient);
* the prior over N states, the decoder (a Dense to 4x4x8d, then four
  transposed convolutions 4 -> 64), the reward head (255 logits) and the
  continue head over N features, all training and passing the gradient to
  the features;
* the dream, H steps of M rows through the actor and the prior, without a
  gradient (reinforce); then the reward and continue heads over its H+1
  states, the slow critic over H, the critic over H+1 and the actor over H,
  the last two training on detached features.
"""

from __future__ import annotations

from typing import Dict

from .dreamer import _conv_chain, _mm

__all__ = ["count"]

BINS = 255  # the two-hot heads' bins, DreamerV3's constant


def _mlp(rows: int, n_in: int, n_out: int, units: int, layers: int, train: bool,
         input_grad: bool) -> int:
    """Forward and backward FLOPs of an MLP of ``layers`` hidden layers of ``units``."""
    dims = [n_in] + [units] * layers + [n_out]
    total = 0
    for i in range(len(dims) - 1):
        f = _mm(rows, dims[i], dims[i + 1])
        grad_in = input_grad or (train and i > 0)
        total += f * (1 + int(train) + int(grad_in))
    return total


def count(c: Dict) -> int:
    T, B, H = c["batch_length"], c["batch_size"], c["imag_horizon"]
    N = M = T * B
    D, hid, A = c["deter_dim"], c["hidden_dim"], c["action_dim"]
    Z = c["stoch_dim"] * c["stoch_discrete"]
    d, size, C = c["cnn_depth"], c["image_size"], c["image_channels"]
    F = D + Z
    minres = size // 16
    E = minres * minres * 8 * d
    units, bins = c["mlp_units"], BINS
    rew, cont, ac = c["reward_decoder_layers"], c["terminal_decoder_layers"], c["actor_critic_layers"]
    sizes = [size // 2 ** i for i in range(5)]  # 64, 32, 16, 8, 4
    chans = (C, d, 2 * d, 4 * d, 8 * d)

    total = _conv_chain(N, sizes, chans, (4, 4, 4, 4), transposed=False, first_input_grad=False)

    total += _mm(1, D, hid) + _mm(1, hid, Z)               # the prior's mode at h0
    for t in range(T):
        first = t == 0
        total += _mm(B, Z, hid) * (2 + int(not first))    # z_mlp
        total += _mm(B, A, hid) * 2                        # a_mlp: the action has no gradient
        total += _mm(B, hid, 3 * D) * 3                    # GRU input product
        total += _mm(B, D, 3 * D) * 3                      # GRU state product (h0 trains)
        total += _mm(B, D, hid) * 3                        # post_mlp_h
        total += _mm(B, E, hid) * 3                        # post_mlp_e
        total += _mm(B, hid, Z) * 3                        # post_mlp
    total += (_mm(N, D, hid) + _mm(N, hid, Z)) * 3          # the prior over all states

    total += _mm(N, F, E) * 3                               # the decoder's Dense
    total += _conv_chain(N, sizes[::-1], chans[::-1], (4, 4, 4, 4), transposed=True,
                         first_input_grad=True)
    total += _mlp(N, F, bins, units, rew, train=True, input_grad=True)
    total += _mlp(N, F, 1, units, cont, train=True, input_grad=True)

    for _ in range(H):  # the dream, forward only
        total += _mlp(M, F, A, units, ac, train=False, input_grad=False)
        total += _mm(M, Z, hid) + _mm(M, A, hid) + _mm(M, hid, 3 * D) + _mm(M, D, 3 * D)
        total += _mm(M, D, hid) + _mm(M, hid, Z)
    J = (H + 1) * M
    total += _mlp(J, F, bins, units, rew, train=False, input_grad=False)
    total += _mlp(J, F, 1, units, cont, train=False, input_grad=False)
    total += _mlp(H * M, F, bins, units, ac, train=False, input_grad=False)  # slow critic
    total += _mlp(J, F, bins, units, ac, train=True, input_grad=False)      # critic
    total += _mlp(H * M, F, A, units, ac, train=True, input_grad=False)     # actor
    return total
