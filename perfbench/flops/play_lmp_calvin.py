"""Operations of one Play-LMP train step (``play_lmp_calvin``), by op class,
from the configuration's sizes: the matrix products and convolutions the
forward and backward need, at two FLOPs a multiply-add. Nothing is
recomputed, and no backward runs where nothing needs a gradient: not
into the images (the first convolution's weight gradient only), not
through the augmentation's resize, not into the recurrence's zero
initial state. Element-wise work is not counted.

Op classes: ``conv`` (the encoder's convolutions), ``resize`` (the
augmentation's two resize passes), ``dense`` (every linear layer,
attention, the soft-argmax's expectations), ``rnn`` (the decoder's
recurrence and input projections)."""

from __future__ import annotations


def _conv_out(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


def step_flops(sizes: dict) -> dict:
    b, t = sizes["batch_size"], sizes["max_window_size"]
    n = b * t
    src = sizes["image_hw"]
    h, w = sizes["augment"]["size"]
    lat, z = sizes["latent_dim"], sizes["latent_plan_dim"]

    # convolutions: (out channels, in channels, kernel, stride)
    layers = ((32, 3, 8, 4), (64, 32, 4, 2), (64, 64, 3, 1))
    size, conv, last = h, 0, 0
    for i, (co, ci, k, s) in enumerate(layers):
        size = _conv_out(size, k, s)
        mac = n * size * size * co * ci * k * k
        conv += mac * (2 if i == 0 else 3)  # forward, weight grad, input grad past the first
        last = size
    resize = n * 3 * (h * src * src + w * src * h)

    def linear(rows: int, fan_in: int, fan_out: int) -> int:
        return 3 * rows * fan_in * fan_out  # forward, input grad, weight grad

    hid = sizes["encoder_hidden_dim"]
    # the soft-argmax's two expectations (their backward is an outer
    # product, no reduction)
    dense = 2 * n * 64 * last * last
    dense += linear(n, 128, hid) + linear(n, hid, lat)
    g = sizes["goal_hidden_size"]
    dense += linear(b, lat, g) + linear(b, g, g) + linear(b, g, lat)
    p, pl = sizes["prior_hidden_dim"], sizes["prior_num_layers"]
    dense += linear(b, 2 * lat, p) + (pl - 1) * linear(b, p, p) + 2 * linear(b, p, z)
    d = lat + (-lat % sizes["num_heads"])
    ffn = sizes["encoder_hidden_size"]
    per_layer = linear(n, d, 3 * d) + 3 * 2 * n * t * d + linear(n, d, d) + linear(n, d, ffn) + linear(n, ffn, d)
    dense += sizes["num_layers"] * per_layer
    fc = sizes["fc_hidden_size"]
    dense += linear(n, d, fc) + 2 * linear(b, fc, z)

    hd, nl = sizes["decoder_hidden_size"], sizes["decoder_num_layers"]
    steps = t - 1  # the decoder scores every frame but the goal frame
    rnn = 0
    for i in range(nl):
        rnn += linear(b * steps, z + lat if i == 0 else hd, hd)
        rnn += linear(b * (steps - 1), hd, hd)  # no product with the zero initial state
    cont = (sizes["action_dim"] - 1) * sizes["n_mixtures"]
    dense += 3 * linear(b * steps, hd, cont) + linear(b * steps, hd, 2)
    # every count above is of multiply-adds
    return {"conv": 2 * conv, "resize": 2 * resize, "dense": 2 * dense, "rnn": 2 * rnn}
