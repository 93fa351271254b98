"""Operations of one Play-LMP train step over a frozen R3M ResNet-18
(``play_lmp_r3m_calvin``), by op class, from the configuration's sizes:
the matrix products and convolutions at two FLOPs a multiply-add, as
``flops/play_lmp_calvin.py`` counts them.

Op classes: ``backbone`` (the frozen trunk's convolutions, forward only:
no backward runs into it), ``resize`` (the augmentation's two resize
passes), ``dense`` (every linear layer and attention; the R3M head's first
layer has no input gradient, its input being the frozen trunk's
features), ``rnn`` (the decoder's recurrence and input projections).
Element-wise work (BatchNorm, ReLU, the pools) is not counted."""

from __future__ import annotations


def _out(size: int, k: int, s: int, pad: int) -> int:
    return (size + 2 * pad - k) // s + 1


def backbone_macs(hw, widths, blocks) -> int:
    """Multiply-adds of the trunk's convolutions on one frame of ``hw``
    (H, W): the 7x7/2 stem, then each stage's 3x3 convolutions and the 1x1
    convolution of the residual where a stage strides or widens."""
    h, w = hw
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    macs = h * w * widths[0] * 3 * 49
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # the max-pool
    c = widths[0]
    for s, (co, n) in enumerate(zip(widths, blocks)):
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            macs += ho * wo * co * c * 9 + ho * wo * co * co * 9
            if stride != 1 or c != co:
                macs += ho * wo * co * c
            h, w, c = ho, wo, co
    return macs


def step_flops(sizes: dict) -> dict:
    b, t = sizes["batch_size"], sizes["max_window_size"]
    n = b * t
    src = sizes["image_hw"]
    h, w = sizes["augment"]["size"]
    lat, z = sizes["latent_dim"], sizes["latent_plan_dim"]

    backbone = n * backbone_macs((h, w), sizes["backbone_widths"], sizes["backbone_blocks"])
    resize = n * 3 * (h * src * src + w * src * h)

    def linear(rows: int, fan_in: int, fan_out: int) -> int:
        return 3 * rows * fan_in * fan_out  # forward, input grad, weight grad

    hid = sizes["encoder_hidden_dim"]
    dense = 2 * n * sizes["backbone_features"] * hid + linear(n, hid, lat)
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
    return {"backbone": 2 * backbone, "resize": 2 * resize, "dense": 2 * dense, "rnn": 2 * rnn}
