"""Operations of one TACO-RL train step (``tacorl_calvin``), by op class, as
``play_lmp_calvin.py`` counts them: the matrix products and convolutions
the forward and backward need, at two FLOPs a multiply-add, nothing
recomputed and no backward where nothing needs a gradient (the frozen
encoder and posterior, the target critics, the samples drawn without
gradient; the critics' weights under the actor loss).

Images through a vision encoder per step, with B the batch and T the
window: the frozen encoder T * B frames (forward); the actor's encoder the
first frame and the goal (forward and backward) and the last frame and
the goal again (forward); each critic's encoder the first frame and the
goal (forward and backward); each target's the last frame and the goal
(forward)."""

from __future__ import annotations


def _conv_out(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


def step_flops(sizes: dict) -> dict:
    b, t = sizes["batch_size"], sizes["max_window_size"]
    n = b * t
    src = sizes["image_hw"]
    h, w = sizes["augment"]["size"]
    lat, z, hid = sizes["latent_dim"], sizes["latent_plan_dim"], sizes["encoder_hidden_dim"]

    def linear(rows, fan_in, fan_out, passes=3):
        """passes: 1 forward; 2 forward and one gradient; 3 both gradients."""
        return passes * rows * fan_in * fan_out

    # a vision encoder over `rows` images: forward only (1) or trained (3)
    def encoder(rows, passes):
        size, conv, last = h, 0, 0
        for i, (co, ci, k, s) in enumerate(((32, 3, 8, 4), (64, 32, 4, 2), (64, 64, 3, 1))):
            size = _conv_out(size, k, s)
            mac = rows * size * size * co * ci * k * k
            conv += mac * (1 if passes == 1 else 2 if i == 0 else 3)
            last = size
        head = 2 * rows * 64 * last * last  # soft-argmax expectations (forward only)
        head += linear(rows, 128, hid, passes) + linear(rows, hid, lat, passes)
        return conv, head

    g = sizes["goal_hidden_size"]

    def goal_mlp(rows, passes):
        return linear(rows, lat, g, passes) + linear(rows, g, g, passes) + linear(rows, g, lat, passes)

    conv = dense = 0
    for rows, passes in ((n, 1), (2 * b, 3), (2 * b, 1), (4 * b, 3), (4 * b, 1)):
        c, d = encoder(rows, passes)
        conv, dense = conv + c, dense + d
    # goal MLPs: the actor's (trained, then again without gradient), the
    # critics' (trained), the targets' (forward)
    dense += goal_mlp(b, 3) + goal_mlp(b, 1) + 2 * goal_mlp(b, 3) + 2 * goal_mlp(b, 1)

    # the frozen posterior over the window, forward only
    d = lat + (-lat % sizes["num_heads"])
    ffn, fc = sizes["encoder_hidden_size"], sizes["fc_hidden_size"]
    per_layer = linear(n, d, 3 * d, 1) + 2 * n * t * d + linear(n, d, d, 1) + linear(n, d, ffn, 1) + linear(n, ffn, d, 1)
    dense += sizes["num_layers"] * per_layer + linear(n, d, fc, 1) + 2 * linear(b, fc, z, 1)

    # the decoder's fine-tune: its input takes no gradient
    hd, nl = sizes["decoder_hidden_size"], sizes["decoder_num_layers"]
    steps = t - 1
    rnn = 0
    for i in range(nl):
        rnn += linear(b * steps, z + lat if i == 0 else hd, hd, 2 if i == 0 else 3)
        rnn += linear(b * (steps - 1), hd, hd)
    cont = (sizes["action_dim"] - 1) * sizes["n_mixtures"]
    dense += 3 * linear(b * steps, hd, cont) + linear(b * steps, hd, 2)

    # the plan-space actor: two forwards with gradient (the sample, the BC
    # log-density), three without (the next plan, the two n-sample draws)
    p, pl = sizes["prior_hidden_dim"], sizes["prior_num_layers"]

    def policy(rows, passes):
        return linear(rows, 2 * lat, p, passes) + (pl - 1) * linear(rows, p, p, passes) + 2 * linear(rows, p, z, passes)

    na = sizes["n_action_samples"]
    dense += 2 * policy(b, 3) + policy(b, 1) + 2 * policy(b, 1)

    # the critics' MLPs: q_pi (forward and the input's gradient), the data
    # and the 3 n-sample batches (trained), the targets (forward)
    qh, ql = sizes["q_hidden_dim"], sizes["q_num_layers"]

    def q(rows, passes):
        return linear(rows, 2 * lat + z, qh, passes) + (ql - 1) * linear(rows, qh, qh, passes) + linear(rows, qh, 1, passes)

    dense += 2 * (q(b, 2) + q(b, 3) + 3 * q(na * b, 3) + q(b, 1))
    resize = (n + b) * 3 * (h * src * src + w * src * h)
    return {"conv": 2 * conv, "resize": 2 * resize, "dense": 2 * dense, "rnn": 2 * rnn}
