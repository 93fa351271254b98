"""t-SNE latent-plan diagnostics (port of tacorl_tpu/callbacks/tsne_plot.py;
reference: utils/callbacks/tsne_plot.py:30-164): collect the sampled
plan-proposal latents and the task each validation window completed, embed
them with t-SNE, and log a coloured scatter.

The JAX package calls scikit-learn's TSNE (Barnes-Hut) and draws with
matplotlib. The port needs neither:

  * ``tsne`` is scikit-learn's EXACT method with its defaults, in torch on
    the latents' device: a per-point binary search for the Gaussian's
    precision to the perplexity, symmetrised P, Student-t Q, early
    exaggeration 12 for 250 iterations at momentum 0.5, then momentum 0.8
    to 1,000 iterations, the gains update, learning rate
    ``max(N / 12 / 4, 50)``, progress checks every 50 iterations, and a
    random start (1e-4 times a standard normal) from a seeded generator.
    Exact and Barnes-Hut t-SNE give different embeddings, so the port's is
    not JAX's point for point (ROADMAP Queue 3).
  * ``scatter_image`` rasterises the embedding with numpy into the JAX
    figure's 600x600x3 uint8, tab10 colours by task (grey for windows that
    completed none); the JAX figure's title and colour bar are not drawn
    (ROADMAP Queue 3). ``write_png`` writes it with zlib and struct.

Task labels come from a task differ (FakeTasks, CALVIN Tasks) applied to
the first and last sim state of each window. The port's trainer keeps the
val step's outputs on the device, so the states are copied to the host for
the differ; the latents stay where they are.
"""

from __future__ import annotations

import logging
import math
import struct
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import Tensor

from tacorl_tpu_torch.callbacks.base import Callback

logger = logging.getLogger("tacorl_tpu_torch")

__all__ = ["TSNEPlotCallback", "joint_probabilities", "tsne", "scatter_image", "write_png"]

_EPS = float(np.finfo(np.double).eps)  # scikit-learn's MACHINE_EPSILON
_EXPLORATION_ITERS = 250
_CHECK_EVERY = 50
# matplotlib's tab10, as 0-255 RGB
TAB10 = np.array([
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
    (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207),
], dtype=np.float64)
_NO_TASK = np.array((127, 127, 127), dtype=np.float64)


def _to_host(value: Any) -> np.ndarray:
    return value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


def joint_probabilities(x: Tensor, perplexity: float, steps: int = 100, tol: float = 1e-5) -> Tensor:
    """The symmetric (N, N) P of exact t-SNE for points ``x`` (N, D) on
    their device, float64, zero on the diagonal: squared distances in
    float32, each row's Gaussian precision found by the binary search of
    scikit-learn's ``_binary_search_perplexity`` (all rows at once, a row
    frozen once its entropy is within ``tol`` of log(perplexity)), then
    (P + P^T) / sum, floored at the machine epsilon."""
    x = x.detach().double()
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0).float().double()
    off = ~torch.eye(n, dtype=torch.bool, device=x.device)
    target = math.log(perplexity)
    beta = torch.ones(n, dtype=torch.float64, device=x.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=x.device)
    p = torch.zeros_like(d2)
    for _ in range(steps):
        cand = torch.where(off, torch.exp(-d2 * beta[:, None]), 0.0)
        total = cand.sum(dim=1)
        total = torch.where(total == 0.0, 1e-8, total)
        cand = cand / total[:, None]
        entropy = torch.log(total) + beta * (d2 * cand).sum(dim=1)
        diff = entropy - target
        p = torch.where(done[:, None], p, cand)
        converged = diff.abs() <= tol
        step = ~done & ~converged
        up = step & (diff > 0)
        down = step & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(down, torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0), beta),
        )
        done = done | converged
        if bool(done.all()):
            break
    joint = p + p.T
    joint = joint / torch.clamp(joint.sum(), min=_EPS)
    return torch.where(off, torch.clamp(joint, min=_EPS), 0.0)


def _kl_and_grad(p: Tensor, y: Tensor, off: Tensor) -> Tuple[Tensor, Tensor]:
    """scikit-learn's exact ``_kl_divergence`` at one degree of freedom,
    on full symmetric matrices: the KL(P || Q) and its gradient."""
    sq = (y * y).sum(dim=1)
    w = torch.where(off, 1.0 / (1.0 + torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (y @ y.T), min=0.0)), 0.0)
    q = torch.where(off, torch.clamp(w / w.sum(), min=_EPS), 1.0)
    kl = torch.where(off, p * torch.log(torch.clamp(p, min=_EPS) / q), 0.0).sum()
    pq = torch.where(off, (p - q) * w, 0.0)
    grad = 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)
    return kl, grad


def tsne(
    x: Tensor,
    perplexity: float = 30.0,
    seed: int = 0,
    max_iter: int = 1000,
    early_exaggeration: float = 12.0,
    n_iter_without_progress: int = 300,
    min_grad_norm: float = 1e-7,
) -> Tuple[Tensor, float]:
    """Exact t-SNE of ``x`` (N, D) into 2-D on ``x``'s device (module
    docstring); returns (the (N, 2) float32 embedding, the final KL)."""
    n = x.shape[0]
    device = x.device
    p = joint_probabilities(x, perplexity)
    off = ~torch.eye(n, dtype=torch.bool, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    y = 1e-4 * torch.randn((n, 2), generator=gen, device=device, dtype=torch.float64)
    lr = max(n / early_exaggeration / 4.0, 50.0)
    kl, it = float("nan"), -1
    # (last iteration + 1, momentum, P's factor, iterations without progress)
    phases = ((_EXPLORATION_ITERS, 0.5, early_exaggeration, _EXPLORATION_ITERS),
              (max_iter, 0.8, 1.0, n_iter_without_progress))
    for stop, momentum, exaggeration, patience in phases:
        # each phase starts afresh, after the iteration the last one ended at
        start = it + 1
        update, gains = torch.zeros_like(y), torch.ones_like(y)
        best, best_iter = math.inf, start
        for it in range(start, stop):
            error, grad = _kl_and_grad(p * exaggeration, y, off)
            gains = torch.clamp(torch.where(update * grad < 0.0, gains + 0.2, gains * 0.8), min=0.01)
            grad = grad * gains
            update = momentum * update - lr * grad
            y = y + update
            check = (it + 1) % _CHECK_EVERY == 0
            if check or it == stop - 1:
                kl = float(error)
            if check:
                if kl < best:
                    best, best_iter = kl, it
                elif it - best_iter > patience:
                    break
                if float(torch.linalg.vector_norm(grad)) <= min_grad_norm:
                    break
    return y.float(), kl


def scatter_image(xy: np.ndarray, labels: np.ndarray, size: int = 600, radius: float = 2.7,
                  alpha: float = 0.7, margin: int = 40) -> np.ndarray:
    """A (size, size, 3) uint8 scatter on white: each point a disc of
    ``radius`` pixels in its label's tab10 colour (grey for -1), blended
    at ``alpha`` in order, as matplotlib draws ``scatter(..., s=12,
    alpha=0.7)`` into a 6x6-inch figure at 100 dpi."""
    img = np.full((size, size, 3), 255.0)
    xy = np.asarray(xy, dtype=np.float64)
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    pix = margin + (xy - lo) / span * (size - 1 - 2 * margin)
    pix[:, 1] = size - 1 - pix[:, 1]  # y grows upwards, as in the figure
    r = int(math.ceil(radius))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disc = dx * dx + dy * dy <= radius * radius
    for (px, py), label in zip(pix, np.asarray(labels)):
        colour = _NO_TASK if label < 0 else TAB10[int(label) % 10]
        cx, cy = int(round(px)), int(round(py))
        ys, xs = cy + dy[disc], cx + dx[disc]
        img[ys, xs] = (1.0 - alpha) * img[ys, xs] + alpha * colour
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_png(path, image: np.ndarray) -> Path:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = image.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    rows = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    path = Path(path)
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows, 6))
        + chunk(b"IEND", b"")
    )
    return path


class TSNEPlotCallback(Callback):
    def __init__(
        self,
        task_differ: Any = None,
        perplexity: float = 30.0,
        plot_percentage: float = 1.0,
        every_n_epochs: int = 1,
        out_name: str = "tsne_plan_space",
    ):
        from tacorl_tpu_torch.config import instantiate

        if isinstance(task_differ, dict):
            task_differ = instantiate(task_differ)
        self.task_differ = task_differ
        self.perplexity = perplexity
        self.plot_percentage = plot_percentage
        self.every_n_epochs = every_n_epochs
        self.out_name = out_name
        # the last plot's numbers: points, final KL, t-SNE ms, PNG path
        self.last: Dict[str, Any] = {}

    def _labels_for(self, outputs: List[Dict]) -> Tuple[List[Any], List[int]]:
        """Map each window to its completed-task id (-1 = none, skip >1)."""
        task_names = sorted(self.task_differ.tasks)
        task_to_id = {t: i for i, t in enumerate(task_names)}
        plans, labels = [], []
        for out in outputs:
            if "state_info_initial" not in out:
                continue
            initial = {k: _to_host(v) for k, v in out["state_info_initial"].items()}
            final = {k: _to_host(v) for k, v in out["state_info_final"].items()}
            n = out["sampled_plan_pp"].shape[0]
            for i in range(n):
                start = {k: v[i] for k, v in initial.items()}
                end = {k: v[i] for k, v in final.items()}
                completed = sorted(self.task_differ.get_task_info(start, end))
                if len(completed) > 1:
                    continue
                plans.append(out["sampled_plan_pp"][i])
                labels.append(task_to_id[completed[0]] if completed else -1)
        return plans, labels

    def on_validation_end(self, trainer, module, metrics, outputs, epoch):
        if (
            self.task_differ is None
            or not outputs
            or (epoch + 1) % self.every_n_epochs != 0
        ):
            return
        plans, labels = self._labels_for(outputs)
        if len(plans) < 8:
            return
        plans = torch.stack([torch.as_tensor(p) for p in plans])
        labels = np.asarray(labels)
        if self.plot_percentage < 1.0:
            keep = np.random.RandomState(0).rand(len(plans)) < self.plot_percentage
            plans, labels = plans[torch.from_numpy(keep).to(plans.device)], labels[keep]
        perplexity = min(self.perplexity, max(2, len(plans) - 1))
        t0 = time.perf_counter()
        xy, kl = tsne(plans, perplexity=perplexity)
        xy = xy.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        image = scatter_image(xy, labels)
        log_image = getattr(trainer.sink, "log_image", None)
        if log_image is not None:
            log_image(self.out_name, image, trainer.global_step)
        out_path = trainer.ckpt.dir / f"{self.out_name}_{trainer.global_step}.png"
        write_png(out_path, image)
        self.last = {"n": len(plans), "kl": kl, "ms": ms, "path": str(out_path), "device": str(plans.device)}
        logger.info("t-SNE plan plot over %d windows (KL %.4f, %.1f ms) -> %s", len(plans), kl, ms, out_path)
