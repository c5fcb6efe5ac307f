"""GCN material regressor (the counterpart of the JAX package's models/gcn.py;
reference ipt.py:28-84).

The transport graphs are small and dense ((nT+1) x nT), so DGL's message
passing `src_mul_edge -> sum` is a dense product `A @ h` with A[dst, src] =
the edge weight.  Architecture (ipt.py:28-67):

  lift: Linear(3 -> 100) + tanh
  3 x MPL(200 -> 100, relu):  h' = relu(Linear(cat(h, A @ h)))
  out:  Linear(100 -> 3) + sigmoid
  loss: mean L1 (ipt.py:48-50)

Every product is a plain torch.matmul (the JAX package leaves them to XLA).
The model is batched over any leading scene axes of (adj, x).  Its weights
start as torch.nn.Linear's default, U(+-1/sqrt(fan_in)) for weight and bias,
drawn from a seeded generator.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from inverse_path_tracer_torch.render.forward import resolve_device
from inverse_path_tracer_torch.utils.checkpoint import load_checkpoint, save_checkpoint

HIDDEN = 100  # ipt.py:28-67
N_MPL = 3


def build_dense_graph(
    w: torch.Tensor,  # (..., nT+1, nT) row-normalised log weights from compress
    pixel: torch.Tensor,  # (..., nT+1, nT, 3)
    light: Optional[torch.Tensor] = None,  # unused (parity with ipt.py:69)
    p_min: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A (..., nT, nT) with A[dst, src] = weight, node features (..., nT, 3)
    = the eye row's pixel colours) (ipt.py:69-84): weights below p_min are
    dropped, rows renormalised, the eye row removed.  DGL's added self loops
    carry zero weight and change nothing."""
    w = torch.where(w < p_min, torch.zeros_like(w), w)
    row = w.sum(dim=-1, keepdim=True)
    w = w / torch.where(row != 0.0, row, torch.ones_like(row))
    return w[..., :-1, :], pixel[..., -1, :, :]


class GCN(nn.Module):
    def __init__(self, seed: int = 0):
        super().__init__()
        self.lift = nn.Linear(3, HIDDEN)
        self.mpl = nn.ModuleList(nn.Linear(2 * HIDDEN, HIDDEN) for _ in range(N_MPL))
        self.out = nn.Linear(HIDDEN, 3)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in (self.lift, *self.mpl, self.out):
                bound = 1.0 / layer.in_features ** 0.5
                layer.weight.uniform_(-bound, bound, generator=g)
                layer.bias.uniform_(-bound, bound, generator=g)

    def forward(self, adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(..., nT, 3) node features -> (..., nT, 3) predicted Kd in (0, 1)."""
        h = torch.tanh(self.lift(x))
        for layer in self.mpl:
            h = torch.relu(layer(torch.cat([h, torch.matmul(adj, h)], dim=-1)))
        return torch.sigmoid(self.out(h))


def gcn_loss(model: GCN, adj, x, labels) -> torch.Tensor:
    """Mean L1 over every scene, node and channel (ipt.py:48-50)."""
    return (model(adj, x) - labels).abs().mean()


def _save(path, model, opt, step):
    arrays = {f"param/{k}": v for k, v in model.state_dict().items()}
    for k, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            arrays[f"exp_avg/{k}"] = st["exp_avg"]
            arrays[f"exp_avg_sq/{k}"] = st["exp_avg_sq"]
            arrays[f"step/{k}"] = st["step"]
    save_checkpoint(path, arrays, step=step)


def _restore(path, model, opt) -> int:
    saved, step = load_checkpoint(path)
    dev = next(model.parameters()).device
    model.load_state_dict({k[len("param/"):]: v for k, v in saved.items()
                           if k.startswith("param/")})
    for k, p in model.named_parameters():
        if f"exp_avg/{k}" in saved:
            opt.state[p] = {"step": saved[f"step/{k}"].clone(),
                            "exp_avg": saved[f"exp_avg/{k}"].to(dev),
                            "exp_avg_sq": saved[f"exp_avg_sq/{k}"].to(dev)}
    return step


def train_gcn(
    adj: torch.Tensor,  # (S, nT, nT) or (nT, nT)
    x: torch.Tensor,
    labels: torch.Tensor,
    epochs: int = 100_000,
    lr: float = 1e-4,
    log_every: int = 1000,
    log_fn: Optional[Callable[[int, float], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    seed: int = 0,
    model: Optional[GCN] = None,
    device=None,
) -> Tuple[GCN, float]:
    """Full-batch Adam at lr 1e-4 for `epochs` steps (ipt.py:110-125; Adam
    with optax's defaults b1 0.9, b2 0.999, eps 1e-8).  Starts from `model`,
    or from GCN(seed=seed).  log_fn(epoch, loss) runs every log_every
    epochs with the loss of the last step taken.  Every checkpoint_every
    epochs (model, Adam's state) are written atomically to checkpoint_path;
    with resume=True training continues from the saved epoch and ends
    bit-identical to an uninterrupted run.  Returns (model, last loss)."""
    dev = resolve_device(device)
    model = (GCN(seed=seed) if model is None else model).to(dev)
    adj, x, labels = (t.to(device=dev, dtype=torch.float32) for t in (adj, x, labels))
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    done = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        done = _restore(checkpoint_path, model, opt)
    loss = None
    while done < epochs:
        opt.zero_grad(set_to_none=True)
        loss = gcn_loss(model, adj, x, labels)
        loss.backward()
        opt.step()
        done += 1
        if log_fn is not None and (done % log_every == 0 or done == epochs):
            log_fn(done, float(loss.detach()))
        if checkpoint_path and checkpoint_every and done % checkpoint_every == 0:
            _save(checkpoint_path, model, opt, done)
    return model, float("nan") if loss is None else float(loss.detach())


def load_gcn(path: str, device) -> GCN:
    """The GCN of a train_gcn checkpoint (utils/checkpoint.py) or of one
    written by the JAX package (its __meta__ holds a treedef), on `device`."""
    from inverse_path_tracer_torch.convert import gcn_params_from_numpy, read_jax_checkpoint

    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
    if "treedef" in meta:
        state = gcn_params_from_numpy(read_jax_checkpoint(path)[0])
    else:
        state = load_checkpoint(path)[0]
    model = GCN()
    model.load_state_dict(state)
    return model.to(device)
