"""Sharded contrastive training step (port of
``legalrag_tpu/parallel/training.py``).

The trainable surface is the hash encoder's projection head ``W [d_in,
d_out]`` on top of the feature sketch, tuned with in-batch InfoNCE on
(query, positive article) pairs. On the ``(data, model)`` mesh:

- batch rows split over ``data``; ``W``'s columns split over ``model`` and
  are replicated over ``data`` (one leaf per column shard, copied to each
  data row's cell, so autograd sums the rows' gradients);
- each L2 norm and each logit contracts over the split output dimension:
  the shards' partial sums are copied to the row's first device and added;
- in-batch negatives are the GLOBAL batch: every data row's projected docs
  are copied to every row.

Autograd runs through the cross-device copies. The step takes the gradient
of the loss JAX's step takes on a one-device mesh: the global-batch InfoNCE
plus, when ``l2sp > 0``, the whole ``l2sp * sum((w - w0)^2) / 1e4``, and
reports that loss. At ``model = 1`` this is JAX's step at every ``data``
size. At ``model = m > 1`` JAX's step moves ``W`` by ``lr * (m * grad_nll +
grad_penalty)`` and reports one model shard's penalty (the transpose of its
``psum``s inside ``value_and_grad`` under ``check_vma=False``); the port
does not copy that (``ROADMAP.md`` C).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from legalrag_tpu_torch.models.prng import jax_normal
from legalrag_tpu_torch.parallel.mesh import Cells, Mesh, as_cells, place


def _row_sum(parts: List[torch.Tensor], dev: torch.device) -> torch.Tensor:
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def make_contrastive_train_step(mesh: Mesh, lr: float = 1e-2,
                                temperature: float = 0.05,
                                l2sp: float = 0.0) -> Callable:
    """``step(w, q, d)``, or ``step(w, w0, q, d)`` when ``l2sp > 0`` ->
    ``(w', loss)``: ``w`` / ``w0`` [d_in, d_out] split by columns over
    ``model`` (a tensor or ``init_projection``'s grid), ``q`` / ``d`` [B,
    d_in] split by rows over ``data`` (B divisible by the data size); ``w'``
    a grid like ``w``, ``loss`` a 0-d tensor on the lead device."""
    nd, nm = mesh.devices.shape

    def step(w, *args):
        if l2sp > 0:
            w0, q, d = args
        else:
            (q, d), w0 = args, None
        leaves = [c.detach().requires_grad_(True)
                  for c in as_cells(mesh, w, model_dim=1)[0]]
        q_c = as_cells(mesh, q, data_dim=0)
        d_c = as_cells(mesh, d, data_dim=0)
        cell = mesh.devices

        def project(x: Cells) -> Cells:
            z = [[x[i][j] @ leaves[j].to(cell[i, j]) for j in range(nm)]
                 for i in range(nd)]
            out = []
            for i in range(nd):
                n2 = _row_sum([(zz * zz).sum(-1, keepdim=True)
                               for zz in z[i]], cell[i, 0])
                r = torch.rsqrt(torch.clamp(n2, min=1e-12))
                out.append([z[i][j] * r.to(cell[i, j]) for j in range(nm)])
            return out

        zq, zd = project(q_c), project(d_c)
        nll = []
        for i in range(nd):
            logits = _row_sum(
                [zq[i][j] @ torch.cat([zd[r][j].to(cell[i, j])
                                       for r in range(nd)]).T
                 for j in range(nm)], cell[i, 0]) / temperature
            b_local = logits.shape[0]
            labels = i * b_local + torch.arange(b_local, device=logits.device)
            nll.append(F.cross_entropy(logits, labels).to(mesh.lead))
        loss = _row_sum(nll, mesh.lead) / nd
        if l2sp > 0:
            w0_s = as_cells(mesh, w0, model_dim=1)[0]
            pen = _row_sum([((leaf - w0j.to(leaf.device)) ** 2).sum()
                            for leaf, w0j in zip(leaves, w0_s)], mesh.lead)
            loss = loss + l2sp * pen / 1e4
        grads = torch.autograd.grad(loss, leaves)
        new = [(leaf - lr * g).detach() for leaf, g in zip(leaves, grads)]
        return as_cells(mesh, new), loss.detach()

    return step


def init_projection(mesh: Mesh, d_in: int, d_out: int, seed: int = 0) -> Cells:
    """``normal(PRNGKey(seed), (d_in, d_out)) / sqrt(d_out)`` (the draw of
    ``models/prng.py``), split by columns over ``model``."""
    w = jax_normal(seed, (d_in, d_out)) / np.float32(np.sqrt(d_out))
    return place(mesh, torch.from_numpy(w), model_dim=1)


def full_projection(mesh: Mesh, w: Cells) -> torch.Tensor:
    """The [d_in, d_out] projection of a column-split grid, on the lead
    device."""
    return torch.cat([c.to(mesh.lead) for c in w[0]], dim=1)
