"""Per-client observability: confusion matrices, per-client metrics and
label distributions (``fedml_tpu.metrics.observability``).

The reference logs ``Client {i}/Train|Test/Acc|Loss`` a round with the
aggregate metrics, per-client confusion matrices and per-client class
counts. Here every client's slice is evaluated on the device with no
per-client Python loop for one global model: the real (client, sample)
pairs of a split are run in eval batches, and each pair's loss,
correctness and confusion cell are added into per-client sums with
``index_add_``. The JAX package vmaps all N clients at once, each
scanning its padded slice; an eval forward is per sample (BatchNorm on
its running statistics), so the batching changes the sums' order only,
and the confusion counts stay exact.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.data.federated import FederatedArrays


def confusion_matrix(pred: torch.Tensor, y: torch.Tensor, num_classes: int,
                     w: torch.Tensor | None = None) -> torch.Tensor:
    """``[K, K]`` counts, rows the true label, columns the prediction: the
    one-hot outer product ``(one_hot(y) * w)^T one_hot(pred)``."""
    if w is None:
        w = torch.ones(y.shape[0], device=y.device)
    t = F.one_hot(y.long(), num_classes).to(w.dtype) * w[:, None]
    p = F.one_hot(pred.long(), num_classes).to(w.dtype)
    return t.T @ p


def _pair_sums(model, variables, x, y, clients, samples, num_clients: int,
               num_classes: int, batch_size: int):
    """Per-client ``(loss sum, correct, confusion [N, K, K])`` over the
    (client, sample) pairs, in eval batches of ``batch_size``."""
    dev = x.device
    k = num_classes
    loss_sum = torch.zeros(num_clients, device=dev)
    correct = torch.zeros(num_clients, device=dev)
    cells = torch.zeros(num_clients * k * k, device=dev)
    for s in range(0, samples.shape[0], batch_size):
        c = clients[s:s + batch_size]
        take = samples[s:s + batch_size]
        yb = y[take].long()
        logits = model.apply_eval(variables, x[take]).float()
        pred = logits.argmax(-1)
        loss_sum.index_add_(0, c, F.cross_entropy(logits, yb,
                                                  reduction="none"))
        correct.index_add_(0, c, (pred == yb).float())
        cells.index_add_(0, (c * k + yb) * k + pred,
                         torch.ones(c.shape[0], device=dev))
    return loss_sum, correct, cells.reshape(num_clients, k, k)


def build_per_client_eval(model, num_classes: int, batch_size: int = 256,
                          stacked: bool = False):
    """``(variables, x, y, idx [N, M], mask [N, M]) -> {acc [N], loss [N],
    confusion [N, K, K], count [N]}``: every client's local test on the
    variables' device. ``stacked=True``: the variables carry a leading
    client axis (per-client models), and each client's rows run through
    its own."""

    @torch.no_grad()
    def evaluate(variables, x, y, idx, mask):
        n = idx.shape[0]
        clients, slots = torch.nonzero(mask > 0, as_tuple=True)
        samples = idx[clients, slots].long()
        if not stacked:
            loss_sum, correct, cm = _pair_sums(
                model, variables, x, y, clients, samples, n, num_classes,
                batch_size)
        else:
            parts = []
            for i in range(n):
                own = clients == i
                parts.append(_pair_sums(
                    model, {k: v[i] for k, v in variables.items()}, x, y,
                    torch.zeros_like(clients[own]), samples[own], 1,
                    num_classes, batch_size))
            loss_sum, correct, cm = (torch.cat(p) for p in zip(*parts))
        count = torch.sum(mask, 1)
        denom = torch.clamp(count, min=1.0)
        return {"acc": correct / denom, "loss": loss_sum / denom,
                "confusion": cm, "count": count}

    return evaluate


def label_distribution(arrays: FederatedArrays) -> np.ndarray:
    """``[N, K]`` per-client class counts (multi-hot tasks: the label mass
    a class)."""
    y = arrays.y.cpu().numpy()
    idx = arrays.idx.cpu().numpy()
    mask = arrays.mask.cpu().numpy()
    if y.ndim > 1:
        return np.stack([(mask[i][:, None] * y[idx[i]]).sum(0)
                         for i in range(arrays.num_clients)])
    k = arrays.num_classes
    out = np.zeros((arrays.num_clients, k))
    for i in range(arrays.num_clients):
        rows = idx[i][mask[i] > 0]
        out[i] = np.bincount(y[rows], minlength=k)[:k]
    return out


def log_per_client_observability(sink, model, variables,
                                 arrays: FederatedArrays, round_idx: int,
                                 prefix: str = "",
                                 include_confusion: bool = True,
                                 stacked: bool = False) -> dict:
    """Evaluate every client's train and test slice and log one record:
    ``Client {i}/Train|Test/Acc|Loss``, the count-weighted ``Train/Acc``
    and ``Test/Acc``, optionally the per-client test confusion matrices
    (``confusion_test``, nested lists) and the ``label_distribution``
    table. ``stacked=True``: ``variables`` carry a leading client axis."""
    ev = build_per_client_eval(model, arrays.num_classes, stacked=stacked)
    train = {k: v.cpu().numpy() for k, v in ev(
        variables, arrays.x, arrays.y, arrays.idx, arrays.mask).items()}
    test = {k: v.cpu().numpy() for k, v in ev(
        variables, arrays.test_x, arrays.test_y, arrays.test_idx,
        arrays.test_mask).items()}
    record: dict = {"round": round_idx}
    for i in range(arrays.num_clients):
        record[f"{prefix}Client {i}/Train/Acc"] = float(train["acc"][i])
        record[f"{prefix}Client {i}/Train/Loss"] = float(train["loss"][i])
        record[f"{prefix}Client {i}/Test/Acc"] = float(test["acc"][i])
        record[f"{prefix}Client {i}/Test/Loss"] = float(test["loss"][i])
    # weighted by the true sample counts (the reference sums num_correct
    # over num_samples across clients)
    tc, vc = train["count"], test["count"]
    record[f"{prefix}Train/Acc"] = float(
        np.sum(train["acc"] * tc) / max(tc.sum(), 1.0))
    record[f"{prefix}Test/Acc"] = float(
        np.sum(test["acc"] * vc) / max(vc.sum(), 1.0))
    if include_confusion:
        record[f"{prefix}confusion_test"] = test["confusion"].tolist()
    record[f"{prefix}label_distribution"] = label_distribution(
        arrays).tolist()
    sink.log(record)
    return record
