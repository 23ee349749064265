"""Large-scale cross-device vision sets: ImageNet (federated by class)
and Google Landmarks (the gld23k and gld160k user splits)
(``fedml_tpu.data.largescale``, numpy, copied).

- ImageNet: an ImageFolder tree ``train/<wnid>/*`` and ``val/<wnid>/*``;
  the classes are dealt to the clients in sorted order (1000 clients:
  one class each; 100 clients: 10 each).
- Landmarks: the mapping files ``data_user_dict/gld{23k,160k}_user_dict_
  {train,test}.csv`` with columns ``user_id,image_id,class``, the images
  at ``images/<image_id>.jpg``.

The readers decode into arrays (PIL, imported by ``_decode``) resized to
``image_size``; ``client_range`` decodes only those clients' training
images.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from fedml_tpu_torch.data.federated import FederatedData

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _decode(path: str, image_size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size))
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def _iter_image_folder(split_dir: str):
    """Yield (class_name, [file paths]) in sorted class order."""
    classes = sorted(
        c for c in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, c))
    )
    exts = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif")
    for c in classes:
        d = os.path.join(split_dir, c)
        files = [
            os.path.join(d, f)
            for f in sorted(os.listdir(d))
            if f.lower().endswith(exts)
        ]
        yield c, files


def load_imagenet(
    data_dir: str,
    client_number: int = 100,
    image_size: int = 64,
    max_per_class: int | None = None,
    client_range: tuple[int, int] | None = None,
) -> FederatedData:
    """Federated ImageNet: classes dealt to clients in sorted order —
    ``client_number=1000``: one class per client; ``client_number=100``:
    10 consecutive classes per client (reference
    ``load_partition_data_ImageNet:235-243``). Works on any ImageFolder
    tree (class count need not be 1000; classes are distributed evenly,
    remainder classes dealt one each to the first clients).
    ``client_range=(lo, hi)`` decodes only those clients' training
    images (per-shard loading)."""
    train_dir = os.path.join(data_dir, "train")
    val_dir = os.path.join(data_dir, "val")
    if not os.path.isdir(train_dir):
        raise FileNotFoundError(
            f"{train_dir} not found (ImageFolder tree train/<class>/*); "
            "use dataset='fake_cifar10'-style stand-ins for offline runs"
        )
    classes = [c for c, _ in _iter_image_folder(train_dir)]
    n_classes = len(classes)
    if n_classes < client_number:
        raise ValueError(
            f"{n_classes} classes cannot be dealt to {client_number} "
            "clients (need at least one class per client)"
        )
    # even dealing with remainder: client i gets classes
    # [bounds[i], bounds[i+1]) — sizes differ by at most one
    base, rem = divmod(n_classes, client_number)
    sizes = np.full(client_number, base, np.int64)
    sizes[:rem] += 1
    class_client = np.repeat(np.arange(client_number), sizes)
    class_to_client = {c: int(class_client[i]) for i, c in enumerate(classes)}
    lo, hi = client_range or (0, client_number)

    xs, ys, tr_map = [], [], {i: [] for i in range(client_number)}
    off = 0
    for ci, (c, files) in enumerate(_iter_image_folder(train_dir)):
        client = class_to_client[c]
        if not (lo <= client < hi):
            continue
        if max_per_class is not None:
            files = files[:max_per_class]
        for f in files:
            xs.append(_decode(f, image_size))
            ys.append(ci)
            tr_map[client].append(off)
            off += 1
    x_tr = np.stack(xs) if xs else np.zeros(
        (0, image_size, image_size, 3), np.float32
    )
    y_tr = np.asarray(ys, np.int32)
    tr_map = {k: np.asarray(v, np.int64) for k, v in tr_map.items()}

    class_idx = {c: i for i, c in enumerate(classes)}
    txs, tys = [], []
    if os.path.isdir(val_dir):
        for c, files in _iter_image_folder(val_dir):
            if c not in class_idx:
                raise ValueError(
                    f"val/ class {c!r} not present in train/"
                )
            if max_per_class is not None:
                files = files[:max_per_class]
            for f in files:
                txs.append(_decode(f, image_size))
                tys.append(class_idx[c])  # labels from the TRAIN class list
    x_te = np.stack(txs) if txs else x_tr[:1]
    y_te = np.asarray(tys, np.int32) if tys else y_tr[:1]
    # per-client test = the client's own classes (reference gives each
    # client its local loader over its dataidxs). Vectorized: one stable
    # argsort of each val image's owning client instead of a
    # clients x val-set python scan (50M iterations at 1000 x 50k).
    owner = class_client[np.clip(np.asarray(y_te), 0, n_classes - 1)]
    order = np.argsort(owner, kind="stable")
    split_at = np.searchsorted(owner[order], np.arange(client_number))
    split_bounds = np.append(split_at, len(order))
    te_map = {
        i: order[split_bounds[i]:split_bounds[i + 1]].astype(np.int64)
        for i in range(client_number)
    }
    return FederatedData(
        x_tr, y_tr, x_te, y_te, tr_map, te_map, n_classes
    )


def _read_landmarks_csv(path: str):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for col in ("user_id", "image_id", "class"):
        if rows and col not in rows[0]:
            raise ValueError(
                f"{path}: mapping csv must have user_id,image_id,class"
            )
    return rows


def load_landmarks(
    data_dir: str,
    split: str = "gld23k",
    image_size: int = 64,
    client_range: tuple[int, int] | None = None,
) -> FederatedData:
    """Google Landmarks federated split (reference
    ``load_partition_data_landmarks`` + ``get_mapping_per_user``): the
    ``data_user_dict/{split}_user_dict_train.csv`` mapping defines the
    natural per-user partition; images live at ``images/<image_id>.jpg``."""
    train_csv = os.path.join(
        data_dir, "data_user_dict", f"{split}_user_dict_train.csv"
    )
    test_csv = os.path.join(
        data_dir, "data_user_dict", f"{split}_user_dict_test.csv"
    )
    if not os.path.exists(train_csv):
        raise FileNotFoundError(
            f"{train_csv} not found (reference data/gld layout)"
        )
    img_dir = os.path.join(data_dir, "images")
    rows = _read_landmarks_csv(train_csv)
    users = sorted({r["user_id"] for r in rows}, key=lambda u: int(u))
    user_idx = {u: i for i, u in enumerate(users)}
    lo, hi = client_range or (0, len(users))

    xs, ys = [], []
    tr_map: dict[int, list] = {i: [] for i in range(len(users))}
    off = 0
    classes = sorted({int(r["class"]) for r in rows})
    n_classes = (max(classes) + 1) if classes else 1
    for r in rows:
        u = user_idx[r["user_id"]]
        if not (lo <= u < hi):
            continue
        p = os.path.join(img_dir, f"{r['image_id']}.jpg")
        if not os.path.exists(p):
            p = os.path.join(img_dir, f"{r['image_id']}.png")
        xs.append(_decode(p, image_size))
        ys.append(int(r["class"]))
        tr_map[u].append(off)
        off += 1
    x_tr = np.stack(xs) if xs else np.zeros(
        (0, image_size, image_size, 3), np.float32
    )
    y_tr = np.asarray(ys, np.int32)
    tr_map = {k: np.asarray(v, np.int64) for k, v in tr_map.items()}

    txs, tys = [], []
    te_map: dict[int, list] = {i: [] for i in range(len(users))}
    if os.path.exists(test_csv):
        for r in _read_landmarks_csv(test_csv):
            p = os.path.join(img_dir, f"{r['image_id']}.jpg")
            if not os.path.exists(p):
                p = os.path.join(img_dir, f"{r['image_id']}.png")
            # per-user test split when the user is known (reference
            # mapping csvs carry user_id in both splits); unknown test
            # users' samples stay global-only
            u = user_idx.get(r["user_id"])
            if u is not None:
                te_map[u].append(len(txs))
            txs.append(_decode(p, image_size))
            tys.append(int(r["class"]))
    x_te = np.stack(txs) if txs else x_tr[:1]
    y_te = np.asarray(tys, np.int32) if tys else y_tr[:1]
    te_map = {
        k: np.asarray(v, np.int64) for k, v in te_map.items()
    }
    return FederatedData(
        x_tr, y_tr, x_te, y_te, tr_map, te_map, n_classes
    )
