"""Federated dataset loaders.

Two families, as in the JAX package (``fedml_tpu.data.loaders``):

- **Readers of files on disk** under ``DataConfig.data_dir`` (the CLI's
  ``--data_dir``): MNIST and EMNIST IDX files (gzipped or raw), the
  CIFAR-10/100 python pickles, a CINIC-10 ImageFolder tree, the TFF h5
  and LEAF json splits (``data/natural.py``), ImageNet and Landmarks
  (``data/largescale.py``). A missing file raises
  ``FileNotFoundError`` naming its path; no reader falls back to a
  procedural set.
- **Procedural datasets** (``fake_<image>`` with the shapes and class
  counts of ``IMAGE_SPECS``, the fake text, segmentation and tag sets,
  and LEAF's ``synthetic(alpha, beta)``), drawn from numpy
  ``default_rng`` in the JAX package's order.

Both give arrays and partitions bitwise equal to the JAX package's.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct as pystruct

import numpy as np

from fedml_tpu_torch.config import DataConfig
from fedml_tpu_torch.data import partition as P
from fedml_tpu_torch.data.federated import (
    FederatedData,
    build_federated_data,
)
from fedml_tpu_torch.data.natural import synthetic_stackoverflow_nwp

# name -> (input_shape, num_classes) for image datasets (NHWC)
IMAGE_SPECS: dict[str, tuple[tuple[int, ...], int]] = {
    "mnist": ((28, 28, 1), 10),
    "emnist": ((28, 28, 1), 62),
    "femnist": ((28, 28, 1), 62),
    "cifar10": ((32, 32, 3), 10),
    "cifar100": ((32, 32, 3), 100),
    "cinic10": ((32, 32, 3), 10),
    "fed_cifar100": ((32, 32, 3), 100),
}
SHAKESPEARE_SEQ_LEN = 80  # char-LM window of the Shakespeare task
SHAKESPEARE_VOCAB = 90
STACKOVERFLOW_SEQ_LEN = 20


def make_synthetic(
    num_clients: int,
    alpha: float = 1.0,
    beta: float = 1.0,
    dim: int = 60,
    num_classes: int = 10,
    samples_low: int = 50,
    samples_high: int = 500,
    seed: int = 0,
) -> FederatedData:
    """LEAF/FedProx ``synthetic(alpha, beta)``: per client a logistic
    model ``y = argmax(W_k x + b_k)``, ``W_k ~ N(u_k, 1)``, ``u_k ~ N(0,
    alpha)``, ``x ~ N(v_k, Sigma)``, ``v_k ~ N(B_k, 1)``, ``B_k ~ N(0,
    beta)``: non-IID in model and features. Each client keeps 90% of its
    samples for training and the rest for test."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(
        rng.lognormal(4.0, 2.0, num_clients).astype(int) + samples_low,
        samples_high,
    )
    sigma = np.diag(np.arange(1, dim + 1, dtype=np.float64) ** -1.2)
    xs, ys, train_map, test_map = [], [], {}, {}
    off = 0
    for k in range(num_clients):
        u_k = rng.normal(0, alpha)
        b_center = rng.normal(0, beta)
        w = rng.normal(u_k, 1.0, (dim, num_classes))
        b = rng.normal(u_k, 1.0, num_classes)
        v_k = rng.normal(b_center, 1.0, dim)
        n = int(sizes[k])
        x = rng.multivariate_normal(v_k, sigma, n).astype(np.float32)
        xs.append(x)
        ys.append((x @ w + b).argmax(-1).astype(np.int32))
        n_train = max(1, int(0.9 * n))
        train_map[k] = np.arange(off, off + n_train)
        test_map[k] = np.arange(off + n_train, off + n)
        off += n
    x_all = np.concatenate(xs)
    y_all = np.concatenate(ys)
    # train and test share the flat arrays; the test maps are re-based
    # onto the test arrays
    test_idx = np.concatenate([test_map[k] for k in range(num_clients)])
    remap = {int(g): i for i, g in enumerate(test_idx)}
    test_map = {k: np.array([remap[int(g)] for g in v], np.int64)
                for k, v in test_map.items()}
    return FederatedData(x_all, y_all, x_all[test_idx], y_all[test_idx],
                         train_map, test_map, num_classes)


def _fake_image_arrays(
    name: str, n_train: int, n_test: int, seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Gaussian class prototypes plus noise: a learnable stand-in with the
    named dataset's shape and class count."""
    shape, num_classes = IMAGE_SPECS[name]
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (num_classes,) + shape).astype(np.float32)

    def gen(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        x = protos[y] * 0.5 + rng.normal(0, 1.0, (n,) + shape).astype(np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    return x_tr, y_tr, x_te, y_te, num_classes


def make_fake_image_dataset(
    name: str, cfg: DataConfig, n_train: int = 6000, n_test: int = 1000
) -> FederatedData:
    x_tr, y_tr, x_te, y_te, num_classes = _fake_image_arrays(
        name, n_train, n_test, cfg.seed
    )
    return build_federated_data(
        x_tr, y_tr, x_te, y_te, num_classes, cfg.num_clients,
        cfg.partition_method, cfg.partition_alpha, cfg.dataset_r, cfg.seed,
    )


def make_fake_text_dataset(
    cfg: DataConfig,
    seq_len: int = SHAKESPEARE_SEQ_LEN,
    vocab: int = SHAKESPEARE_VOCAB,
    n_train: int = 4000,
    n_test: int = 500,
) -> FederatedData:
    """Markov-chain token sequences for next-word/char prediction (a
    learnable stand-in for shakespeare / stackoverflow_nwp)."""
    rng = np.random.default_rng(cfg.seed)
    # sparse markov transition: each token has 8 likely successors
    succ = rng.integers(0, vocab, (vocab, 8))

    def gen(n):
        seq = np.zeros((n, seq_len + 1), np.int32)
        seq[:, 0] = rng.integers(0, vocab, n)
        for t in range(seq_len):
            choice = succ[seq[:, t], rng.integers(0, 8, n)]
            noise = rng.integers(0, vocab, n)
            take_noise = rng.random(n) < 0.1
            seq[:, t + 1] = np.where(take_noise, noise, choice)
        return seq[:, :-1], seq[:, 1:]

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    # homogeneous split over sequence index (labels are sequences)
    rng2 = np.random.default_rng(cfg.seed + 1)
    perm = rng2.permutation(n_train)
    train_map = {
        i: s for i, s in enumerate(np.array_split(perm, cfg.num_clients))
    }
    test_map = {
        i: s
        for i, s in enumerate(
            np.array_split(np.arange(n_test), cfg.num_clients)
        )
    }
    return FederatedData(
        x_tr, y_tr, x_te, y_te, train_map, test_map, vocab, task="nwp"
    )


def make_fake_segmentation_dataset(
    cfg: DataConfig,
    img_size: int = 32,
    num_classes: int = 4,
    n_train: int = 512,
    n_test: int = 64,
) -> FederatedData:
    """Procedural segmentation (the stand-in for pascal_voc and coco):
    each image holds one axis-aligned blob of each class 1..K-1 on the
    background 0, later blobs over earlier ones; ``y`` [N, H, W] int32 is
    the layout. The partition goes by each image's majority class, so a
    hetero partition still skews."""
    rng = np.random.default_rng(cfg.seed)

    def gen(n):
        x = rng.normal(0, 0.1, (n, img_size, img_size, 3)).astype(np.float32)
        y = np.zeros((n, img_size, img_size), np.int32)
        for i in range(n):
            for c in range(1, num_classes):
                cx, cy = rng.integers(0, img_size, 2)
                h, w = rng.integers(img_size // 4, img_size // 2, 2)
                y[i, cx:cx + h, cy:cy + w] = c
                x[i, cx:cx + h, cy:cy + w, :] += np.eye(3)[c % 3] * c
        return x, y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    rng2 = np.random.default_rng(cfg.seed)

    def majority(y):
        flat = y.reshape(y.shape[0], -1)
        return np.array(
            [np.bincount(r, minlength=num_classes).argmax() for r in flat],
            np.int64,
        )

    train_map = P.partition_indices_train(
        majority(y_tr), num_classes, cfg.partition_method, cfg.num_clients,
        cfg.partition_alpha, cfg.dataset_r, rng2,
    )
    test_map = P.partition_indices_test(
        majority(y_te), num_classes, cfg.num_clients
    )
    return FederatedData(
        x_tr, y_tr, x_te, y_te, train_map, test_map, num_classes,
        task="segmentation",
    )


def make_fake_tag_dataset(
    cfg: DataConfig,
    vocab: int = 1000,
    num_tags: int = 50,
    n_train: int = 4000,
    n_test: int = 500,
) -> FederatedData:
    """Multi-label bag-of-words tags (the stand-in for stackoverflow_lr):
    ``x`` [N, vocab] float32 word indicators, ``y`` [N, tags] float32
    multi-hot, a sample's tags those whose score through a sparse random
    word-tag map reaches its own 95th percentile; a homogeneous split."""
    rng = np.random.default_rng(cfg.seed)
    W = (rng.random((vocab, num_tags)) < 0.01).astype(np.float32)

    def gen(n):
        x = (rng.random((n, vocab)) < 0.02).astype(np.float32)
        score = x @ W
        y = (score >= np.quantile(score, 0.95, axis=1, keepdims=True)).astype(
            np.float32
        )
        return x, y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    rng2 = np.random.default_rng(cfg.seed + 1)
    perm = rng2.permutation(n_train)
    train_map = {
        i: s for i, s in enumerate(np.array_split(perm, cfg.num_clients))
    }
    test_map = {
        i: s
        for i, s in enumerate(
            np.array_split(np.arange(n_test), cfg.num_clients)
        )
    }
    return FederatedData(
        x_tr, y_tr, x_te, y_te, train_map, test_map, num_tags,
        task="tag_prediction",
    )


# ---------------------------------------------------------------------------
# Readers of files on disk
# ---------------------------------------------------------------------------


def _read_idx(path: str) -> np.ndarray:
    """An IDX file (MNIST's format), gzipped when its name ends in
    ``.gz``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = pystruct.unpack(">HBB", f.read(4))
        dims = pystruct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dt = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
              13: np.float32, 14: np.float64}[dtype_code]
        return np.frombuffer(f.read(), dtype=dt).reshape(dims)


def _find(data_dir: str, names: list[str]) -> str | None:
    for n in names:
        p = os.path.join(data_dir, n)
        if os.path.exists(p):
            return p
    return None


def load_mnist_arrays(data_dir: str):
    """MNIST from its four IDX files (``train-images-idx3-ubyte[.gz]``,
    ``train-labels-idx1-ubyte[.gz]``, ``t10k-...``), normalized by the
    reference's mean 0.1307 and std 0.3081."""
    files = {
        "x_tr": ["train-images-idx3-ubyte.gz", "train-images-idx3-ubyte"],
        "y_tr": ["train-labels-idx1-ubyte.gz", "train-labels-idx1-ubyte"],
        "x_te": ["t10k-images-idx3-ubyte.gz", "t10k-images-idx3-ubyte"],
        "y_te": ["t10k-labels-idx1-ubyte.gz", "t10k-labels-idx1-ubyte"],
    }
    paths = {k: _find(data_dir, v) for k, v in files.items()}
    if any(p is None for p in paths.values()):
        raise FileNotFoundError(
            f"MNIST IDX files not found under {data_dir}; fetch with the "
            "reference's data/MNIST/download_and_unzip.sh or use "
            "dataset='fake_mnist'"
        )
    x_tr = _read_idx(paths["x_tr"]).astype(np.float32)[..., None] / 255.0
    x_te = _read_idx(paths["x_te"]).astype(np.float32)[..., None] / 255.0
    return (
        (x_tr - 0.1307) / 0.3081,
        _read_idx(paths["y_tr"]).astype(np.int32),
        (x_te - 0.1307) / 0.3081,
        _read_idx(paths["y_te"]).astype(np.int32),
        10,
    )


def load_cifar_arrays(data_dir: str, name: str):
    """CIFAR-10 (``cifar-10-batches-py/data_batch_1..5``, ``test_batch``)
    or CIFAR-100 (``cifar-100-python/train``, ``test``) from the python
    pickles: ``b"data"`` ``[n, 3072]`` uint8 rows in CHW order, labels
    under ``b"labels"`` or ``b"fine_labels"``; NHWC float32 normalized
    by the reference's CIFAR-10 mean and std."""
    mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
    std = np.array([0.2470, 0.2435, 0.2616], np.float32)

    def parse(batch_path, label_key):
        with open(batch_path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(d[label_key], np.int32)
        return (x.astype(np.float32) / 255.0 - mean) / std, y

    if name == "cifar10":
        root = _find(data_dir, ["cifar-10-batches-py", "."])
        if root is None or not os.path.exists(
            os.path.join(root, "data_batch_1")
        ):
            raise FileNotFoundError(
                f"cifar-10-batches-py not found under {data_dir}; use "
                "dataset='fake_cifar10' for offline runs"
            )
        parts = [
            parse(os.path.join(root, f"data_batch_{i}"), b"labels")
            for i in range(1, 6)
        ]
        x_tr = np.concatenate([p[0] for p in parts])
        y_tr = np.concatenate([p[1] for p in parts])
        x_te, y_te = parse(os.path.join(root, "test_batch"), b"labels")
        return x_tr, y_tr, x_te, y_te, 10
    root = _find(data_dir, ["cifar-100-python", "."])
    if root is None or not os.path.exists(os.path.join(root, "train")):
        raise FileNotFoundError(
            f"cifar-100-python not found under {data_dir}; use "
            "dataset='fake_cifar100' for offline runs"
        )
    x_tr, y_tr = parse(os.path.join(root, "train"), b"fine_labels")
    x_te, y_te = parse(os.path.join(root, "test"), b"fine_labels")
    return x_tr, y_tr, x_te, y_te, 100


def load_emnist_arrays(data_dir: str, split: str = "balanced"):
    """EMNIST from its IDX files (``emnist-<split>-train-images-idx3-ubyte
    [.gz]`` and the rest; 47 classes for ``balanced``, 62 ``byclass``, 10
    ``digits``, 26 ``letters``), normalized at mean 0.5, std 0.5."""
    nc = {"balanced": 47, "byclass": 62, "digits": 10, "letters": 26}[split]
    files = {
        k: [f"emnist-{split}-{k2}-idx{d}-ubyte.gz",
            f"emnist-{split}-{k2}-idx{d}-ubyte"]
        for k, (k2, d) in {
            "x_tr": ("train-images", 3), "y_tr": ("train-labels", 1),
            "x_te": ("test-images", 3), "y_te": ("test-labels", 1),
        }.items()
    }
    paths = {k: _find(data_dir, v) for k, v in files.items()}
    if any(p is None for p in paths.values()):
        raise FileNotFoundError(
            f"EMNIST ({split}) IDX files not found under {data_dir}; fetch "
            "with the reference's data scripts or use dataset='fake_emnist'"
        )
    x_tr = _read_idx(paths["x_tr"]).astype(np.float32)[..., None] / 255.0
    x_te = _read_idx(paths["x_te"]).astype(np.float32)[..., None] / 255.0
    return (
        (x_tr - 0.5) / 0.5,
        _read_idx(paths["y_tr"]).astype(np.int32),
        (x_te - 0.5) / 0.5,
        _read_idx(paths["y_te"]).astype(np.int32),
        nc,
    )


def load_image_folder_arrays(data_dir: str, name: str = "cinic10"):
    """A CINIC-10-style ImageFolder tree, ``<root>/train/<class>/*.png``
    and ``<root>/test/<class>/*.png`` (a ``valid/`` split, where present,
    joins train), decoded with PIL (imported here) and normalized by
    CINIC-10's mean and std. The class ids come from ``train/``."""
    from PIL import Image

    mean = np.array([0.47889522, 0.47227842, 0.43047404], np.float32)
    std = np.array([0.24205776, 0.23828046, 0.25874835], np.float32)
    root = _find(data_dir, [name, "CINIC-10", "."])
    if root is None or not os.path.isdir(os.path.join(root, "train")):
        raise FileNotFoundError(
            f"ImageFolder tree (train/<class>/*.png) not found under "
            f"{data_dir}; use dataset='fake_{name}' for offline runs"
        )
    train_dir = os.path.join(root, "train")
    classes = sorted(
        c
        for c in os.listdir(train_dir)
        if os.path.isdir(os.path.join(train_dir, c))
    )
    class_id = {c: i for i, c in enumerate(classes)}

    def read_split(split):
        d = os.path.join(root, split)
        if not os.path.isdir(d):
            return None, None
        extra = [
            c
            for c in os.listdir(d)
            if os.path.isdir(os.path.join(d, c)) and c not in class_id
        ]
        if extra:
            raise ValueError(
                f"{d} has class dirs {extra} not present in train/"
            )
        xs, ys = [], []
        for c in classes:
            cd = os.path.join(d, c)
            if not os.path.isdir(cd):
                continue
            for fn in sorted(os.listdir(cd)):
                if not fn.lower().endswith((".png", ".jpg", ".jpeg")):
                    continue
                img = np.asarray(
                    Image.open(os.path.join(cd, fn)).convert("RGB"),
                    np.float32,
                ) / 255.0
                xs.append((img - mean) / std)
                ys.append(class_id[c])
        if not xs:
            return None, None
        return np.stack(xs), np.asarray(ys, np.int32)

    x_tr, y_tr = read_split("train")
    x_te, y_te = read_split("test")
    if x_tr is None or x_te is None:
        raise FileNotFoundError(
            f"empty ImageFolder tree under {root}; use "
            f"dataset='fake_{name}'"
        )
    x_va, y_va = read_split("valid")
    if x_va is not None:
        x_tr = np.concatenate([x_tr, x_va])
        y_tr = np.concatenate([y_tr, y_va])
    return x_tr, y_tr, x_te, y_te, max(len(classes), 1)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def load_dataset(cfg: DataConfig) -> FederatedData:
    """Dataset dispatch, in the JAX package's order: the procedural sets
    by name, then the readers of ``cfg.data_dir`` (``femnist``,
    ``fed_cifar100``, ``leaf_<femnist|celeba|shakespeare|synthetic>``,
    ``shakespeare``, ``stackoverflow_nwp``, ``stackoverflow_lr``,
    ``imagenet``, ``gld23k``/``gld160k``/``landmarks``, ``mnist``,
    ``cifar10``, ``cifar100``, ``emnist``, ``cinic10``); the image arrays
    are partitioned by ``cfg.partition_method``. Any other name raises
    ``ValueError``."""
    from fedml_tpu_torch.data import largescale, natural

    name = cfg.dataset.lower()
    if name == "synthetic_stackoverflow_nwp":
        # before the synthetic_<a>_<b> family: the explicitly named
        # StackOverflow-shaped stand-in
        return synthetic_stackoverflow_nwp(num_clients=cfg.num_clients,
                                           seed=cfg.seed)
    if name.startswith("synthetic"):
        # "synthetic", "synthetic_1_1", "synthetic_0.5_0.5", ...
        parts = name.split("_")
        a = float(parts[1]) if len(parts) > 1 else 1.0
        b = float(parts[2]) if len(parts) > 2 else 1.0
        return make_synthetic(cfg.num_clients, a, b, seed=cfg.seed)
    if name.startswith("fake_"):
        base = name[len("fake_"):]
        if base in IMAGE_SPECS:
            return make_fake_image_dataset(base, cfg)
        if base in ("shakespeare", "fed_shakespeare"):
            return make_fake_text_dataset(cfg)
        if base == "stackoverflow_nwp":
            return make_fake_text_dataset(
                cfg, seq_len=STACKOVERFLOW_SEQ_LEN, vocab=2000
            )
        if base == "stackoverflow_lr":
            return make_fake_tag_dataset(cfg)
        if base in ("pascal_voc", "coco_seg", "seg"):
            return make_fake_segmentation_dataset(cfg)
        raise ValueError(f"unknown fake dataset: {name}")
    if name in ("femnist", "fed_emnist", "federated_emnist"):
        return natural.load_federated_emnist(cfg.data_dir)
    if name == "fed_cifar100":
        return natural.load_fed_cifar100(cfg.data_dir)
    if name.startswith("leaf_"):
        base = name[len("leaf_"):]
        if base in ("shakespeare", "fed_shakespeare"):
            return natural.load_leaf_json(
                cfg.data_dir, natural.SHAKESPEARE_VOCAB_SIZE, task="nwp",
                offline_hint="fake_shakespeare", text=True,
            )
        if base == "synthetic":
            # the LEAF synthetic(a, b) files; (a, b) from the directory's
            # name (synthetic_1_1, ...), needed only to rebuild a missing
            # train/mytrain.json
            parts = os.path.basename(
                os.path.normpath(cfg.data_dir)
            ).split("_")
            a = b = None
            if len(parts) == 3 and parts[0] == "synthetic":
                try:
                    a, b = float(parts[1]), float(parts[2])
                except ValueError:
                    a = b = None
            return natural.load_synthetic_leaf(cfg.data_dir, a, b)
        shapes = {"femnist": ((28, 28, 1), 62), "celeba": ((84, 84, 3), 2)}
        if base not in shapes:
            raise ValueError(
                f"unsupported LEAF dataset: {base} (numeric-feature LEAF "
                f"sets supported: {sorted(shapes)})"
            )
        shape, nc2 = shapes[base]
        return natural.load_leaf_json(
            cfg.data_dir, nc2, x_shape=shape,
            offline_hint="fake_femnist" if base == "femnist" else None,
        )
    if name in ("fed_shakespeare", "shakespeare"):
        return natural.load_fed_shakespeare(cfg.data_dir)
    if name == "stackoverflow_nwp":
        return natural.load_stackoverflow_nwp(cfg.data_dir)
    if name == "stackoverflow_lr":
        return natural.load_stackoverflow_lr(cfg.data_dir)
    if name in ("imagenet", "ilsvrc2012"):
        return largescale.load_imagenet(cfg.data_dir,
                                        client_number=cfg.num_clients)
    if name in ("gld23k", "gld160k", "landmarks"):
        return largescale.load_landmarks(
            cfg.data_dir, split="gld160k" if name == "gld160k" else "gld23k"
        )
    if name == "mnist":
        x_tr, y_tr, x_te, y_te, nc = load_mnist_arrays(cfg.data_dir)
    elif name in ("cifar10", "cifar100"):
        x_tr, y_tr, x_te, y_te, nc = load_cifar_arrays(cfg.data_dir, name)
    elif name == "emnist":
        x_tr, y_tr, x_te, y_te, nc = load_emnist_arrays(cfg.data_dir)
    elif name == "cinic10":
        x_tr, y_tr, x_te, y_te, nc = load_image_folder_arrays(
            cfg.data_dir, name
        )
    else:
        raise ValueError(f"unknown dataset: {cfg.dataset}")
    return build_federated_data(
        x_tr, y_tr, x_te, y_te, nc, cfg.num_clients,
        cfg.partition_method, cfg.partition_alpha, cfg.dataset_r, cfg.seed,
    )
