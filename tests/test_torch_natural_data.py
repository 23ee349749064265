"""The port's readers of data on disk against the JAX package's: each test
writes tiny files in each format's published layout under ``tmp_path``
(IDX, the CIFAR pickles, an ImageFolder tree, the TFF h5 and LEAF json
splits, the Landmarks csvs, the UCI files, the Southwest pickles), and
both packages read them. Arrays, index maps and class counts must be
bitwise equal; a missing file raises the same exception with the same
message in both."""

import csv
import gzip
import json
import os
import pickle
import struct

import h5py
import numpy as np
import pytest
from PIL import Image

from fedml_tpu.config import DataConfig as JaxDataConfig
from fedml_tpu.data import largescale as JL
from fedml_tpu.data import loaders as JD
from fedml_tpu.data import natural as JN
from fedml_tpu.data import streaming as JS
from fedml_tpu.data.federated import FederatedData as JaxFederatedData
from fedml_tpu_torch.config import DataConfig
from fedml_tpu_torch.data import largescale as TL
from fedml_tpu_torch.data import loaders as TD
from fedml_tpu_torch.data import natural as TN
from fedml_tpu_torch.data import streaming as TS
from fedml_tpu_torch.data.federated import FederatedData
from tests.torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(7)


def _assert_same_data(got, want):
    """Two FederatedData (or array tuples) bitwise equal: arrays with
    their dtypes, the index maps, the class count and the task."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
        return
    for f in ("x_train", "y_train", "x_test", "y_test"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("train_idx_map", "test_idx_map"):
        g, w = getattr(got, f), getattr(want, f)
        assert list(g) == list(w), f
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{f}[{k}]")
    assert (got.num_classes, got.task) == (want.num_classes, want.task)


# ---------------------------------------------------------------------------
# writers of each layout (tiny, seeded)
# ---------------------------------------------------------------------------


def _write_idx(path, arr):
    code = {np.uint8: 8, np.int32: 12}[arr.dtype.type]
    head = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    body = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
        f.write(head + body)


def _write_mnist(d, prefix="", gz=True, n=(40, 12), k=10):
    os.makedirs(d, exist_ok=True)
    ext = ".gz" if gz else ""
    names = {"train-images": 3, "train-labels": 1, "t10k-images": 3,
             "t10k-labels": 1} if not prefix else {
        "train-images": 3, "train-labels": 1, "test-images": 3,
        "test-labels": 1}
    for stem, dims in names.items():
        rows = n[0] if stem.startswith("train") else n[1]
        arr = (RNG.integers(0, 256, (rows, 28, 28)) if dims == 3
               else RNG.integers(0, k, rows)).astype(np.uint8)
        _write_idx(os.path.join(d, f"{prefix}{stem}-idx{dims}-ubyte{ext}"),
                   arr)


def _cifar_batch(path, n, label_key, k):
    blob = {b"data": RNG.integers(0, 256, (n, 3072)).astype(np.uint8),
            label_key: [int(v) for v in RNG.integers(0, k, n)]}
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def _write_cifar10(d, n=12):
    root = os.path.join(d, "cifar-10-batches-py")
    os.makedirs(root)
    for i in range(1, 6):
        _cifar_batch(os.path.join(root, f"data_batch_{i}"), n, b"labels", 10)
    _cifar_batch(os.path.join(root, "test_batch"), n, b"labels", 10)


def _write_cifar100(d, n=30):
    root = os.path.join(d, "cifar-100-python")
    os.makedirs(root)
    for split in ("train", "test"):
        _cifar_batch(os.path.join(root, split), n, b"fine_labels", 100)


def _write_png(path, hw=(32, 32)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(RNG.integers(0, 256, hw + (3,)).astype(np.uint8)).save(
        path)


def _write_image_folder(root, splits, classes, per=3, hw=(32, 32),
                        ext=".png"):
    for split in splits:
        for c in classes:
            for j in range(per):
                _write_png(os.path.join(root, split, c, f"{j:03d}{ext}"), hw)


def _write_tff(path, fields):
    """``fields``: {client id: {field: array}}."""
    with h5py.File(path, "w") as f:
        ex = f.create_group("examples")
        for cid, cols in fields.items():
            g = ex.create_group(cid)
            for name, arr in cols.items():
                g.create_dataset(name, data=arr)


SNIPPETS = ["To be, or not to be: that is the question",
            "All the world's a stage, and all the men and women merely "
            "players; they have their exits and their entrances",
            "Now is the winter of our discontent ~ made glorious summer"]
SENTENCES = ["how do i parse json in python", "why is my loop slow",
             "segfault when i free a pointer twice in c",
             "what does yield do"]


def _write_tff_sets(d):
    os.makedirs(d, exist_ok=True)
    for split, n in (("train", 3), ("test", 3)):
        _write_tff(os.path.join(d, f"fed_emnist_{split}.h5"), {
            f"f{c:04d}": {"pixels": RNG.random((4 + c, 28, 28)).astype(
                np.float32), "label": RNG.integers(0, 62, 4 + c)}
            for c in range(n)})
        _write_tff(os.path.join(d, f"fed_cifar100_{split}.h5"), {
            str(c): {"image": RNG.integers(0, 256, (3 + c, 32, 32, 3)
                                           ).astype(np.uint8),
                     "label": RNG.integers(0, 100, 3 + c)}
            for c in range(n)})
        _write_tff(os.path.join(d, f"shakespeare_{split}.h5"), {
            f"c{c}": {"snippets": np.array(
                [s.encode() for s in SNIPPETS[c:] + SNIPPETS[:c]],
                dtype=object)} for c in range(n)})
        _write_tff(os.path.join(d, f"stackoverflow_{split}.h5"), {
            f"{c:08d}": {
                "tokens": np.array([s.encode() for s in SENTENCES[c:]],
                                   dtype=object),
                "tags": np.array([t.encode() for t in
                                  ["python|json", "c|pointers", "java",
                                   "python|generators"][c:]],
                                 dtype=object)}
            for c in range(n)})
    with open(os.path.join(d, "stackoverflow.word_count"), "w") as f:
        words = sorted({w for s in SENTENCES for w in s.split()})
        for i, w in enumerate(words[:-3]):  # the last three words are oov
            f.write(f"{w} {100 - i}\n")
    with open(os.path.join(d, "stackoverflow.tag_count"), "w") as f:
        json.dump({"python": 9, "json": 4, "c": 3, "java": 2}, f)


def _leaf_json(d, split, users):
    os.makedirs(os.path.join(d, split), exist_ok=True)
    for part, chunk in enumerate((users[:2], users[2:])):
        blob = {"users": [u for u, _ in chunk],
                "num_samples": [len(v["y"]) for _, v in chunk],
                "user_data": dict(chunk)}
        with open(os.path.join(d, split, f"part_{part}.json"), "w") as f:
            json.dump(blob, f)


def _write_leaf_femnist(d, users=3, dim=28 * 28):
    for split in ("train", "test"):
        # the last user has no test data (LEAF's by-user split)
        n_users = users if split == "train" else users - 1
        _leaf_json(d, split, [
            (f"f_{u:05d}", {"x": RNG.random((3 + u, dim)).round(4).tolist(),
                            "y": RNG.integers(0, 62, 3 + u).tolist()})
            for u in range(n_users)])


def _write_leaf_shakespeare(d, users=3):
    text = " ".join(SNIPPETS)
    for split in ("train", "test"):
        rows = []
        for u in range(users):
            xs = [text[i:i + 80] for i in range(u, u + 4)]
            ys = [text[i + 80] for i in range(u, u + 4)]
            rows.append((f"USER_{u}", {"x": xs, "y": ys}))
        _leaf_json(d, split, rows)


def _write_leaf_synthetic(d, users=3, with_train=False):
    """The FedProx generator's data, its test split a seeded tenth of
    each user's rows; with ``with_train`` the rest as mytrain.json."""
    full = JN._fedprox_synthetic_full(1.0, 1.0, users)
    test, train = {}, {}
    for u, (x, y) in enumerate(full):
        pick = np.sort(RNG.choice(len(x), max(2, len(x) // 10),
                                  replace=False))
        rest = np.setdiff1d(np.arange(len(x)), pick)
        test[f"f_{u:05d}"] = {"x": x[pick].tolist(), "y": y[pick].tolist()}
        train[f"f_{u:05d}"] = {"x": x[rest].tolist(), "y": y[rest].tolist()}
    for split, data in (("test", test), ("train", train)):
        if split == "train" and not with_train:
            continue
        os.makedirs(os.path.join(d, split), exist_ok=True)
        with open(os.path.join(d, split, f"my{split}.json"), "w") as f:
            json.dump({"users": list(data), "user_data": data}, f)


def _write_landmarks(d, split="gld23k"):
    os.makedirs(os.path.join(d, "data_user_dict"))
    rows = {"train": [(u, f"img{u}_{j}", int(RNG.integers(0, 5)))
                      for u in (2, 0, 10) for j in range(2)],
            "test": [(0, "t0", 1), (99, "t1", 3), (10, "t2", 4)]}
    for part, rs in rows.items():
        with open(os.path.join(d, "data_user_dict",
                               f"{split}_user_dict_{part}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["user_id", "image_id", "class"])
            for u, img, c in rs:
                w.writerow([u, img, c])
                ext = ".png" if img.endswith("_1") else ".jpg"
                _write_png(os.path.join(d, "images", img + ext), (20, 24))


def _write_uci(d):
    os.makedirs(os.path.join(d, "room_occupancy"))
    with open(os.path.join(d, "SUSY.csv"), "w") as f:
        for _ in range(300):
            f.write(",".join([f"{float(RNG.integers(0, 2)):.1f}"]
                             + [f"{v:.6f}" for v in RNG.normal(size=18)])
                    + "\n")
    with open(os.path.join(d, "room_occupancy", "datatraining.txt"),
              "w") as f:
        f.write('"date","Temperature","Humidity","Light","CO2",'
                '"HumidityRatio","Occupancy"\n')
        for i in range(250):
            vals = RNG.normal(size=5)
            f.write(f'"{i + 1}","2015-02-04 17:{i % 60:02d}:00",'
                    + ",".join(f"{v:.4f}" for v in vals)
                    + f",{int(RNG.integers(0, 2))}\n")


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gz", [True, False])
def test_idx_readers_match_jax(tmp_path, gz):
    d = str(tmp_path)
    _write_mnist(d, gz=gz)
    _write_mnist(d, prefix="emnist-balanced-", gz=gz, k=47)
    name = "train-images-idx3-ubyte" + (".gz" if gz else "")
    _assert_same_data((TD._read_idx(os.path.join(d, name)),),
                      (JD._read_idx(os.path.join(d, name)),))
    _assert_same_data(TD.load_mnist_arrays(d), JD.load_mnist_arrays(d))
    _assert_same_data(TD.load_emnist_arrays(d), JD.load_emnist_arrays(d))
    assert TD._find(d, ["nope", name]) == JD._find(d, ["nope", name])


def test_cifar_and_image_folder_readers_match_jax(tmp_path):
    d = str(tmp_path)
    _write_cifar10(d)
    _write_cifar100(d)
    for name in ("cifar10", "cifar100"):
        _assert_same_data(TD.load_cifar_arrays(d, name),
                          JD.load_cifar_arrays(d, name))
    root = os.path.join(d, "cinic10")
    _write_image_folder(root, ("train", "test"), ("airplane", "cat", "dog"))
    # a valid/ split joins train; a class missing from one split is fine
    _write_image_folder(root, ("valid",), ("cat",), per=2, ext=".jpg")
    _assert_same_data(TD.load_image_folder_arrays(d),
                      JD.load_image_folder_arrays(d))
    _write_png(os.path.join(root, "test", "zebra", "0.png"))
    with pytest.raises(ValueError) as terr:
        TD.load_image_folder_arrays(d)
    with pytest.raises(ValueError) as jerr:
        JD.load_image_folder_arrays(d)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("reader", [
    "load_federated_emnist", "load_fed_cifar100", "load_fed_shakespeare",
    "load_stackoverflow_nwp", "load_stackoverflow_lr"])
def test_tff_h5_readers_match_jax(tmp_path, reader):
    d = str(tmp_path)
    _write_tff_sets(d)
    _assert_same_data(getattr(TN, reader)(d), getattr(JN, reader)(d))
    pairs = list(TN.load_tff_h5_pairs(os.path.join(
        d, "fed_cifar100_train.h5"), "image", "label"))
    want = list(JN.load_tff_h5_pairs(os.path.join(
        d, "fed_cifar100_train.h5"), "image", "label"))
    assert [p[0] for p in pairs] == [w[0] for w in want]
    for p, w in zip(pairs, want):
        _assert_same_data(p[1:], w[1:])


@pytest.mark.parametrize("kind", ["femnist", "shakespeare", "celeba"])
def test_leaf_json_readers_match_jax(tmp_path, kind):
    d = str(tmp_path)
    if kind == "shakespeare":
        _write_leaf_shakespeare(d)
        kw = dict(num_classes=TN.SHAKESPEARE_VOCAB_SIZE, task="nwp",
                  text=True)
    else:
        shape = (28, 28, 1) if kind == "femnist" else (4, 4, 3)
        _write_leaf_femnist(d, dim=int(np.prod(shape)))
        kw = dict(num_classes=62, x_shape=shape)
    _assert_same_data(TN.load_leaf_json(d, **kw), JN.load_leaf_json(d, **kw))
    xs, ys = ["abc~" * 5, "hello world~ 1234567"], ["d", ""]
    _assert_same_data(TN._leaf_text_to_arrays(xs, ys),
                      JN._leaf_text_to_arrays(xs, ys))


@pytest.mark.parametrize("with_train", [False, True])
def test_leaf_synthetic_reconstruction_matches_jax(tmp_path, with_train):
    d = os.path.join(str(tmp_path), "synthetic_1_1")
    _write_leaf_synthetic(d, with_train=with_train)
    got = TN.load_synthetic_leaf(d, 1.0, 1.0)
    _assert_same_data(got, JN.load_synthetic_leaf(d, 1.0, 1.0))
    # the legacy np.random.seed(0) stream, replayed exactly
    for (tx, ty), (jx, jy) in zip(TN._fedprox_synthetic_full(0.5, 0.5, 3),
                                  JN._fedprox_synthetic_full(0.5, 0.5, 3)):
        _assert_same_data((tx, ty), (jx, jy))
    if not with_train:
        for mod in (TN, JN):
            with pytest.raises(ValueError, match="could not be parsed"):
                mod.load_synthetic_leaf(d, None, None)


def test_imagenet_and_landmarks_match_jax(tmp_path):
    d = os.path.join(str(tmp_path), "imagenet")
    classes = [f"n{i:08d}" for i in range(5)]
    _write_image_folder(d, ("train",), classes, per=2, hw=(20, 24))
    _write_image_folder(d, ("val",), classes[:4], per=1, hw=(16, 16))
    for kw in (dict(client_number=2, image_size=8),
               dict(client_number=5, image_size=8, max_per_class=1,
                    client_range=(1, 3))):
        _assert_same_data(TL.load_imagenet(d, **kw),
                          JL.load_imagenet(d, **kw))
    for mod in (TL, JL):
        with pytest.raises(ValueError, match="cannot be dealt"):
            mod.load_imagenet(d, client_number=6)
    g = os.path.join(str(tmp_path), "gld")
    _write_landmarks(g)
    for kw in (dict(image_size=8), dict(image_size=8, client_range=(0, 2))):
        _assert_same_data(TL.load_landmarks(g, **kw),
                          JL.load_landmarks(g, **kw))


@pytest.mark.parametrize("name", ["susy", "ro"])
def test_uci_streams_match_jax(tmp_path, name):
    d = str(tmp_path)
    _write_uci(d)
    for beta in (0.0, 0.25):
        got = TS.load_uci_stream(name, d, 4, 30, beta=beta, seed=2)
        want = JS.load_uci_stream(name, d, 4, 30, beta=beta, seed=2)
        _assert_same_data(got, want)
    path = os.path.join(d, "SUSY.csv")
    _assert_same_data(TS.load_susy_csv(path, 50), JS.load_susy_csv(path, 50))
    path = os.path.join(d, "room_occupancy", "datatraining.txt")
    _assert_same_data(TS.load_room_occupancy_txt(path),
                      JS.load_room_occupancy_txt(path))


def _poison_base():
    x = RNG.normal(size=(40, 8, 8, 1)).astype(np.float32)
    y = RNG.integers(0, 4, 40).astype(np.int32)
    xt = RNG.normal(size=(10, 8, 8, 1)).astype(np.float32)
    yt = RNG.integers(0, 4, 10).astype(np.int32)
    tr = {0: np.arange(0, 15), 1: np.arange(15, 16), 2: np.arange(16, 40)}
    te = {i: np.arange(3 * i, 3 * i + 3) for i in range(3)}
    args = (x, y, xt, yt, tr, te, 4)
    return FederatedData(*args), JaxFederatedData(*args)


def test_backdoor_and_edge_case_sets_match_jax(tmp_path):
    tdata, jdata = _poison_base()
    x = tdata.x_train[:3]
    np.testing.assert_array_equal(TN.add_pixel_trigger(x, 2),
                                  JN.add_pixel_trigger(x, 2))
    kw = dict(target_label=3, poison_fraction=0.5, attacker_clients=(0, 1),
              trigger_size=2, seed=4)
    got = TN.make_backdoor_dataset(tdata, **kw)
    want = JN.make_backdoor_dataset(jdata, **kw)
    _assert_same_data(got[0], want[0])
    _assert_same_data(got[1:], want[1:])
    tpool = TN.make_procedural_edge_pool(tdata, 12, 5, seed=1)
    jpool = JN.make_procedural_edge_pool(jdata, 12, 5, seed=1)
    _assert_same_data((tpool.x_train, tpool.x_test, tpool.target_label),
                      (jpool.x_train, jpool.x_test, jpool.target_label))
    for case in ("edge-case", "almost-edge-case", "normal-case"):
        got = TN.make_edge_case_backdoor(tdata, tpool, (0, 2), case, 0.4, 3)
        want = JN.make_edge_case_backdoor(jdata, jpool, (0, 2), case, 0.4, 3)
        _assert_same_data(got[0], want[0])
        _assert_same_data(got[1:], want[1:])
    d = str(tmp_path)
    for split, n in (("train", 6), ("test", 4)):
        with open(os.path.join(d, f"southwest_images_new_{split}.pkl"),
                  "wb") as f:
            pickle.dump(RNG.integers(0, 256, (n, 8, 8, 3)).astype(np.uint8),
                        f)
    tsw, jsw = TN.load_southwest_pool(d), JN.load_southwest_pool(d)
    _assert_same_data((tsw.x_train, tsw.x_test, tsw.target_label),
                      (jsw.x_train, jsw.x_test, jsw.target_label))


def test_backdoor_success_rate_on_converted_weights():
    import jax

    from fedml_tpu.config import ModelConfig as JaxModelConfig
    from fedml_tpu.models import create_model as jax_create_model
    from fedml_tpu_torch.config import ModelConfig
    from fedml_tpu_torch.convert import vision_state_dict
    from fedml_tpu_torch.models import create_model

    tdata, jdata = _poison_base()
    kw = dict(name="lr", num_classes=4, input_shape=(8, 8, 1))
    jmodel = jax_create_model(JaxModelConfig(**kw))
    variables = jmodel.init(jax.random.key(3))
    _, trig_x, trig_y = JN.make_backdoor_dataset(jdata, target_label=1,
                                                 trigger_size=2)
    tmodel = create_model(ModelConfig(**kw), "cpu")
    tvars = vision_state_dict(jax.device_get(variables), "LogisticRegression")
    want = JN.backdoor_success_rate(jmodel, variables, trig_x, trig_y)
    got = TN.backdoor_success_rate(tmodel, tvars, trig_x, trig_y)
    assert got == want and 0.0 < want < 1.0


# ---------------------------------------------------------------------------
# load_dataset: every name the JAX dispatch reads
# ---------------------------------------------------------------------------

# name -> (writer, the data_dir below tmp_path)
DISK_NAMES = {
    "femnist": (_write_tff_sets, "tff"),
    "fed_emnist": (_write_tff_sets, "tff"),
    "federated_emnist": (_write_tff_sets, "tff"),
    "fed_cifar100": (_write_tff_sets, "tff"),
    "fed_shakespeare": (_write_tff_sets, "tff"),
    "shakespeare": (_write_tff_sets, "tff"),
    "stackoverflow_nwp": (_write_tff_sets, "tff"),
    "stackoverflow_lr": (_write_tff_sets, "tff"),
    "leaf_femnist": (_write_leaf_femnist, "leaf"),
    "leaf_celeba": (lambda d: _write_leaf_femnist(d, dim=84 * 84 * 3),
                    "leaf"),
    "leaf_shakespeare": (_write_leaf_shakespeare, "leaf"),
    "leaf_fed_shakespeare": (_write_leaf_shakespeare, "leaf"),
    "leaf_synthetic": (_write_leaf_synthetic, "synthetic_1_1"),
    "imagenet": (lambda d: _write_image_folder(
        d, ("train", "val"), [f"n{i}" for i in range(4)], per=1,
        hw=(8, 8)), "imagenet"),
    "ilsvrc2012": (lambda d: _write_image_folder(
        d, ("train",), [f"n{i}" for i in range(4)], per=1, hw=(8, 8)),
        "imagenet"),
    "gld23k": (_write_landmarks, "gld"),
    "landmarks": (_write_landmarks, "gld"),
    "gld160k": (lambda d: _write_landmarks(d, "gld160k"), "gld"),
    "mnist": (_write_mnist, "mnist"),
    "emnist": (lambda d: _write_mnist(d, "emnist-balanced-", False, k=47),
               "emnist"),
    "cifar10": (_write_cifar10, "cifar"),
    "cifar100": (_write_cifar100, "cifar"),
    "cinic10": (lambda d: _write_image_folder(
        os.path.join(d, "CINIC-10"), ("train", "test"), ("a", "b"), per=2),
        "cinic"),
}


def _both(name, data_dir, **kw):
    """Each package's load_dataset, or the exception it raised."""
    out = []
    for cfg_cls, load in ((DataConfig, TD.load_dataset),
                          (JaxDataConfig, JD.load_dataset)):
        cfg = cfg_cls(dataset=name, data_dir=data_dir, num_clients=4,
                      seed=3, **kw)
        try:
            out.append(load(cfg))
        except Exception as err:  # compared below, type and message
            out.append(err)
    return out


@pytest.mark.parametrize("name", sorted(DISK_NAMES))
def test_load_dataset_reads_every_jax_name(tmp_path, name):
    """The files present: the port's FederatedData is the JAX package's
    bit for bit. Missing: the same exception, naming the path."""
    write, sub = DISK_NAMES[name]
    d = os.path.join(str(tmp_path), sub)
    missing = _both(name, d)
    assert all(isinstance(e, FileNotFoundError) for e in missing), missing
    assert str(missing[0]) == str(missing[1]) and d in str(missing[0])
    os.makedirs(d, exist_ok=True)
    write(d)
    # a homogeneous split: the LDA draw of a set this small redraws until
    # every client holds 10 samples (tests/test_torch_data.py holds the
    # partitions against the JAX package's)
    got, want = _both(name, d, partition_method="homo")
    assert not isinstance(want, Exception), want
    _assert_same_data(got, want)


def test_load_dataset_refusals_match_jax(tmp_path):
    for name in ("leaf_mnist", "fake_nothing", "nothing"):
        got, want = _both(name, str(tmp_path))
        assert type(got) is type(want) is ValueError
        assert str(got) == str(want)
